"""Native (C++) host runtime: ctypes loader with build-on-demand.

The port's copy of the fastscan half of ``cqs_tpu/native/__init__.py``.
``fastscan.cpp`` (beside this file, a copy of the repository's
``native/fastscan.cpp``) implements the ingest hot loops (hash tokenization,
source masking). The library builds lazily with the system g++ the first time
it's needed, into ``cqs_tpu_torch/_build/native/`` (listed in
``.gitignore``); the tokenizer falls back to pure Python, and equivalence
is pinned by tests. Only the hash tokenizer is bound: the source masker and
the reference's hostscan library (CPU serving scans) have no caller in the
port.

Kill switch: ``CQST_DISABLE_NATIVE=1``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "fastscan.cpp"
_LIB_DIR = Path(__file__).resolve().parent.parent / "_build" / "native"
_LIB = _LIB_DIR / "libfastscan.so"
_STAMP = _LIB_DIR / "libfastscan.srchash"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _src_hash() -> str:
    import hashlib

    try:
        return hashlib.blake2b(_SRC.read_bytes(), digest_size=16).hexdigest()
    except OSError:
        return ""


def _build() -> bool:
    if not _SRC.is_file():
        return False
    try:
        _LIB_DIR.mkdir(parents=True, exist_ok=True)
        # build beside the target, then rename: a process building at the
        # same time never loads a half-written library
        tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        _STAMP.write_text(_src_hash())
        return True
    except (subprocess.SubprocessError, OSError):
        return False


def _lib_current() -> bool:
    """The cached .so is valid only if it was built from the CURRENT source
    (a stale binary would make the bit-identical-to-Python pin validate the
    wrong code)."""
    if not _LIB.is_file():
        return False
    try:
        return _STAMP.read_text().strip() == _src_hash()
    except OSError:
        return False


def get_lib() -> ctypes.CDLL | None:
    global _lib, _tried
    if os.environ.get("CQST_DISABLE_NATIVE") in ("1", "true"):
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _lib_current() and not _build():
            return None
        try:
            lib = ctypes.CDLL(str(_LIB))
            lib.tokenize_hash.restype = ctypes.c_int32
            lib.tokenize_hash.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def tokenize_hash(text: str, vocab_size: int, max_tokens: int = 4096) -> np.ndarray | None:
    """Native hash tokenization -> int32 token ids, or None (use fallback)."""
    lib = get_lib()
    if lib is None:
        return None
    data = text.encode("utf-8", errors="replace")
    out = np.zeros(max_tokens, dtype=np.int32)
    n = lib.tokenize_hash(data, len(data), vocab_size,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                          max_tokens)
    return out[:n]
