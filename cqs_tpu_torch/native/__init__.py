"""Native (C++) host runtime: ctypes loader with build-on-demand.

The port's copy of ``cqs_tpu/native/__init__.py``. Two libraries, each
built lazily with the system g++ the first time it is needed, into
``cqs_tpu_torch/_build/native/`` (listed in ``.gitignore``), and rebuilt
when its source's hash changes:

- ``fastscan.cpp`` (a copy of the repository's ``native/fastscan.cpp``):
  the hash tokenizer, which falls back to pure Python;
- ``hostscan.cpp`` (a copy of ``native/hostscan.cpp``, built with
  ``-march=native``: its loops are memory-bound SIMD; its stamp holds the
  host CPU's feature flags beside the source hash, so a checkout moved to
  another machine rebuilds it instead of loading code for another CPU): the
  CPU serving mirror's masked bf16 and int8 scans and its CSR posting walk
  (``search/program.py::hybrid_query_host``), each returning None when the
  library is missing so the caller takes its numpy fallback.

Each build writes beside its target and renames it into place, so a process
building at the same time never loads a half-written library. Equivalence
with the fallbacks is pinned by tests. The source masker has no caller in
the port and is not bound.

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


def _file_hash(path: Path) -> str:
    import hashlib

    try:
        return hashlib.blake2b(path.read_bytes(), digest_size=16).hexdigest()
    except OSError:
        return ""


def _src_hash() -> str:
    return _file_hash(_SRC)


def _build_into(src: Path, lib: Path, stamp: Path, flags: list[str],
                key: str | None = None) -> bool:
    """g++ ``src`` into ``lib`` through a temporary file and a rename, then
    record ``key`` (default: the source's hash) in ``stamp``."""
    if not src.is_file():
        return False
    try:
        lib.parent.mkdir(parents=True, exist_ok=True)
        # build beside the target, then rename: a process building at the
        # same time never loads a half-written library
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *flags, "-shared", "-fPIC", "-o", str(tmp), str(src)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        stamp.write_text(key or _file_hash(src))
        return True
    except (subprocess.SubprocessError, OSError):
        return False


def _build() -> bool:
    return _build_into(_SRC, _LIB, _STAMP, ["-O3"])


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


# -- hostscan: CPU serving kernels (bf16 scan matvec + CSR walk) -------------

_HSRC = Path(__file__).resolve().parent / "hostscan.cpp"
_HLIB = _LIB_DIR / "libhostscan.so"
_HSTAMP = _LIB_DIR / "libhostscan.srchash"

_hlock = threading.Lock()
_hlib: ctypes.CDLL | None = None
_htried = False


def _hkey() -> str:
    """The hostscan stamp: the source's hash and a hash of this host's CPU
    feature flags (``-march=native`` code runs only where they match)."""
    import hashlib
    import platform

    try:
        flags = next((ln for ln in Path("/proc/cpuinfo").read_text().splitlines()
                      if ln.startswith(("flags", "Features"))), "")
    except OSError:
        flags = ""
    host = hashlib.blake2b(f"{platform.machine()}|{flags}".encode(),
                           digest_size=8).hexdigest()
    return f"{_file_hash(_HSRC)}-{host}"


def _hbuild() -> bool:
    return _build_into(_HSRC, _HLIB, _HSTAMP, ["-O3", "-march=native"], _hkey())


def get_hostscan() -> ctypes.CDLL | None:
    global _hlib, _htried
    if os.environ.get("CQST_DISABLE_NATIVE") in ("1", "true"):
        return None
    with _hlock:
        if _hlib is not None or _htried:
            return _hlib
        _htried = True
        current = False
        if _HLIB.is_file():
            try:
                current = _HSTAMP.read_text().strip() == _hkey()
            except OSError:
                current = False
        if not current and not _hbuild():
            return None
        try:
            lib = ctypes.CDLL(str(_HLIB))
            lib.bf16_matmul_masked.restype = None
            lib.bf16_matmul_masked.argtypes = [
                ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_float,
                ctypes.POINTER(ctypes.c_float)]
            lib.i8_matmul_masked.restype = None
            lib.i8_matmul_masked.argtypes = [
                ctypes.POINTER(ctypes.c_int8), ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int8), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_float,
                ctypes.POINTER(ctypes.c_float)]
            lib.csr_accumulate.restype = ctypes.c_int64
            lib.csr_accumulate.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
            _hlib = lib
        except OSError:
            _hlib = None
        return _hlib


def bf16_matmul_masked(mat_u16: np.ndarray, q: np.ndarray,
                       valid_u8: np.ndarray, neg: float) -> np.ndarray | None:
    """[n, d] bf16-as-uint16 x [B, d] f32 -> [B, n] f32 masked scores, or
    None (caller uses the numpy/BLAS fallback). One matrix pass serves the
    whole query batch."""
    lib = get_hostscan()
    if lib is None:
        return None
    n, d = mat_u16.shape
    if d > 4096:
        return None
    q = np.ascontiguousarray(q, np.float32)
    B = q.shape[0]
    out = np.empty((B, n), np.float32)
    lib.bf16_matmul_masked(
        mat_u16.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), n, d,
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), B,
        valid_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.float32(neg),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def i8_matmul_masked(mat_i8: np.ndarray, q_i8: np.ndarray,
                     valid_u8: np.ndarray, neg: float) -> np.ndarray | None:
    """[n, d] int8 x [B, d] int8 -> [B, n] f32 masked int-dot scores, or
    None (caller uses the numpy fallback). Selection-only: the host twin of
    the device q8 candidate scan (exact int32 accumulation, half the bytes
    of the bf16 scan)."""
    lib = get_hostscan()
    if lib is None:
        return None
    n, d = mat_i8.shape
    q_i8 = np.ascontiguousarray(q_i8, np.int8)
    B = q_i8.shape[0]
    out = np.empty((B, n), np.float32)
    lib.i8_matmul_masked(
        mat_i8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), n, d,
        q_i8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), B,
        valid_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.float32(neg),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def csr_accumulate(indptr: np.ndarray, post_rows: np.ndarray,
                   post_w: np.ndarray, q_ids: np.ndarray, q_w: np.ndarray,
                   n: int) -> np.ndarray | None:
    """Exact sparse scores [n] f32 for one query via the CSR posting walk,
    bit-identical to program.sparse_scores_csr, or None (use fallback)."""
    lib = get_hostscan()
    if lib is None:
        return None
    q_ids = np.ascontiguousarray(q_ids, np.int32)
    q_w = np.ascontiguousarray(q_w, np.float32)
    acc = np.zeros(n, np.float64)
    lib.csr_accumulate(
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        post_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        post_w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        q_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        q_w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(q_ids), acc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
    return acc.astype(np.float32)


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
