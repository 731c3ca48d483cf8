"""Build and bind the CUDA kernels in ``cqs_tpu_torch/csrc``.

The sources compile with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface, loaded with ``ctypes``. The build happens at first use, in
the process that launches a kernel (never at import: machines without
``nvcc`` import this module too), into ``cqs_tpu_torch/_build/<source hash>/``
(listed in ``.gitignore``). A failed build raises; nothing falls back to the
plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("scan_topk.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: seconds the last build in this process took (0.0 when loaded from cache)
build_seconds: float | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.is_file():
            return str(p)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.blake2b(digest_size=12)
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def library_path() -> Path:
    return BUILD_DIR / _source_hash() / "libcqs_kernels.so"


def _build(out: Path) -> None:
    import time

    global build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build beside the target, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *[str(CSRC / s) for s in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernel library, built on first use. Raises when it cannot be
    built or loaded."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if path.is_file():
            build_seconds = 0.0
        else:
            _build(path)
        lib = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.cqs_scan_topk_loop_bf16, lib.cqs_scan_topk_grouped_bf16):
            fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
            fn.restype = ci
        lib.cqs_scan_smem_bytes.argtypes = [ci, ci, ci]
        lib.cqs_scan_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
        return lib
