"""Build and bind the CUDA kernels in ``cqs_tpu_torch/csrc``.

Each source compiles with its own ``nvcc`` for ``sm_90a`` (all started
together), and the objects link into one shared library with a plain C
interface, loaded with ``ctypes``. The build happens at first use, in
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
SOURCES = ("scan_topk.cu", "scan_topk_mma.cu")
HEADERS = ("scan_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

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
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def library_path() -> Path:
    return BUILD_DIR / _source_hash() / "libcqs_kernels.so"


def _run(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the output of the first
    that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")


def _build(out: Path) -> None:
    import time

    global build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build beside the target, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        nvcc = _nvcc()
        objs = [str(Path(tmp) / f"{Path(s).stem}.o") for s in SOURCES]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)]
              for s, o in zip(SOURCES, objs)])
        lib = str(Path(tmp) / out.name)
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
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
        for kind in ("bf16", "i8", "i8w"):
            for body in ("loop", "grouped"):
                fn = getattr(lib, f"cqs_scan_topk_{body}_{kind}")
                fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
                fn.restype = ci
        lib.cqs_scan_smem_bytes.argtypes = [ci, ci, ci, ci]
        lib.cqs_scan_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
        return lib
