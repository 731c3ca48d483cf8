"""cqs-tpu on PyTorch and CUDA: the lexical-tier hybrid search for NVIDIA Hopper.

A port of ``cqs_tpu`` (the JAX package, which stays the reference) to
PyTorch, with the two Pallas scan kernels of the search path rewritten as
CUDA C++ kernels for ``sm_90a`` (``csrc/scan_topk.cu``). Submodules mirror
``cqs_tpu``'s names so each ported file has a twin:

    cli/ daemon/        -- ``python -m cqs_tpu_torch index|<query>``, micro-batcher
    search/             -- engine (solo path), device program (program.py)
    index/  models/     -- dense/sparse device indexes | hash embedder, splade-hash
    ops/    csrc/       -- fusion, scan top-k wrappers + plain twins | CUDA sources
    pipeline.py         -- index pipeline (parse -> NL -> embed -> store -> sparse)

Host code with no device work (config, store, parser, nl, router, scoring,
lexical legs, tokenizer) is shared with ``cqs_tpu`` through ``_shared``, which
must be imported before anything else here. Every device-facing entry point
takes an explicit ``device``; nothing falls back to the CPU silently.
"""

from cqs_tpu_torch import _shared  # noqa: F401  (must run first)

__version__ = "0.1.0"
