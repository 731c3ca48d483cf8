"""cqs-tpu on PyTorch and CUDA: the lexical-tier hybrid search for NVIDIA Hopper.

A port of ``cqs_tpu`` (the JAX package, which stays the reference) to
PyTorch, with the two Pallas scan kernels of the search path rewritten as
CUDA C++ kernels for ``sm_90a`` (``csrc/scan_topk.cu`` on CUDA cores,
``csrc/scan_topk_mma.cu`` on tensor cores). Submodules mirror
``cqs_tpu``'s names so each ported file has a twin:

    cli/ daemon/        -- ``python -m cqs_tpu_torch index|<query>``, micro-batcher
    search/             -- engine (solo path), device program (program.py)
    index/  models/     -- dense/sparse device indexes | hash embedder, splade-hash
    ops/    csrc/       -- fusion, scan top-k wrappers + plain twins | CUDA sources
    pipeline.py         -- index pipeline (parse -> NL -> embed -> store -> sparse)

Host code with no device work (config, store, parser, nl, router, scoring,
lexical legs, tokenizer, and the tokenizer's C++ in ``native/``) is the
port's own copy of the reference's, at the same relative paths with only
``cqs_tpu.`` imports renamed (``tests/test_torch_standalone.py`` pins each
copy to its original); nothing here imports ``cqs_tpu``. The on-disk format
(store schema, parser and tokenizer versions, index artifacts) is the
reference's, so either package opens the other's index. Every device-facing
entry point takes an explicit ``device``; nothing falls back to the CPU
silently.
"""

__version__ = "0.1.0"
