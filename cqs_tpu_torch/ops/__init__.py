"""Device ops: fusion, scan top-k (CUDA kernels + plain twins), sketches."""

from cqs_tpu_torch.ops.fusion import (  # noqa: F401
    NEG, fuse_alpha, minmax_normalize, rrf, scores_to_ranks, stable_topk,
)
from cqs_tpu_torch.ops.topk import (  # noqa: F401
    GROUPED, IMPLS, KERNELS, LOOP, scan_topk, scan_topk_plain_grouped, scan_topk_plain_loop,
    topk_plain,
)
