"""Device-resident retrieval indexes (dense exact-scan, sparse terms + sketch)."""

from cqs_tpu.index.stamp import Stamp, StampMismatch  # noqa: F401
from cqs_tpu_torch.index.dense import DenseIndex  # noqa: F401
from cqs_tpu_torch.index.sparse import SpladeIndex  # noqa: F401
