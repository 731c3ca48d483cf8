"""Device-resident retrieval indexes (dense exact-scan, sparse terms + sketch,
graph ANN and the tiered graph + delta index)."""

from cqs_tpu_torch.index.stamp import Stamp, StampMismatch  # noqa: F401
from cqs_tpu_torch.index.dense import DenseIndex  # noqa: F401
from cqs_tpu_torch.index.sparse import SpladeIndex  # noqa: F401
from cqs_tpu_torch.index.graph import GraphIndex  # noqa: F401
from cqs_tpu_torch.index.tiered import TieredIndex  # noqa: F401
