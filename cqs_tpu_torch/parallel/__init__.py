"""Mesh sharding, sharded retrieval, and training."""

from cqs_tpu_torch.parallel.mesh import Mesh, ShardedDenseIndex, make_2d_mesh, make_mesh  # noqa: F401
from cqs_tpu_torch.parallel.sharded_hybrid import ShardedHybridIndex  # noqa: F401
from cqs_tpu_torch.parallel.train import ContrastiveTrainer, DistillTrainer, TrainConfig  # noqa: F401
