"""Training on one device (``parallel/train.py``). The reference's mesh
sharding (``parallel/mesh.py``, ``sharded_hybrid.py``) is not ported yet."""

from cqs_tpu_torch.parallel.train import ContrastiveTrainer, DistillTrainer, TrainConfig  # noqa: F401
