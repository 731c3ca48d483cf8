"""Training-data generation and fine-tuning entry points."""

from cqs_tpu_torch.train.data import TrainPair, generate_pairs_from_store, mine_git_history  # noqa: F401
