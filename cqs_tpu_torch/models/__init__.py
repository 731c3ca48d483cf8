"""Models: the hash dense embedder and the splade-hash sparse encoder."""

from cqs_tpu.models.registry import ModelPreset, get_preset  # noqa: F401
from cqs_tpu_torch.models.embedder import Embedder  # noqa: F401
from cqs_tpu_torch.models.splade import SpladeEncoder  # noqa: F401
