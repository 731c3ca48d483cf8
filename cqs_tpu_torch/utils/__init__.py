"""Foundation utilities: hashing, identifier tokenization, file walks, tracing."""

from cqs_tpu_torch.utils.hashing import content_hash, canonical_hash, fingerprint_file  # noqa: F401
from cqs_tpu_torch.utils.text import tokenize_identifier, normalize_for_fts  # noqa: F401
from cqs_tpu_torch.utils.walk import enumerate_files  # noqa: F401
from cqs_tpu_torch.utils.trace import span, get_tracer  # noqa: F401
