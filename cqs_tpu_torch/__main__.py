"""``python -m cqs_tpu_torch`` entry point."""

import sys

from cqs_tpu_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
