"""``python -m simpletuner_tpu_torch.cli``."""

import sys

from . import main

if __name__ == "__main__":
    sys.exit(main())
