"""``python -m simpletuner_tpu_torch.server [--device cuda|cpu]`` — training API + WebUI."""

import sys

from .app import main

if __name__ == "__main__":
    sys.exit(main())
