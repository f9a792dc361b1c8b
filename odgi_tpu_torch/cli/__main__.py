"""`python -m odgi_tpu_torch.cli`: the port's command line on the card."""

import sys

from .main import main

if __name__ == "__main__":
    sys.exit(main())
