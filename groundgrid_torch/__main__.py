"""``python -m groundgrid_torch``: the port's command-line interface."""

import sys

from groundgrid_torch.runtime.cli import main

if __name__ == "__main__":
    sys.exit(main())
