"""`python -m dorpatch_tpu_torch.analysis` entry point."""

import sys

from dorpatch_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
