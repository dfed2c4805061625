"""`python -m dorpatch_tpu_torch.aot` — build|verify|ls|gc for the
executable store. Exit codes: 0 clean, 1 findings/refusal, 2 usage."""

import sys

from dorpatch_tpu_torch.aot.build import main

if __name__ == "__main__":
    sys.exit(main())
