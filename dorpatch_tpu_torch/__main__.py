"""`python -m dorpatch_tpu_torch ...`: the port's command line."""

from dorpatch_tpu_torch.cli import main

if __name__ == "__main__":
    main()
