"""`python -m multioptpy_tpu_torch <command> ...`: `optmain` and
`run_autots` (see `cli.py`); the device defaults to the CUDA card
(`--device cpu` for the CPU)."""

import sys

from multioptpy_tpu_torch.cli import COMMANDS, main  # noqa: F401

if __name__ == "__main__":
    sys.exit(main())
