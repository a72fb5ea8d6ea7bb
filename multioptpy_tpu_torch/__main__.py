"""`python -m multioptpy_tpu_torch <command> ...`: `optmain`, `nebmain`,
`ircmain`, `run_autots`, `confsearch`, `relaxedscan`, `orientsearch`,
`run_mapper`, `mdmain` and `ieipmain` (see `cli.py`); the device defaults
to the CUDA card (`--device cpu` for the CPU)."""

import sys

from multioptpy_tpu_torch.cli import COMMANDS, main  # noqa: F401

if __name__ == "__main__":
    sys.exit(main())
