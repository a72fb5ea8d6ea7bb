# as in the reference package, the attribute `relaxed_scan` is the function
# (it shadows the submodule; `cli.run_relaxedscan` relies on it)
from multioptpy_tpu_torch.workflows.relaxed_scan import relaxed_scan  # noqa: F401
