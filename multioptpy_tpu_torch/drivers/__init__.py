from multioptpy_tpu_torch.drivers.optimize import (  # noqa: F401
    OptimizeConfig,
    OptResult,
    optimize,
    optimize_batch,
)
