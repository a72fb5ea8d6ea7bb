from multioptpy_tpu_torch.analysis.vibrations import (  # noqa: F401
    normal_modes,
    rrho_thermochemistry,
    rotational_constants,
)
