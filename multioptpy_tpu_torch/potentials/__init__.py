from multioptpy_tpu_torch.potentials.base import (  # noqa: F401
    BiasEngine,
    BiasPotential,
    available_potentials,
    get_potential,
)
from multioptpy_tpu_torch.potentials import afir  # noqa: F401
from multioptpy_tpu_torch.potentials.afir import AFIRPotential  # noqa: F401
