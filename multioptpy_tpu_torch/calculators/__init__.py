from multioptpy_tpu_torch.calculators.base import Calculator, get_calculator  # noqa: F401
from multioptpy_tpu_torch.calculators.sqm import SQM, SQM2  # noqa: F401
