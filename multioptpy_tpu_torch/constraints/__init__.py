from multioptpy_tpu_torch.constraints.project import Constraints  # noqa: F401
