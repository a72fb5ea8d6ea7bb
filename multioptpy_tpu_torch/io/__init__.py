from multioptpy_tpu_torch.io.xyz import (  # noqa: F401
    read_xyz,
    read_trajectory,
    write_xyz,
    write_trajectory,
)
