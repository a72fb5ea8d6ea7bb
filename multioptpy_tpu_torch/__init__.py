"""multioptpy_tpu_torch — the PyTorch/CUDA port of multioptpy_tpu.

Each module `multioptpy_tpu_torch/<sub>/<mod>.py` is the counterpart of
`multioptpy_tpu/<sub>/<mod>.py` with the same public names, torch tensors in
place of jax arrays, and an explicit leading batch axis wherever the JAX
drivers `vmap` (calculator energies, gradients and Hessians, the RS-RFO step,
Hessian updates, the optimizer step). The hand-written kernels, the
batched Jacobi eigensolver (`csrc/jacobi_eigh.cu`, `ops/jacobi_cuda.py`) and
the batched tridiagonal eigensolver (`csrc/tridiag_eigh.cu`,
`ops/tridiag_cuda.py`), are built with `nvcc` at first use
(`ops/cuda_build.py`); `ops/eigh64.py` chooses which runs each solve.

Entry points take `device=None`, which means the CUDA card; they raise when
no card is present unless the caller asks for `device="cpu"`.
"""

__version__ = "0.1.0"

from multioptpy_tpu_torch import units  # noqa: F401
from multioptpy_tpu_torch import periodic  # noqa: F401
from multioptpy_tpu_torch.device import resolve_device  # noqa: F401
