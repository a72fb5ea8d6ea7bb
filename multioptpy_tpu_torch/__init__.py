"""multioptpy_tpu_torch — the PyTorch/CUDA port of multioptpy_tpu.

Each module `multioptpy_tpu_torch/<sub>/<mod>.py` is the counterpart of
`multioptpy_tpu/<sub>/<mod>.py` with the same public names, torch tensors in
place of jax arrays, and an explicit leading batch axis wherever the JAX
drivers `vmap` (calculator energies, gradients and Hessians, the RS-RFO step,
Hessian updates, the optimizer step). The one hand-written kernel, the
batched Jacobi eigensolver, lives in `csrc/jacobi_eigh.cu` and is built with
`nvcc` at first use (`ops/jacobi_cuda.py`).

Entry points take `device=None`, which means the CUDA card; they raise when
no card is present unless the caller asks for `device="cpu"`.
"""

__version__ = "0.1.0"

from multioptpy_tpu_torch import units  # noqa: F401
from multioptpy_tpu_torch import periodic  # noqa: F401
from multioptpy_tpu_torch.device import resolve_device  # noqa: F401
