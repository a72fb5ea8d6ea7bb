"""UFF Lennard-Jones test potential on batched coordinates.

Counterpart of `multioptpy_tpu/calculators/lj.py`: per-element UFF vdW
parameters, Lorentz-Berthelot combining (arithmetic sigma, geometric
epsilon), the full N^2 pair sum; gradients by autograd and the exact
Hessian by `torch.func` (the base class).
"""

import torch

from multioptpy_tpu_torch.calculators.base import (Calculator,
                                                   register_calculator)
from multioptpy_tpu_torch.periodic import UFF_VDW_EPS, UFF_VDW_R

_SIGMA_FROM_RMIN = 2.0 ** (-1.0 / 6.0)


@register_calculator("lj")
class LennardJones(Calculator):
    on_device = True

    def energy(self, coords, z):
        """(B, N, 3) -> (B,)."""
        dtype, dev = coords.dtype, coords.device
        zi = torch.as_tensor(z, device=dev).long()
        sigma_i = (torch.as_tensor(UFF_VDW_R, dtype=dtype, device=dev)
                   * _SIGMA_FROM_RMIN)[zi]
        eps_i = torch.as_tensor(UFF_VDW_EPS, dtype=dtype, device=dev)[zi]
        n = coords.shape[1]
        diff = coords[:, :, None, :] - coords[:, None, :, :]
        r2 = (diff * diff).sum(-1)
        mask = torch.triu(torch.ones((n, n), dtype=torch.bool, device=dev),
                          diagonal=1)
        r2 = torch.where(mask, r2, 1.0)  # keep gradients finite off the mask
        sigma_ab = 0.5 * (sigma_i[:, None] + sigma_i[None, :])
        eps_ab = torch.sqrt(eps_i[:, None] * eps_i[None, :])
        s2 = sigma_ab * sigma_ab / r2
        s6 = s2 * s2 * s2
        e_pair = 4.0 * eps_ab * (s6 * s6 - s6)
        return torch.where(mask, e_pair, 0.0).sum((-2, -1))
