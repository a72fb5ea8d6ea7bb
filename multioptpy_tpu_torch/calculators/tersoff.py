"""Tersoff bond-order potential (Si/C/Ge) on batched coordinates.

Counterpart of `multioptpy_tpu/calculators/tersoff.py`: the parameters of
Tersoff, PRB 39 (1989) 5566, with the three-body bond-order term as a
dense (B, N, N, N) tensor (fine at molecular N); gradients by autograd,
the exact Hessian by `torch.func` (the base class). Energy in Hartree,
coordinates in Bohr.
"""

import math

import numpy as np
import torch

from multioptpy_tpu_torch.calculators.base import (Calculator,
                                                   register_calculator)
from multioptpy_tpu_torch.potentials.base import const
from multioptpy_tpu_torch.units import BOHR2ANGSTROM, HARTREE2EV

# Z -> (A[eV], B[eV], lambda1[1/A], lambda2[1/A], lambda3[1/A],
#        beta, n, c, d, h, R[A], D[A])  (Tersoff PRB 39, 5566 (1989))
_TERSOFF = {
    6:  (1393.6, 346.74, 3.4879, 2.2119, 0.0, 1.5724e-7, 0.72751,
         38049.0, 4.3484, -0.57058, 1.95, 0.15),
    14: (1830.8, 471.18, 2.4799, 1.7322, 0.0, 1.1e-6, 0.78734,
         100390.0, 16.217, -0.59825, 2.85, 0.15),
    32: (1769.0, 419.23, 2.4451, 1.7047, 0.0, 9.0166e-7, 0.75627,
         106430.0, 15.652, -0.43884, 2.95, 0.15),
}


def _param_arrays():
    out = np.zeros((87, 12), dtype=np.float64)
    for z, p in _TERSOFF.items():
        out[z] = p
    return out


_PARAMS = _param_arrays()


def _fc(rr, rc, dc):
    """Smooth cutoff: 1 inside rc - dc, 0 outside rc + dc."""
    x = (rr - rc) / dc.clamp(min=1e-12)
    mid = 0.5 - 0.5 * torch.sin(0.5 * math.pi * x)
    return torch.where(rr < (rc - dc), 1.0,
                       torch.where(rr > (rc + dc), 0.0, mid))


@register_calculator("tersoff")
class Tersoff(Calculator):
    on_device = True

    def energy(self, coords, z):
        """(B, N, 3) -> (B,)."""
        par = const(_PARAMS[np.asarray(z)], coords)           # (N, 12)
        (a, b, lam1, lam2, lam3, beta, nn, c, d, h, rr,
         dd) = par.unbind(-1)
        n = coords.shape[1]
        pos = coords * BOHR2ANGSTROM  # parameters are in Angstrom/eV
        diff = pos[:, :, None, :] - pos[:, None, :, :]   # r_i - r_j
        eye = torch.eye(n, dtype=torch.bool, device=coords.device)
        offdiag = ~eye
        r2 = (diff * diff).sum(-1)
        r = torch.sqrt(torch.where(offdiag, r2, 1.0))

        # mixed parameters (geometric means for unlike pairs)
        a_ij = torch.sqrt(a[:, None] * a[None, :])
        b_ij = torch.sqrt(b[:, None] * b[None, :])
        lam1_ij = 0.5 * (lam1[:, None] + lam1[None, :])
        lam2_ij = 0.5 * (lam2[:, None] + lam2[None, :])
        r_ij = torch.sqrt(rr[:, None] * rr[None, :])
        d_ij = torch.sqrt(dd[:, None] * dd[None, :])
        fc_ij = torch.where(offdiag, _fc(r, r_ij, d_ij), 0.0)

        # cos(theta_jik) between the bonds i->j and i->k
        dot = torch.einsum("bijx,bikx->bijk", -diff, -diff)
        cos_t = dot / (r[:, :, :, None] * r[:, :, None, :])
        c3, d3, h3 = c[:, None, None], d[:, None, None], h[:, None, None]
        g = 1.0 + (c3 / d3) ** 2 - c3 ** 2 / (d3 ** 2 + (h3 - cos_t) ** 2)

        # zeta_ij = sum_{k != i,j} fc(r_ik) g(theta_ijk)
        #           exp(lam3^3 (r_ij - r_ik)^3)
        lam3_i = lam3[:, None, None]
        expo = torch.exp(lam3_i ** 3 * (r[:, :, :, None]
                                        - r[:, :, None, :]) ** 3)
        mask3 = offdiag[:, :, None] & offdiag[:, None, :] & offdiag[None]
        zeta = torch.where(mask3, fc_ij[:, :, None, :] * g * expo,
                           0.0).sum(-1)

        beta_i = beta[:, None]
        # elements without parameters have n = 0 and zero pair terms;
        # guard the exponent against 1/0
        n_i = torch.where(nn[:, None] > 1e-6, nn[:, None], 1.0)
        bz = (beta_i * zeta).clamp(min=1e-30)
        b_bond = (1.0 + bz ** n_i) ** (-0.5 / n_i)

        f_r = a_ij * torch.exp(-lam1_ij * r)
        f_a = -b_ij * torch.exp(-lam2_ij * r)
        e_pair = fc_ij * (f_r + b_bond * f_a)
        return 0.5 * torch.where(offdiag, e_pair, 0.0).sum((-2, -1)) \
            / HARTREE2EV
