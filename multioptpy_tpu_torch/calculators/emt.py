"""Effective-medium-theory potential for fcc metals on batched
coordinates.

Counterpart of `multioptpy_tpu/calculators/emt.py`: ASE's EMT (Jacobsen,
Stoltze, Norskov, Surf. Sci. 366 (1996) 394) with its parameters for the
seven fcc metals and the toy H/C/N/O set, as a dense (B, N, N) pairwise
form; gradients by autograd, the exact Hessian by `torch.func` (the base
class).
"""

import math

import numpy as np
import torch

from multioptpy_tpu_torch.calculators.base import (Calculator,
                                                   register_calculator)
from multioptpy_tpu_torch.potentials.base import const
from multioptpy_tpu_torch.units import (ANGSTROM2BOHR, BOHR2ANGSTROM,
                                        HARTREE2EV)

# Z -> (E0 [eV], s0 [bohr], V0 [eV], eta2 [1/bohr], kappa [1/bohr],
#        lambda [1/bohr], n0 [1/bohr^3])   (ASE EMT defaults)
_EMT_PARAMS = {
    13: (-3.28, 3.00, 1.493, 1.240, 2.000, 1.169, 0.00700),  # Al
    29: (-3.51, 2.67, 2.476, 1.652, 2.740, 1.906, 0.00910),  # Cu
    47: (-2.96, 3.01, 2.132, 1.652, 2.790, 1.892, 0.00547),  # Ag
    79: (-3.80, 3.00, 2.321, 1.674, 2.873, 2.182, 0.00703),  # Au
    28: (-4.44, 2.60, 3.673, 1.669, 2.757, 1.948, 0.01030),  # Ni
    46: (-3.90, 2.87, 2.773, 1.818, 3.107, 2.155, 0.00688),  # Pd
    78: (-5.85, 2.90, 4.067, 1.812, 3.145, 2.192, 0.00802),  # Pt
    # toy parameters (ASE: "not real EMT")
    1: (-3.21, 1.31, 0.132, 2.652, 2.790, 3.892, 0.00547),   # H
    6: (-3.50, 1.81, 0.332, 1.652, 2.790, 1.892, 0.01322),   # C
    7: (-5.10, 1.88, 0.132, 1.652, 2.790, 1.892, 0.01222),   # N
    8: (-4.60, 1.95, 0.332, 1.652, 2.790, 1.892, 0.00850),   # O
}

_BETA = 1.809  # (16 pi/3)^(1/3) / sqrt(2)

# ASE's default cutoff comes from the largest s0 of the whole table (Ag's
# 3.01 bohr), a constant, not a property of the atoms present
_S0_MAX_BOHR = max(p[1] for p in _EMT_PARAMS.values())


def _param_arrays(dtype=np.float64):
    out = np.zeros((87, 7), dtype=dtype)
    for z, p in _EMT_PARAMS.items():
        out[z] = p
    return out


_PARAMS = _param_arrays()


@register_calculator("emt")
class EMT(Calculator):
    """EMT energy in Hartree of (B, N, 3) Bohr coordinates, for the
    elements of `_EMT_PARAMS`."""

    on_device = True

    def energy(self, coords, z):
        dtype = coords.dtype
        par = const(_PARAMS[np.asarray(z)], coords)          # (N, 7)
        e0, s0, v0, eta2, kappa, lam, n0 = par.unbind(-1)
        n = coords.shape[1]
        # the parameters are per bohr; work in Angstrom and eV
        pos = coords * BOHR2ANGSTROM
        s0_a = s0 * BOHR2ANGSTROM
        eta2_a = eta2 * ANGSTROM2BOHR
        kappa_a = kappa * ANGSTROM2BOHR
        lam_a = lam * ANGSTROM2BOHR

        # cutoff midway between the 3rd and 4th fcc shells of the table's
        # largest s0, smoothing width such that theta(r4nn) = 1e-4
        r1nn = _BETA * _S0_MAX_BOHR * BOHR2ANGSTROM
        rc = r1nn * 0.5 * (math.sqrt(3.0) + 2.0)
        r4nn = r1nn * 2.0
        acut = math.log(9999.0) / (r4nn - rc)

        diff = pos[:, :, None, :] - pos[:, None, :, :]
        r2 = (diff * diff).sum(-1)
        offdiag = ~torch.eye(n, dtype=torch.bool, device=coords.device)
        r = torch.sqrt(torch.where(offdiag, r2, 1.0))
        w = torch.sigmoid(-acut * (r - rc))
        w = torch.where(offdiag, w, 0.0)

        # gamma normalization over 3 fcc shells (12/6/24 atoms, relative
        # to the first shell's count)
        shell_d = torch.stack([_BETA * s0_a, _BETA * s0_a * math.sqrt(2.0),
                               _BETA * s0_a * math.sqrt(3.0)])  # (3, N)
        shell_n = torch.tensor([12.0, 6.0, 24.0], dtype=dtype,
                               device=coords.device)[:, None] / 12.0
        tw = torch.sigmoid(-acut * (shell_d - rc))
        gamma1 = (shell_n * tw * torch.exp(
            -eta2_a[None, :] * (shell_d - _BETA * s0_a[None, :]))).sum(0)
        gamma2 = (shell_n * tw * torch.exp(
            -kappa_a[None, :] / _BETA
            * (shell_d - _BETA * s0_a[None, :]))).sum(0)

        # pair densities from j at i, chi_ij = n0_j / n0_i for unlike
        # species
        sig1_terms = w * torch.exp(-eta2_a[None, :]
                                   * (r - _BETA * s0_a[None, :]))
        sig2_terms = w * torch.exp(-kappa_a[None, :] / _BETA
                                   * (r - _BETA * s0_a[None, :]))
        chi = n0[None, :] / n0[:, None]
        sigma1 = torch.where(offdiag, sig1_terms * chi, 0.0).sum(-1)
        sigma2 = torch.where(offdiag, sig2_terms * chi, 0.0).sum(-1)

        sigma1 = sigma1.clamp(min=1e-9)
        ds = -torch.log(sigma1 / gamma1 / 12.0) / (_BETA * eta2_a)
        lam_ds = lam_a * ds
        e_c = e0 * (1.0 + lam_ds) * torch.exp(-lam_ds) - e0  # 0 at ds=0
        e_as = 6.0 * v0 * torch.exp(-kappa_a * ds) - 0.5 * v0 * sigma2 \
            / gamma2
        return (e_c + e_as).sum(-1) / HARTREE2EV
