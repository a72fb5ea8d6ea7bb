"""Normal-mode analysis: mass-weighted, TR/rot-projected modes.

Counterpart of `multioptpy_tpu/analysis/vibrations.py` (`NormalModes`,
`normal_modes`, `count_imaginary`); RRHO thermochemistry and the mode
writers arrive with ROADMAP Queue 1 item 15. Frequencies follow the
quantum-chemistry convention (imaginary modes as negative cm^-1).
`normal_modes` takes one structure ((3N,3N), (N,3)) or a batch
((B,3N,3N), (B,N,3)).
"""

from typing import NamedTuple

import numpy as np
import torch

from multioptpy_tpu_torch.geometry import (masses_from_z,
                                           project_hessian_tr_rot,
                                           tr_rot_projector)
from multioptpy_tpu_torch.ops.eigh64 import eigh_deflated, eigh_fast
from multioptpy_tpu_torch.units import (AMU2KG, BOHR2M, HARTREE2J,
                                        LIGHT_SPEED_M_S)

# sqrt(Hartree / (Bohr^2 amu)) -> angular frequency (1/s)
_OMEGA_SI = np.sqrt(HARTREE2J / (BOHR2M ** 2 * AMU2KG))
# angular frequency -> wavenumber (cm^-1)
_TO_CM1 = 1.0 / (2.0 * np.pi * LIGHT_SPEED_M_S * 100.0)


class NormalModes(NamedTuple):
    frequencies_cm1: torch.Tensor   # (..., 3N), TR/rot ~0, imaginary < 0
    modes: torch.Tensor             # (..., 3N, N, 3) Cartesian modes
    eigenvalues: torch.Tensor       # mass-weighted Hessian eigenvalues


def normal_modes(hessian, coords, z):
    """Mass-weighted, TR/rot-projected normal modes."""
    single = coords.ndim == 2
    if single:
        hessian, coords = hessian[None], coords[None]
    b, n, _ = coords.shape
    masses = masses_from_z(z).to(device=coords.device, dtype=coords.dtype)
    sm = torch.repeat_interleave(torch.sqrt(masses), 3)
    h_mw = hessian / sm[:, None] / sm[None, :]
    if n > 1:
        p = tr_rot_projector(coords, masses)
        h_mw = project_hessian_tr_rot(h_mw, coords, masses)
        w, v = eigh_deflated(h_mw, p)
    else:
        w, v = eigh_fast(h_mw)
    freq = torch.sign(w) * torch.sqrt(w.abs()) * (_OMEGA_SI * _TO_CM1)
    cart_modes = (v / sm[:, None]).mT.reshape(b, 3 * n, n, 3)
    nm = NormalModes(frequencies_cm1=freq, modes=cart_modes, eigenvalues=w)
    return NormalModes(*(x[0] for x in nm)) if single else nm


def count_imaginary(freqs_cm1, thresh=-5.0):
    """Number of true imaginary modes (below -5 cm^-1 to skip TR/rot noise):
    an int for one structure's (3N,), a (B,) tensor for a batch."""
    n = (torch.as_tensor(freqs_cm1) < thresh).sum(-1)
    return int(n) if n.ndim == 0 else n
