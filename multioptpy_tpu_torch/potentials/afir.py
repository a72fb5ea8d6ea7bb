"""AFIR: artificial force induced reaction potential.

Counterpart of `multioptpy_tpu/potentials/afir.py` (Maeda et al., Chem.
Rec. 16 (2016) 2232): a weighted mean fragment-pair distance is biased with
strength alpha derived from the model collision energy gamma via the Ar-Ar
SC-AFIR calibration (R0 = 3.8164 A, epsilon = 1.0061 kJ/mol).

    omega_ij = ((R_i + R_j) / r_ij)^6
    E = alpha * sum(omega r) / sum(omega)      per member of the batch

params[0] = gamma (kJ/mol).
"""

import numpy as np
import torch

from multioptpy_tpu_torch.periodic import COVALENT_RADII_1
from multioptpy_tpu_torch.potentials.base import (BiasPotential, idx0,
                                                  register_potential)
from multioptpy_tpu_torch.units import ANGSTROM2BOHR, HARTREE2KJMOL

_R0_BOHR = 3.8164 * ANGSTROM2BOHR
_EPS_HARTREE = 1.0061 / HARTREE2KJMOL
_P = 6.0


def afir_alpha(gamma_kjmol):
    """gamma (kJ/mol, a tensor) -> alpha (Hartree/Bohr)."""
    g = gamma_kjmol / HARTREE2KJMOL
    denom = (2.0 ** (-1.0 / 6.0)
             - (1.0 + torch.sqrt(1.0 + g.abs() / _EPS_HARTREE))
             ** (-1.0 / 6.0)) * _R0_BOHR
    return torch.where(gamma_kjmol != 0.0, g / denom, 0.0)


@register_potential
class AFIRPotential(BiasPotential):
    """config: gamma (kJ/mol), fragm_1 / fragm_2 (1-based atom lists),
    element_z (full-molecule atomic numbers array)."""

    name = "afir"

    def __init__(self, gamma, fragm_1, fragm_2, element_z, **kw):
        super().__init__(**kw)
        self.gamma = float(gamma)
        self.i_idx = idx0(fragm_1)
        self.j_idx = idx0(fragm_2)
        z = np.asarray(element_z)
        self.r_i = np.asarray(COVALENT_RADII_1)[z[self.i_idx]]  # Bohr
        self.r_j = np.asarray(COVALENT_RADII_1)[z[self.j_idx]]
        self._i = torch.as_tensor(self.i_idx, dtype=torch.long)
        self._j = torch.as_tensor(self.j_idx, dtype=torch.long)

    def init_params(self):
        return np.array([self.gamma], dtype=np.float64)

    def energy(self, coords, params):
        """(B, N, 3) -> (B,)."""
        alpha = afir_alpha(params[0])
        kind = dict(dtype=coords.dtype, device=coords.device)
        ri = torch.as_tensor(self.r_i, **kind)
        rj = torch.as_tensor(self.r_j, **kind)
        dev = coords.device
        diff = (coords[:, self._i.to(dev)][:, :, None, :]
                - coords[:, self._j.to(dev)][:, None, :, :])
        r = torch.sqrt((diff * diff).sum(-1) + 1e-12)          # (B, M, K)
        omega = ((ri[:, None] + rj[None, :]) / r) ** _P
        return alpha * (omega * r).sum((-2, -1)) / omega.sum((-2, -1))
