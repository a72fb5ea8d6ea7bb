"""Mechanochemical force, electrostatic, value-range and metadynamics
bias potentials.

Counterpart of `multioptpy_tpu/potentials/misc.py`.
"""

import numpy as np
import torch

from multioptpy_tpu_torch.periodic import UFF_EFFECTIVE_CHARGE
from multioptpy_tpu_torch.potentials.base import (BiasPotential, _dist,
                                                  _fragment_center, const,
                                                  idx0, register_potential)
from multioptpy_tpu_torch.units import (ANGSTROM2BOHR, BOHR2ANGSTROM,
                                        HARTREE2KCALMOL, HARTREE2KJMOL)

# 1 pN expressed in Hartree/Bohr
_PN2AU = 1.0e-12 / (4.3597447222071e-18 / 5.29177210903e-11)
_COULOMB_KCAL = 332.0637  # kcal/mol * Angstrom / e^2


@register_potential
class LinearMechanoForce(BiasPotential):
    """Constant external force (pN) along two bond directions.
    params = [force_pN]."""

    name = "mechano_force"

    def __init__(self, force_pn, atoms_1, atoms_2, **kw):
        super().__init__(**kw)
        self.force_pn = float(force_pn)
        self.a1 = [int(a) for a in idx0(atoms_1)]
        self.a2 = [int(a) for a in idx0(atoms_2)]

    def init_params(self):
        return np.array([self.force_pn], dtype=np.float64)

    def energy_one(self, coords, params):
        f = 0.5 * params[0] * _PN2AU
        d1 = coords[self.a1[1]] - coords[self.a1[0]]
        d2 = coords[self.a2[1]] - coords[self.a2[0]]
        u1 = d1 / torch.sqrt((d1 * d1).sum() + 1e-12)
        u2 = d2 / torch.sqrt((d2 * d2).sum() + 1e-12)
        return f * (u1.sum() + u2.sum())


@register_potential
class LinearMechanoForceV2(BiasPotential):
    """Force f pulling two atoms apart: E = -f r_ij. params = [force_pN]."""

    name = "mechano_force_v2"

    def __init__(self, force_pn, atom_pair, **kw):
        super().__init__(**kw)
        self.force_pn = float(force_pn)
        self.pair = [int(a) for a in idx0(atom_pair)]

    def init_params(self):
        return np.array([self.force_pn], dtype=np.float64)

    def energy_one(self, coords, params):
        f = params[0] * _PN2AU
        return -f * _dist(coords[self.pair[0]], coords[self.pair[1]])


class _Electrostatic(BiasPotential):
    """Coulomb with UFF effective charges, kcal/mol convention
    (332.0637 q_i q_j / r_ang)."""

    def _coulomb(self, coords, scale, qi, qj, i_idx, j_idx, pair_mask=None):
        diff = (coords[const(i_idx, coords)][:, None, :]
                - coords[const(j_idx, coords)][None, :, :])
        r_ang = torch.sqrt((diff * diff).sum(-1) + 1e-12) * BOHR2ANGSTROM
        qq = scale * qi[:, None] * qj[None, :]
        e = _COULOMB_KCAL * qq / r_ang / HARTREE2KCALMOL
        if pair_mask is not None:
            e = torch.where(pair_mask, e, 0.0)
        return e.sum()


@register_potential
class ElectrostaticFragment(_Electrostatic):
    """All pairs between two fragments. params = [charge_scale]."""

    name = "electrostatic_fragment"

    def __init__(self, charge_scale, fragm_1, fragm_2, element_z, **kw):
        super().__init__(**kw)
        self.scale = float(charge_scale)
        self.i_idx = idx0(fragm_1)
        self.j_idx = idx0(fragm_2)
        z = np.asarray(element_z)
        self.qi = np.asarray(UFF_EFFECTIVE_CHARGE)[z[self.i_idx]]
        self.qj = np.asarray(UFF_EFFECTIVE_CHARGE)[z[self.j_idx]]

    def init_params(self):
        return np.array([self.scale], dtype=np.float64)

    def energy_one(self, coords, params):
        return self._coulomb(coords, params[0], const(self.qi, coords),
                             const(self.qj, coords), self.i_idx, self.j_idx)


@register_potential
class ElectrostaticAtomPair(_Electrostatic):
    """All unique pairs within one atom set."""

    name = "electrostatic_atom_pair"

    def __init__(self, charge_scale, atoms, element_z, **kw):
        super().__init__(**kw)
        self.scale = float(charge_scale)
        self.idx = idx0(atoms)
        z = np.asarray(element_z)
        self.q = np.asarray(UFF_EFFECTIVE_CHARGE)[z[self.idx]]
        m = len(self.idx)
        self.mask = np.triu(np.ones((m, m), dtype=bool), k=1)

    def init_params(self):
        return np.array([self.scale], dtype=np.float64)

    def energy_one(self, coords, params):
        q = const(self.q, coords)
        return self._coulomb(coords, params[0], q, q, self.idx, self.idx,
                             const(self.mask, coords))


@register_potential
class ValueRangePotential(BiasPotential):
    """Softplus walls keeping a fragment distance inside [lower, upper]:

        E = log[(1 + e^{ku (r - upper)}) (1 + e^{kl (lower - r)})]

    as two softplus terms. params = [k_upper, k_lower]."""

    name = "value_range"

    def __init__(self, upper_const, lower_const, upper_distance,
                 lower_distance, fragm_1, fragm_2, **kw):
        super().__init__(**kw)
        self.ku = float(upper_const)
        self.kl = float(lower_const)
        self.upper = float(upper_distance) * ANGSTROM2BOHR
        self.lower = float(lower_distance) * ANGSTROM2BOHR
        self.f1 = idx0(fragm_1)
        self.f2 = idx0(fragm_2)

    def init_params(self):
        return np.array([self.ku, self.kl], dtype=np.float64)

    def energy_one(self, coords, params):
        ku, kl = params[0], params[1]
        c1 = _fragment_center(coords, self.f1)
        c2 = _fragment_center(coords, self.f2)
        r = torch.sqrt(((c1 - c2) ** 2).sum() + 1e-12)
        return (_softplus(ku * (r - self.upper))
                + _softplus(kl * (self.lower - r)))


def _softplus(x):
    """log(1 + e^x), as jax.nn.softplus computes it (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros_like(x))


@register_potential
class GaussianBiasPotential(BiasPotential):
    """Metadynamics hills on a bond collective variable with a static-shape
    history: `deposit()` fills a fixed (max_hills,) array, and the params
    carry the padded centers and their count.

    E = sum_h height * exp(-(cv - center_h)^2 / (2 width^2))
    """

    name = "gaussian_metadyn"

    def __init__(self, height_kjmol, width_ang, atom_pair, max_hills=512, **kw):
        super().__init__(**kw)
        self.height = float(height_kjmol) / HARTREE2KJMOL
        self.width = float(width_ang) * ANGSTROM2BOHR
        self.pair = [int(a) for a in idx0(atom_pair)]
        self.max_hills = int(max_hills)
        self.centers = np.zeros((self.max_hills,), dtype=np.float64)
        self.n_hills = 0

    def deposit(self, cv_value_bohr):
        if self.n_hills >= self.max_hills:
            raise RuntimeError(f"metadynamics history full ({self.max_hills})")
        self.centers[self.n_hills] = float(cv_value_bohr)
        self.n_hills += 1

    def cv(self, coords):
        return _dist(coords[self.pair[0]], coords[self.pair[1]])

    def energy_one(self, coords, params):
        centers, n = params[:-1], params[-1]
        cv = self.cv(coords)
        mask = torch.arange(self.max_hills, device=coords.device) < n
        hills = self.height * torch.exp(-(cv - centers) ** 2
                                        / (2.0 * self.width ** 2))
        return torch.where(mask, hills, 0.0).sum()

    def init_params(self):
        return np.concatenate([self.centers,
                               np.array([float(self.n_hills)])])
