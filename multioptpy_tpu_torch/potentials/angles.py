"""Angle / dihedral / out-of-plane restraint potentials.

Counterpart of `multioptpy_tpu/potentials/angles.py`: the same atan2
formulations. Angles in configs are degrees (reference CLI convention).
"""

import numpy as np
import torch

from multioptpy_tpu_torch.potentials.base import (BiasPotential, _angle,
                                                  _dihedral,
                                                  _fragment_center, idx0,
                                                  register_potential)
from multioptpy_tpu_torch.units import DEG2RAD


@register_potential
class KeepAnglePotential(BiasPotential):
    """0.5 k (theta - theta0)^2 over atoms (i, j, k), vertex j.
    params = [k, theta0_deg]."""

    name = "keep_angle"

    def __init__(self, spring_const, angle, atoms, **kw):
        super().__init__(**kw)
        self.k = float(spring_const)
        self.theta0_deg = float(angle)
        self.atoms = [int(a) for a in idx0(atoms)]

    def init_params(self):
        return np.array([self.k, self.theta0_deg], dtype=np.float64)

    def energy_one(self, coords, params):
        k, th0 = params[0], params[1] * DEG2RAD
        a = self.atoms
        th = _angle(coords[a[0]], coords[a[1]], coords[a[2]])
        return 0.5 * k * (th - th0) ** 2


@register_potential
class KeepAnglePotentialV2(BiasPotential):
    """Angle between three fragment centroids. params = [k, theta0_deg]."""

    name = "keep_angle_v2"

    def __init__(self, spring_const, angle, fragm_1, fragm_2, fragm_3, **kw):
        super().__init__(**kw)
        self.k = float(spring_const)
        self.theta0_deg = float(angle)
        self.frags = [idx0(fragm_1), idx0(fragm_2), idx0(fragm_3)]

    def init_params(self):
        return np.array([self.k, self.theta0_deg], dtype=np.float64)

    def energy_one(self, coords, params):
        k, th0 = params[0], params[1] * DEG2RAD
        c1, c2, c3 = [_fragment_center(coords, f) for f in self.frags]
        th = _angle(c1, c2, c3)
        return 0.5 * k * (th - th0) ** 2


def _wrap_angle(x):
    """Wrap to (-pi, pi] so dihedral differences take the short way around."""
    return torch.atan2(torch.sin(x), torch.cos(x))


@register_potential
class KeepDihedralPotential(BiasPotential):
    """0.5 k (phi - phi0)^2 over atoms (i,j,k,l), periodic-wrapped.
    params = [k, phi0_deg]."""

    name = "keep_dihedral"

    def __init__(self, spring_const, angle, atoms, **kw):
        super().__init__(**kw)
        self.k = float(spring_const)
        self.phi0_deg = float(angle)
        self.atoms = [int(a) for a in idx0(atoms)]

    def init_params(self):
        return np.array([self.k, self.phi0_deg], dtype=np.float64)

    def energy_one(self, coords, params):
        k, p0 = params[0], params[1] * DEG2RAD
        a = self.atoms
        phi = _dihedral(coords[a[0]], coords[a[1]], coords[a[2]],
                        coords[a[3]])
        return 0.5 * k * _wrap_angle(phi - p0) ** 2


@register_potential
class KeepDihedralPotentialV2(BiasPotential):
    """Dihedral over four fragment centroids. params = [k, phi0_deg]."""

    name = "keep_dihedral_v2"

    def __init__(self, spring_const, angle, fragm_1, fragm_2, fragm_3,
                 fragm_4, **kw):
        super().__init__(**kw)
        self.k = float(spring_const)
        self.phi0_deg = float(angle)
        self.frags = [idx0(fragm_1), idx0(fragm_2), idx0(fragm_3),
                      idx0(fragm_4)]

    def init_params(self):
        return np.array([self.k, self.phi0_deg], dtype=np.float64)

    def energy_one(self, coords, params):
        k, p0 = params[0], params[1] * DEG2RAD
        c = [_fragment_center(coords, f) for f in self.frags]
        phi = _dihedral(*c)
        return 0.5 * k * _wrap_angle(phi - p0) ** 2


@register_potential
class KeepDihedralPotentialCos(BiasPotential):
    """Cosine dihedral 0.5 V (1 - cos(n phi - phi0)) over fragment
    centroids. params = [V, phi0_deg]; n static. phi is the negative of the
    IUPAC dihedral, as in the reference (its cos variant's sign)."""

    name = "keep_dihedral_cos"

    def __init__(self, potential_const, angle, multiplicity, fragm_1, fragm_2,
                 fragm_3, fragm_4, **kw):
        super().__init__(**kw)
        self.v = float(potential_const)
        self.phi0_deg = float(angle)
        self.n = float(multiplicity)
        self.frags = [idx0(fragm_1), idx0(fragm_2), idx0(fragm_3),
                      idx0(fragm_4)]

    def init_params(self):
        return np.array([self.v, self.phi0_deg], dtype=np.float64)

    def energy_one(self, coords, params):
        v, p0 = params[0], params[1] * DEG2RAD
        c = [_fragment_center(coords, f) for f in self.frags]
        phi = -_dihedral(*c)
        return 0.5 * v * (1.0 - torch.cos(self.n * phi - p0))


def _out_of_plane(p_i, p_j, p_k, p_l):
    """Angle of the bond j->i out of the plane (j, k, l)."""
    v = p_i - p_j
    n = torch.linalg.cross(p_k - p_j, p_l - p_j, dim=-1)
    nn = torch.sqrt((n * n).sum() + 1e-12)
    vn = torch.sqrt((v * v).sum() + 1e-12)
    sin_chi = torch.clamp((v * n).sum() / (vn * nn), -1.0, 1.0)
    return torch.asin(sin_chi)


@register_potential
class KeepOutOfPlanePotential(BiasPotential):
    """Harmonic restraint on the angle of bond (j->i) out of plane (j,k,l):
    0.5 k (chi - chi0)^2. atoms = (i, j, k, l) with j the central atom.
    params = [k, chi0_deg]."""

    name = "keep_out_of_plane"

    def __init__(self, spring_const, angle, atoms, **kw):
        super().__init__(**kw)
        self.k = float(spring_const)
        self.chi0_deg = float(angle)
        self.atoms = [int(a) for a in idx0(atoms)]

    def init_params(self):
        return np.array([self.k, self.chi0_deg], dtype=np.float64)

    def energy_one(self, coords, params):
        k, chi0 = params[0], params[1] * DEG2RAD
        chi = _out_of_plane(*(coords[a] for a in self.atoms))
        return 0.5 * k * (chi - chi0) ** 2


@register_potential
class KeepOutOfPlanePotentialV2(BiasPotential):
    """Out-of-plane over fragment centroids. params = [k, chi0_deg]."""

    name = "keep_out_of_plane_v2"

    def __init__(self, spring_const, angle, fragm_1, fragm_2, fragm_3,
                 fragm_4, **kw):
        super().__init__(**kw)
        self.k = float(spring_const)
        self.chi0_deg = float(angle)
        self.frags = [idx0(fragm_1), idx0(fragm_2), idx0(fragm_3),
                      idx0(fragm_4)]

    def init_params(self):
        return np.array([self.k, self.chi0_deg], dtype=np.float64)

    def energy_one(self, coords, params):
        k, chi0 = params[0], params[1] * DEG2RAD
        chi = _out_of_plane(*(_fragment_center(coords, f)
                              for f in self.frags))
        return 0.5 * k * (chi - chi0) ** 2
