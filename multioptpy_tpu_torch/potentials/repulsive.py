"""Lennard-Jones repulsive / attractive fragment-pair bias potentials.

Counterpart of `multioptpy_tpu/potentials/repulsive.py`. UFF vdW
parameters with geometric-mean combination; "scale" multiplies the UFF
well/distance by global factors, "value" replaces them with explicit
values. params = [well_scale_or_value, dist_scale_or_value].
"""

import math

import numpy as np
import torch

from multioptpy_tpu_torch.periodic import UFF_VDW_EPS, UFF_VDW_R
from multioptpy_tpu_torch.potentials.base import (BiasPotential, const, idx0,
                                                  register_potential)
from multioptpy_tpu_torch.units import ANGSTROM2BOHR, HARTREE2KJMOL


def _pair_dist(coords, i_idx, j_idx):
    diff = (coords[const(i_idx, coords)][:, None, :]
            - coords[const(j_idx, coords)][None, :, :])
    return torch.sqrt((diff * diff).sum(-1) + 1e-12)


class _PairwiseLJ(BiasPotential):
    def __init__(self, fragm_1, fragm_2, element_z, **kw):
        super().__init__(**kw)
        self.i_idx = idx0(fragm_1)
        self.j_idx = idx0(fragm_2)
        z = np.asarray(element_z)
        self.eps_i = np.asarray(UFF_VDW_EPS)[z[self.i_idx]]
        self.eps_j = np.asarray(UFF_VDW_EPS)[z[self.j_idx]]
        self.rv_i = np.asarray(UFF_VDW_R)[z[self.i_idx]]
        self.rv_j = np.asarray(UFF_VDW_R)[z[self.j_idx]]

    def _uff_pairs(self, coords, ws, ds):
        eps = torch.sqrt(ws ** 2 * const(self.eps_i[:, None]
                                         * self.eps_j[None, :], coords))
        r0 = torch.sqrt(ds ** 2 * const(self.rv_i[:, None]
                                        * self.rv_j[None, :], coords))
        return eps, r0


@register_potential
class LJRepulsiveScale(_PairwiseLJ):
    """E = sum eps_ij [ (r0/r)^12 - 2 (r0/r)^6 ] with
    eps_ij = sqrt(ws^2 eps_i eps_j), r0 = sqrt(ds^2 Rv_i Rv_j)."""

    name = "lj_repulsive_scale"

    def __init__(self, well_scale, dist_scale, fragm_1, fragm_2, element_z,
                 **kw):
        super().__init__(fragm_1, fragm_2, element_z, **kw)
        self.well_scale = float(well_scale)
        self.dist_scale = float(dist_scale)

    def init_params(self):
        return np.array([self.well_scale, self.dist_scale], dtype=np.float64)

    def energy_one(self, coords, params):
        eps, r0 = self._uff_pairs(coords, params[0], params[1])
        s6 = (r0 / _pair_dist(coords, self.i_idx, self.j_idx)) ** 6
        return (eps * (s6 * s6 - 2.0 * s6)).sum()


@register_potential
class LJRepulsiveValue(_PairwiseLJ):
    """Same form with an explicit well depth (kJ/mol) and distance
    (Angstrom) for every pair. params = [well_value_kjmol,
    dist_value_ang]."""

    name = "lj_repulsive_value"

    def __init__(self, well_value_kjmol, dist_value_ang, fragm_1, fragm_2,
                 element_z, **kw):
        super().__init__(fragm_1, fragm_2, element_z, **kw)
        self.well_value = float(well_value_kjmol)
        self.dist_value = float(dist_value_ang)

    def init_params(self):
        return np.array([self.well_value, self.dist_value], dtype=np.float64)

    def energy_one(self, coords, params):
        eps = params[0] / HARTREE2KJMOL
        r0 = params[1] * ANGSTROM2BOHR
        s6 = (r0 / _pair_dist(coords, self.i_idx, self.j_idx)) ** 6
        return (eps * (s6 * s6 - 2.0 * s6)).sum()


@register_potential
class LJRepulsiveV2(_PairwiseLJ):
    """Custom exponents (a, b): E = sum eps[(r0/r)^a - 2 (r0/r)^b]."""

    name = "lj_repulsive_v2"

    def __init__(self, well_scale, dist_scale, exp_a, exp_b, fragm_1, fragm_2,
                 element_z, **kw):
        super().__init__(fragm_1, fragm_2, element_z, **kw)
        self.well_scale = float(well_scale)
        self.dist_scale = float(dist_scale)
        self.a = float(exp_a)
        self.b = float(exp_b)

    def init_params(self):
        return np.array([self.well_scale, self.dist_scale], dtype=np.float64)

    def energy_one(self, coords, params):
        eps, r0 = self._uff_pairs(coords, params[0], params[1])
        x = r0 / _pair_dist(coords, self.i_idx, self.j_idx)
        return (eps * (x ** self.a - 2.0 * x ** self.b)).sum()


@register_potential
class LJRepulsiveGaussian(BiasPotential):
    """Fragment-pair 12-6 LJ plus an attractive Gaussian well:
        E = sum_pairs eps[(r0/r)^12 - 2(r0/r)^6]
            - D exp(-(r - r_g)^2 / (0.03 r_range^2))
    params = [eps(kJ/mol), r0(ang), D(kJ/mol), r_g(ang), r_range(ang)]."""

    name = "lj_repulsive_gaussian"

    def __init__(self, well_depth, dist, gau_well_depth, gau_dist, gau_range,
                 fragm_1, fragm_2, element_z=None, **kw):
        super().__init__(**kw)
        self.i_idx = idx0(fragm_1)
        self.j_idx = idx0(fragm_2)
        self._p0 = [float(well_depth), float(dist), float(gau_well_depth),
                    float(gau_dist), float(gau_range)]

    def init_params(self):
        return np.asarray(self._p0, dtype=np.float64)

    def energy_one(self, coords, params):
        eps = params[0] / HARTREE2KJMOL
        r0 = params[1] * ANGSTROM2BOHR
        d_g = params[2] / HARTREE2KJMOL
        r_g = params[3] * ANGSTROM2BOHR
        rng = params[4] * ANGSTROM2BOHR
        r = _pair_dist(coords, self.i_idx, self.j_idx)
        s6 = (r0 / r) ** 6
        lj = eps * (s6 * s6 - 2.0 * s6)
        gau = -d_g * torch.exp(-(r - r_g) ** 2 / (0.03 * rng ** 2 + 1e-30))
        return (lj + gau).sum()


@register_potential
class ConePotential(BiasPotential):
    """Tolman-cone steric wall: a cone of half-angle theta/2 with its apex
    2.28 Angstrom behind `center` along the inverted mean direction of
    `three_atoms`; each target atom feels a shifted 12-6 LJ of its signed
    distance to the cone surface (negative inside the cone, which drives
    the wall). params = [well(kJ/mol), dist(ang), cone_angle(deg)];
    center/three_atoms/target are 1-based."""

    name = "cone"

    def __init__(self, well_value, dist_value, cone_angle, center,
                 three_atoms, target, element_z, a_value=1.0, **kw):
        super().__init__(**kw)
        self.center = int(idx0([center])[0])
        self.three = idx0(three_atoms)
        self.target = idx0(target)
        z = np.asarray(element_z)
        self.t_eps = np.asarray(UFF_VDW_EPS)[z[self.target]]
        self.t_rv = np.asarray(UFF_VDW_R)[z[self.target]]
        self.a_value = float(a_value)
        self._p0 = [float(well_value), float(dist_value), float(cone_angle)]

    def init_params(self):
        return np.asarray(self._p0, dtype=np.float64)

    def energy_one(self, coords, params):
        well = params[0] / HARTREE2KJMOL
        dist = params[1] * ANGSTROM2BOHR
        half = 0.5 * torch.deg2rad(params[2])
        c = coords[self.center]
        back = coords[const(self.three, coords)].sum(0) - 3.0 * c
        back = back / (torch.linalg.vector_norm(back) + 1e-30)
        apex = c - (2.28 * ANGSTROM2BOHR) * back
        ca = c - apex
        ca_n = torch.linalg.vector_norm(ca) + 1e-30
        sa = coords[const(self.target, coords)] - apex[None, :]
        sa_n = torch.sqrt((sa * sa).sum(-1) + 1e-12)
        cosang = torch.clamp((sa @ ca) / (sa_n * ca_n), -1.0, 1.0)
        sub = torch.arccos(cosang)
        length = torch.where(sub - half <= math.pi / 2,
                             sa_n * torch.sin(sub - half), sa_n)
        eps = torch.sqrt(well * const(self.t_eps, coords))
        r0 = torch.sqrt(dist * const(self.t_rv, coords))
        s = r0 / (length + self.a_value * r0)
        return (4.0 * eps * (s ** 12 - s ** 6)).sum()


@register_potential
class LJRepulsiveV2Probe(BiasPotential):
    """The -rpv2 model: a probe point `length` Angstrom beyond atom
    center[1] along the center[0]->center[1] axis feels a generalized LJ
    against each target atom,

        E = sum_t eps_t ( |A| (r0_t/r_t)^n_rep - |B| (r0_t/r_t)^n_attr )

    mode "scale": eps_t = sqrt(well * eps_c1 * eps_t),
                  r0_t = sqrt(dist * rv_c1 * rv_t)   (UFF center params)
    mode "value": eps_t = sqrt((well kJ/mol) * eps_t),
                  r0_t = sqrt((dist ang -> Bohr) * rv_t)
    params = [well, dist]."""

    name = "lj_repulsive_v2_probe"

    def __init__(self, well, dist, length_ang, const_rep, const_attr,
                 order_rep, order_attr, center, target, element_z,
                 mode="scale", **kw):
        super().__init__(**kw)
        self.well = float(well)
        self.dist = float(dist)
        self.length = float(length_ang) * ANGSTROM2BOHR
        self.a_const = abs(float(const_rep))
        self.b_const = abs(float(const_attr))
        self.n_rep = float(order_rep)
        self.n_attr = float(order_attr)
        self.c0, self.c1 = (int(a) for a in idx0(center)[:2])
        self.target = idx0(target)
        self.mode = mode
        z = np.asarray(element_z)
        self.eps_t = np.asarray(UFF_VDW_EPS)[z[self.target]]
        self.rv_t = np.asarray(UFF_VDW_R)[z[self.target]]
        self.eps_c = float(np.asarray(UFF_VDW_EPS)[z[self.c1]])
        self.rv_c = float(np.asarray(UFF_VDW_R)[z[self.c1]])

    def init_params(self):
        return np.array([self.well, self.dist], dtype=np.float64)

    def energy_one(self, coords, params):
        well, dist = params[0], params[1]
        axis = coords[self.c1] - coords[self.c0]
        axis = axis / (torch.sqrt((axis ** 2).sum()) + 1e-15)
        probe = coords[self.c1] + self.length * axis
        vec = coords[const(self.target, coords)] - probe[None, :]
        r = torch.sqrt((vec * vec).sum(-1) + 1e-12)
        eps_t = const(self.eps_t, coords)
        rv_t = const(self.rv_t, coords)
        if self.mode == "scale":
            eps = torch.sqrt(well * self.eps_c * eps_t)
            r0 = torch.sqrt(dist * self.rv_c * rv_t)
        else:   # value: kJ/mol + Angstrom against target UFF params
            eps = torch.sqrt(well / HARTREE2KJMOL * eps_t)
            r0 = torch.sqrt(dist * ANGSTROM2BOHR * rv_t)
        x = r0 / r
        return (eps * (self.a_const * x ** self.n_rep
                       - self.b_const * x ** self.n_attr)).sum()
