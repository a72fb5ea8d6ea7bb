"""Flat-bottom well / wall potentials with quintic switching.

Counterpart of `multioptpy_tpu/potentials/well.py`. The reference's
piecewise well (5 branches at a<b<c<d) is a branchless nest of `where`s;
each region keeps its polynomial:
  r<=a       : linear ramp   -3.75 x + 2.875
  a<r<=b     : quintic switch 2 - 20x^3 + 30x^4 - 12x^5
  b<r<c      : 0 (flat bottom)
  c<=r<d     : quintic switch (long side)
  d<=r       : linear ramp (long side)
Wall energies are kJ/mol in configs; limit distances Angstrom.
"""

import numpy as np
import torch

from multioptpy_tpu_torch.potentials.base import (BiasPotential,
                                                  _fragment_center, const,
                                                  idx0, register_potential)
from multioptpy_tpu_torch.units import ANGSTROM2BOHR, HARTREE2KJMOL


def _well_shape(r, a, b, c, d):
    """Dimensionless piecewise well profile (energy scale 1)."""
    xs = 0.5 / (b - a) * r + (1.0 - 0.5 * b / (b - a))
    xl = 0.5 / (c - d) * r + (1.0 - 0.5 * c / (c - d))
    lin_s = -3.75 * xs + 2.875
    qui_s = 2.0 - 20.0 * xs ** 3 + 30.0 * xs ** 4 - 12.0 * xs ** 5
    qui_l = 2.0 - 20.0 * xl ** 3 + 30.0 * xl ** 4 - 12.0 * xl ** 5
    lin_l = -3.75 * xl + 2.875
    return torch.where(
        r <= a, lin_s,
        torch.where(r <= b, qui_s,
                    torch.where(r < c, 0.0,
                                torch.where(r < d, qui_l, lin_l))))


@register_potential
class WellPotential(BiasPotential):
    """Flat-bottom well on the fragment-centroid distance.
    params = [wall_energy_kjmol]. limits = (a, b, c, d) in Angstrom."""

    name = "well"

    def __init__(self, wall_energy, limits, fragm_1, fragm_2, **kw):
        super().__init__(**kw)
        self.wall_energy = float(wall_energy)
        self.limits = np.asarray(limits, dtype=np.float64) * ANGSTROM2BOHR
        self.f1 = idx0(fragm_1)
        self.f2 = idx0(fragm_2)

    def init_params(self):
        return np.array([self.wall_energy], dtype=np.float64)

    def energy_one(self, coords, params):
        e0 = params[0] / HARTREE2KJMOL
        c1 = _fragment_center(coords, self.f1)
        c2 = _fragment_center(coords, self.f2)
        r = torch.sqrt(((c1 - c2) ** 2).sum() + 1e-12)
        a, b, c, d = (float(v) for v in self.limits)
        return e0 * _well_shape(r, a, b, c, d)


@register_potential
class WellPotentialVP(BiasPotential):
    """Well on the distance of each target atom to a fixed reference point
    (Angstrom)."""

    name = "well_vp"

    def __init__(self, wall_energy, limits, point, atoms, **kw):
        super().__init__(**kw)
        self.wall_energy = float(wall_energy)
        self.limits = np.asarray(limits, dtype=np.float64) * ANGSTROM2BOHR
        self.point = np.asarray(point, dtype=np.float64) * ANGSTROM2BOHR
        self.atoms = idx0(atoms)

    def init_params(self):
        return np.array([self.wall_energy], dtype=np.float64)

    def energy_one(self, coords, params):
        e0 = params[0] / HARTREE2KJMOL
        d = coords[const(self.atoms, coords)] - const(self.point, coords)
        r = torch.sqrt((d * d).sum(-1) + 1e-12)
        a, b, c, dd = (float(v) for v in self.limits)
        return e0 * _well_shape(r, a, b, c, dd).sum()


@register_potential
class WellPotentialWall(BiasPotential):
    """Cartesian box wall: the well profile on one axis of selected atoms.
    limits (a,b,c,d) in Angstrom; `axis` in {'x','y','z'}."""

    name = "well_wall"

    def __init__(self, wall_energy, limits, axis, atoms, **kw):
        super().__init__(**kw)
        self.wall_energy = float(wall_energy)
        self.limits = np.asarray(limits, dtype=np.float64) * ANGSTROM2BOHR
        self.axis = {"x": 0, "y": 1, "z": 2}[axis]
        self.atoms = idx0(atoms)

    def init_params(self):
        return np.array([self.wall_energy], dtype=np.float64)

    def energy_one(self, coords, params):
        e0 = params[0] / HARTREE2KJMOL
        x = coords[const(self.atoms, coords), self.axis]
        a, b, c, d = (float(v) for v in self.limits)
        return e0 * _well_shape(x, a, b, c, d).sum()


@register_potential
class WellPotentialAround(BiasPotential):
    """Well on each target atom's distance to a fragment centroid."""

    name = "well_around"

    def __init__(self, wall_energy, limits, center_fragm, atoms, **kw):
        super().__init__(**kw)
        self.wall_energy = float(wall_energy)
        self.limits = np.asarray(limits, dtype=np.float64) * ANGSTROM2BOHR
        self.center = idx0(center_fragm)
        self.atoms = idx0(atoms)

    def init_params(self):
        return np.array([self.wall_energy], dtype=np.float64)

    def energy_one(self, coords, params):
        e0 = params[0] / HARTREE2KJMOL
        ctr = _fragment_center(coords, self.center)
        d = coords[const(self.atoms, coords)] - ctr[None, :]
        r = torch.sqrt((d * d).sum(-1) + 1e-12)
        a, b, c, dd = (float(v) for v in self.limits)
        return e0 * _well_shape(r, a, b, c, dd).sum()


@register_potential
class VoidPointPotential(BiasPotential):
    """(k/n) (r - r0)^n between atoms and a fixed point. point/r0 in
    Angstrom; order n static. params = [k, r0_ang]."""

    name = "void_point"

    def __init__(self, spring_const, distance, order, point, atom, **kw):
        super().__init__(**kw)
        self.k = float(spring_const)
        self.r0_ang = float(distance)
        self.n = float(order)
        self.point = np.asarray(point, dtype=np.float64) * ANGSTROM2BOHR
        # one 1-based atom or a list of them (-vpp passes a range)
        atoms = [atom] if np.isscalar(atom) else list(atom)
        self.atoms = np.asarray([int(a) - 1 for a in atoms], np.int32)

    def init_params(self):
        return np.array([self.k, self.r0_ang], dtype=np.float64)

    def energy_one(self, coords, params):
        k, r0 = params[0], params[1] * ANGSTROM2BOHR
        d = coords[const(self.atoms, coords)] - const(self.point, coords)
        r = torch.sqrt((d * d).sum(-1) + 1e-12)
        return ((k / self.n) * (r - r0) ** self.n).sum()
