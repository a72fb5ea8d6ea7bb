"""Structure-keeping restraints: harmonic / Morse bonds, fragment distances.

Counterpart of `multioptpy_tpu/potentials/keep.py`. Distances in configs
are Angstrom (reference CLI convention), converted to Bohr inside the
energy; spring constants are a.u.
"""

import numpy as np
import torch

from multioptpy_tpu_torch.potentials.base import (BiasPotential, _dist,
                                                  _fragment_center, idx0,
                                                  register_potential)
from multioptpy_tpu_torch.units import ANGSTROM2BOHR


@register_potential
class KeepPotential(BiasPotential):
    """0.5 k (r - r0)^2 between two atoms. params = [k, r0_ang]."""

    name = "keep"

    def __init__(self, spring_const, distance, atom_pair, **kw):
        super().__init__(**kw)
        self.k = float(spring_const)
        self.r0_ang = float(distance)
        self.pair = [int(a) for a in idx0(atom_pair)]

    def init_params(self):
        return np.array([self.k, self.r0_ang], dtype=np.float64)

    def energy_one(self, coords, params):
        k, r0 = params[0], params[1] * ANGSTROM2BOHR
        r = _dist(coords[self.pair[0]], coords[self.pair[1]])
        return 0.5 * k * (r - r0) ** 2


@register_potential
class KeepPotentialV2(BiasPotential):
    """0.5 k (|c1-c2| - r0)^2 between fragment centroids."""

    name = "keep_v2"

    def __init__(self, spring_const, distance, fragm_1, fragm_2, **kw):
        super().__init__(**kw)
        self.k = float(spring_const)
        self.r0_ang = float(distance)
        self.f1 = idx0(fragm_1)
        self.f2 = idx0(fragm_2)

    def init_params(self):
        return np.array([self.k, self.r0_ang], dtype=np.float64)

    def energy_one(self, coords, params):
        k, r0 = params[0], params[1] * ANGSTROM2BOHR
        c1 = _fragment_center(coords, self.f1)
        c2 = _fragment_center(coords, self.f2)
        r = torch.sqrt(((c1 - c2) ** 2).sum() + 1e-12)
        return 0.5 * k * (r - r0) ** 2


@register_potential
class KeepPotentialAniso(BiasPotential):
    """Anisotropic harmonic restraint: independent x/y/z spring constants on
    the displacement between two atoms. params = [kx, ky, kz, r0x, r0y,
    r0z(ang)]."""

    name = "keep_aniso"

    def __init__(self, spring_consts, distances, atom_pair, **kw):
        super().__init__(**kw)
        self.ks = np.asarray(spring_consts, dtype=np.float64)
        self.r0_ang = np.asarray(distances, dtype=np.float64)
        self.pair = [int(a) for a in idx0(atom_pair)]

    def init_params(self):
        return np.concatenate([self.ks, self.r0_ang])

    def energy_one(self, coords, params):
        ks, r0 = params[:3], params[3:] * ANGSTROM2BOHR
        d = (coords[self.pair[0]] - coords[self.pair[1]]).abs()
        return 0.5 * (ks * (d - r0) ** 2).sum()


@register_potential
class AnharmonicKeepPotential(BiasPotential):
    """Morse restraint D(1 - exp(-sqrt(k/2D)(r-r0)))^2.
    params = [k, D, r0_ang]."""

    name = "keep_anharmonic"

    def __init__(self, spring_const, well_depth, distance, atom_pair, **kw):
        super().__init__(**kw)
        self.k = float(spring_const)
        self.de = float(well_depth)
        self.r0_ang = float(distance)
        self.pair = [int(a) for a in idx0(atom_pair)]

    def init_params(self):
        return np.array([self.k, self.de, self.r0_ang], dtype=np.float64)

    def energy_one(self, coords, params):
        k, de, r0 = params[0], params[1], params[2] * ANGSTROM2BOHR
        r = _dist(coords[self.pair[0]], coords[self.pair[1]])
        ok = de != 0.0
        a = torch.sqrt(torch.where(ok, k / torch.where(ok, 2.0 * de, 1.0),
                                   0.0))
        e = de * (1.0 - torch.exp(-a * (r - r0))) ** 2
        return torch.where(ok, e, 0.0)
