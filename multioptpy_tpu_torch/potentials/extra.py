"""Remaining bias potentials: universal, flux, nanoreactor, IDPP/CFB-ENM.

Counterpart of `multioptpy_tpu/potentials/extra.py`.
"""

import numpy as np
import torch

from multioptpy_tpu_torch.periodic import COVALENT_RADII_1, MASS_AMU
from multioptpy_tpu_torch.potentials.base import (BiasPotential, const, idx0,
                                                  register_potential)
from multioptpy_tpu_torch.units import ANGSTROM2BOHR, HARTREE2KJMOL


@register_potential
class UniversalPotential(BiasPotential):
    """Linear contraction toward the centroid of a target atom set:
    E = (c / Eh2kJ / nPairs) * sum_i |x_i - centroid|.
    params = [const_kjmol]."""

    name = "universal"

    def __init__(self, const, atoms, **kw):
        super().__init__(**kw)
        self.const = float(const)
        self.idx = idx0(atoms)
        m = len(self.idx)
        self.n_pairs = max(m * (m - 1) // 2, 1)

    def init_params(self):
        return np.array([self.const], dtype=np.float64)

    def energy_one(self, coords, params):
        pts = coords[const(self.idx, coords)]
        centroid = pts.mean(0)
        dist = torch.sqrt(((pts - centroid) ** 2).sum(-1) + 1e-12)
        return params[0] / HARTREE2KJMOL / self.n_pairs * dist.sum()


@register_potential
class FluxPotential(BiasPotential):
    """Polynomial drift toward a target point, E = sum_i sum_k c_k
    (x_ik - d_k)^p_k, with per-axis constants and orders and no 1/p
    factor (the reference's code, not its help string). Scalars broadcast.
    Direction in Angstrom; params = [cx, cy, cz]."""

    name = "flux"

    def __init__(self, const, order, direction, atoms, **kw):
        super().__init__(**kw)
        self.const = np.broadcast_to(np.asarray(const, np.float64),
                                     (3,)).copy()
        self.order = np.broadcast_to(np.asarray(order, np.float64),
                                     (3,)).copy()
        self.direction = np.asarray(direction, np.float64) * ANGSTROM2BOHR
        self.idx = idx0(atoms)

    def init_params(self):
        return np.asarray(self.const, dtype=np.float64)

    def energy_one(self, coords, params):
        diff = (coords[const(self.idx, coords)]
                - const(self.direction, coords)[None, :])
        return (params[None, :] * diff ** const(self.order, coords)).sum()


@register_potential
class NanoReactorPotential(BiasPotential):
    """Time-dependent oscillating spherical piston (virtual nanoreactor):
    a contraction phase (harmonic wall at the inner radius) alternates with
    an expansion phase (wall at the outer radius), mass-weighted. Time
    (a.u.) enters through params[0]."""

    name = "nanoreactor"

    def __init__(self, inner_wall_ang, outer_wall_ang, contraction_time,
                 expansion_time, contraction_k, expansion_k, element_z, **kw):
        super().__init__(**kw)
        self.r_in = float(inner_wall_ang) * ANGSTROM2BOHR
        self.r_out = float(outer_wall_ang) * ANGSTROM2BOHR
        self.t_c = float(contraction_time)
        self.t_e = float(expansion_time)
        self.k_c = float(contraction_k)
        self.k_e = float(expansion_k)
        self.masses = np.asarray(MASS_AMU)[np.asarray(element_z)]

    def init_params(self):
        return np.array([0.0], dtype=np.float64)  # params[0] = time (a.u.)

    def energy_one(self, coords, params):
        t = params[0]
        m = const(self.masses, coords)
        r = torch.sqrt((coords ** 2).sum(-1) + 1e-12)
        period = self.t_c + self.t_e
        phase = t / period - torch.floor(t / period)
        contracting = phase < (self.t_c / period)
        u_c = torch.where(r > self.r_in,
                          0.5 * m * self.k_c * (r - self.r_in) ** 2, 0.0)
        u_e = torch.where(r > self.r_out,
                          0.5 * m * self.k_e * (r - self.r_out) ** 2, 0.0)
        return torch.where(contracting, u_c, u_e).sum()


@register_potential
class IDPPBias(BiasPotential):
    """Image-dependent pair potential as a standalone bias: keeps a
    geometry near a target distance matrix with w = d^-4 weights.
    params = [strength]."""

    name = "idpp_bias"

    def __init__(self, target_coords, strength=1.0, **kw):
        super().__init__(**kw)
        tc = np.asarray(target_coords, np.float64)
        self.d_target = np.linalg.norm(tc[:, None] - tc[None, :], axis=-1)
        self.strength = float(strength)

    def init_params(self):
        return np.array([self.strength], dtype=np.float64)

    def energy_one(self, coords, params):
        n = coords.shape[0]
        mask = const(np.triu(np.ones((n, n), dtype=bool), k=1), coords)
        diff = coords[:, None, :] - coords[None, :, :]
        d = torch.sqrt((diff * diff).sum(-1) + 1e-12)
        w = torch.where(mask, 1.0 / d ** 4, 0.0)
        tgt = const(self.d_target, coords)
        return 0.5 * params[0] * torch.where(mask, w * (d - tgt) ** 2,
                                             0.0).sum()


@register_potential
class CFBElasticNetwork(BiasPotential):
    """Correlated flat-bottom elastic network: a harmonic penalty only
    outside a tolerance band around reference pair distances, restricted
    to the bonded network. params = [k]."""

    name = "cfb_enm"

    def __init__(self, reference_coords, element_z, k=0.1, tolerance=0.2,
                 scale=1.3, **kw):
        super().__init__(**kw)
        rc = np.asarray(reference_coords, np.float64)
        z = np.asarray(element_z)
        d = np.linalg.norm(rc[:, None] - rc[None, :], axis=-1)
        radii = np.asarray(COVALENT_RADII_1)[z]
        bonded = (d < scale * (radii[:, None] + radii[None, :]))
        np.fill_diagonal(bonded, False)
        self.pairs = np.argwhere(np.triu(bonded, 1))
        self.d_ref = d[self.pairs[:, 0], self.pairs[:, 1]]
        self.k = float(k)
        self.tol = float(tolerance)

    def init_params(self):
        return np.array([self.k], dtype=np.float64)

    def energy_one(self, coords, params):
        if len(self.pairs) == 0:
            return (coords * 0.0).sum()
        a = coords[const(self.pairs[:, 0], coords)]
        b = coords[const(self.pairs[:, 1], coords)]
        d = torch.sqrt(((a - b) ** 2).sum(-1) + 1e-12)
        dev = (d - const(self.d_ref, coords)).abs()
        over = torch.clamp(dev - self.tol, min=0.0)
        return 0.5 * params[0] * (over ** 2).sum()
