"""Micro-iterated steric-model bias potentials: the asymmetric
ellipsoidal LJ ("ghost nucleobase" probe) and the spacer implicit-solvent
particle model.

Counterpart of `multioptpy_tpu/potentials/ellipsoid.py`. Both carry
internal degrees of freedom (the ellipsoids' rotation angles, the spacer
particles' positions) that are relaxed inside the energy: a dense angle
grid plus a Newton polish for the angles, a fixed-length loop of damped
descent for the particles. The relaxed values enter the energy detached
(`.detach()`, the reference's `stop_gradient`): by the envelope theorem
dE/dx = dV/dx at the internal minimum, so autograd of this energy is the
bias gradient, and its Hessian is the reference's, which leaves out the
coupling through the internal coordinates by design. The relaxation runs
inside `torch.func` transforms (the engine's vmapped Hessian) with no
data-dependent Python control flow.

GNB van-der-Waals parameters: Takano et al., J. Chem. Theory Comput. (2024),
DOI 10.1021/acs.jctc.4c01435 (SI tables; lanthanides use the La values).
"""

import math

import numpy as np
import torch

from multioptpy_tpu_torch.periodic import UFF_VDW_EPS, UFF_VDW_R
from multioptpy_tpu_torch.potentials.base import (BiasPotential, const, idx0,
                                                  register_potential)
from multioptpy_tpu_torch.units import (ANGSTROM2BOHR, HARTREE2KCALMOL,
                                        HARTREE2KJMOL)

# --- GNB vdW tables (Z-indexed, 0 pad; Z=1..86), Angstrom / kcal/mol -------
_GNB_R_ANG = np.array([
    0.0,
    3.2431, 3.0533,
    3.6711, 5.3659, 3.9219, 4.0516, 3.6456, 3.3001, 3.2433, 3.1416,
    3.2429, 4.8010, 4.7457, 4.7121, 4.3825, 4.3735, 3.9557, 3.8692,
    3.8025, 5.0620, 10.586, 7.7490, 5.6617, 4.4761, 4.1887, 4.4113,
    4.4575, 3.6711, 3.8716, 3.8327, 4.7820, 4.3316, 4.7036, 4.4826,
    4.1816, 4.1261,
    3.8623, 4.5095, 11.9894, 7.1388, 6.4121, 4.7570, 4.8495, 4.8882,
    4.3388, 4.0610, 3.5832, 3.5717, 4.5002, 3.8721, 4.8066, 4.7337,
    4.5014, 4.4360,
    4.2468, 5.0441,
    12.586, 12.586, 12.586, 12.586, 12.586, 12.586, 12.586, 12.586,
    12.586, 12.586, 12.586, 12.586, 12.586, 12.586, 12.586,
    6.7740, 6.3793, 4.4757, 5.2841, 5.0541, 4.3390, 4.2436, 3.8280,
    3.7598, 3.6437, 3.4216, 4.6308, 4.7192, 4.6158, 4.5115,
])
_GNB_EPS_KCAL = np.array([
    0.0,
    0.0226, 0.0257,
    0.0133, 0.0026, 0.0215, 0.0264, 0.1103, 0.1624, 0.0908, 0.0985,
    0.0813, 0.0110, 0.0120, 0.0188, 0.2342, 0.1671, 0.2754, 0.2247,
    0.1573, 0.0307, 0.0034, 0.0046, 0.0110, 0.0298, 0.0791, 0.0883,
    0.0673, 0.1293, 0.0786, 0.0862, 0.0211, 0.0640, 0.1947, 0.2280,
    0.3678, 0.3084,
    0.3220, 0.0756, 0.0045, 0.0838, 0.0117, 0.1245, 0.1101, 0.1233,
    0.1478, 0.1582, 0.3034, 0.2994, 0.0930, 0.2434, 0.3045, 0.3227,
    0.5242, 0.4498,
    0.3778, 0.0854,
    0.0066, 0.0066, 0.0066, 0.0066, 0.0066, 0.0066, 0.0066, 0.0066,
    0.0066, 0.0066, 0.0066, 0.0066, 0.0066, 0.0066, 0.0066,
    0.1267, 0.0999, 0.1562, 0.0906, 0.1498, 0.1992, 0.2303, 0.3535,
    0.4313, 0.6563, 0.7952, 0.4271, 0.4029, 0.6010, 0.5572,
])
GNB_VDW_R = _GNB_R_ANG * ANGSTROM2BOHR          # Bohr
GNB_VDW_EPS = _GNB_EPS_KCAL / HARTREE2KCALMOL   # Hartree



def _align_with_z(v, eps=1e-12):
    """Rotation matrix taking unit vector v onto +z (Rodrigues), smooth and
    branchless including the antiparallel case (a pi rotation about x)."""
    c = v[2]
    zero = torch.zeros_like(c)
    # k = v x z = (v_y, -v_x, 0)
    k0, k1, k2 = v[1], -v[0], zero
    kx = torch.stack([torch.stack([zero, -k2, k1]),
                      torch.stack([k2, zero, -k0]),
                      torch.stack([-k1, k0, zero])])
    ok = 1.0 + c > eps
    denom = torch.where(ok, 1.0 + c, 1.0)
    r_rod = const(np.eye(3), v) + kx + kx @ kx / denom
    r_flip = torch.diag(const(np.array([1.0, -1.0, -1.0]), v))
    return torch.where(ok, r_rod, r_flip)


def _rot_z(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, zero]), torch.stack([s, c, zero]),
                        torch.stack([zero, zero, one])])


def _lj(r_inv, eps):
    return eps * (r_inv ** 12 - 2.0 * r_inv ** 6)


def _set(vec, i, value):
    """vec with entry i replaced by value (no in-place write)."""
    pick = torch.arange(vec.shape[0], device=vec.device) == i
    return torch.where(pick, value, vec)


@register_potential
class AsymmetricEllipsoidalLJ(BiasPotential):
    """Asymmetric ellipsoidal LJ probe anchored on a bond axis (GNB model,
    DOI 10.26434/chemrxiv-2024-6www6).

    Each ellipsoid sits at distance `dist` from `root_atom` along the
    root->lj_atom axis, with six independent semi-axes (+x,-x,+y,-y,+z,-z in
    its own frame) and one free rotation angle about the bond axis, relaxed
    by a 72-point angle grid and 3 Newton steps inside the energy; the
    angles enter detached (envelope theorem).

    config per ellipsoid (lists of equal length):
      atoms:  (root, lj) 1-based pairs
      offtgt: extra 1-based atoms excluded from the interaction
      eps:    well depth (kJ/mol)
      sig:    6 semi-axes (Angstrom)
      dist:   anchor distance (Angstrom)
    plus element_z: full Z array of the system. The direction-dependent
    well depth is normalized per atom, as in the reference.
    """

    name = "asym_ellipsoid"

    def __init__(self, n_grid=72, newton_steps=3, **config):
        super().__init__(**config)
        atoms = config["atoms"]
        self.n_ell = len(atoms)
        self.root = [int(idx0([a[0]])[0]) for a in atoms]
        self.lj = [int(idx0([a[1]])[0]) for a in atoms]
        z = np.asarray(config["element_z"], dtype=int)
        self.n_atoms = len(z)
        self.atom_sig = GNB_VDW_R[z] / 2.0        # (N,), Bohr
        self.atom_eps = GNB_VDW_EPS[z]            # (N,), Hartree
        self.masks = []
        offtgt = config.get("offtgt", [[] for _ in range(self.n_ell)])
        for i in range(self.n_ell):
            m = np.ones(self.n_atoms, dtype=bool)
            m[[self.root[i], self.lj[i]]] = False
            if len(offtgt[i]):
                m[idx0(offtgt[i])] = False
            self.masks.append(m)
        self.n_grid = n_grid
        self.newton_steps = newton_steps

    def init_params(self):
        out = []
        for i in range(self.n_ell):
            out.append([float(self.config["eps"][i])]
                       + [float(s) for s in self.config["sig"][i]]
                       + [float(self.config["dist"][i])])
        return np.asarray(out, dtype=np.float64).reshape(-1)

    def _frames(self, coords, params):
        """Per-ellipsoid (center, R_align) in Bohr."""
        frames = []
        for i in range(self.n_ell):
            dist = params[8 * i + 7] * ANGSTROM2BOHR
            root = coords[self.root[i]]
            axis = coords[self.lj[i]] - root
            axis = axis / (torch.linalg.vector_norm(axis) + 1e-30)
            frames.append((root + axis * dist, _align_with_z(axis)))
        return frames

    @staticmethod
    def _ell_coords(pos, theta, center, r_align):
        """World positions -> ellipsoid frame (rotated by theta about z)."""
        local = (pos - center) @ r_align.T
        return local @ _rot_z(theta).T

    def _energy_theta(self, coords, params, thetas):
        frames = self._frames(coords, params)
        e = (coords * 0.0).sum()
        a_sig = const(self.atom_sig, coords)
        a_eps = const(self.atom_eps, coords)
        half_sig = []
        for i in range(self.n_ell):
            p = params[8 * i: 8 * i + 8]
            eps_ell = p[0] / HARTREE2KJMOL
            sig = p[1:7] * ANGSTROM2BOHR          # xp xm yp ym zp zm
            center, r_align = frames[i]
            local = self._ell_coords(coords, thetas[i], center, r_align)
            x, y, zc = local[:, 0], local[:, 1], local[:, 2]
            # octant-dependent geometric-mean radii
            pref = 2.0 ** (14.0 / 6.0)
            xs = torch.sqrt(pref * torch.where(x > 0, sig[0], sig[1]) * a_sig)
            ys = torch.sqrt(pref * torch.where(y > 0, sig[2], sig[3]) * a_sig)
            zs = torch.sqrt(pref * torch.where(zc > 0, sig[4], sig[5])
                            * a_sig)
            r_ell = torch.sqrt((x / xs) ** 2 + (y / ys) ** 2 + (zc / zs) ** 2
                               + 1e-14)
            eps = torch.sqrt(eps_ell * a_eps + 1e-30)
            e_atoms = _lj(1.0 / r_ell, eps)
            e = e + torch.where(const(self.masks[i], coords), e_atoms,
                                0.0).sum()
            half_sig.append((center, r_align, sig, eps_ell))
        # ellipsoid-ellipsoid repulsion: each center in the other's frame,
        # octant radii scaled by 2^(7/6), geometric mean
        for i in range(self.n_ell):
            ci, ri, sigi, epsi = half_sig[i]
            for j in range(i + 1, self.n_ell):
                cj, rj, sigj, epsj = half_sig[j]
                r_i = self._rell(cj, thetas[i], ci, ri, sigi)
                r_j = self._rell(ci, thetas[j], cj, rj, sigj)
                r_pair = torch.sqrt(r_i * r_j)
                e = e + _lj(1.0 / r_pair, torch.sqrt(epsi * epsj))
        return e

    def _rell(self, cen_other, theta, center, r_align, sig):
        loc = self._ell_coords(cen_other[None], theta, center, r_align)[0]
        pref = 2.0 ** (7.0 / 6.0)
        xs = pref * torch.where(loc[0] > 0, sig[0], sig[1])
        ys = pref * torch.where(loc[1] > 0, sig[2], sig[3])
        zs = pref * torch.where(loc[2] > 0, sig[4], sig[5])
        return torch.sqrt((loc[0] / xs) ** 2 + (loc[1] / ys) ** 2
                          + (loc[2] / zs) ** 2 + 1e-14)

    def relax_angles(self, coords, params):
        """Grid + Newton relaxation of the rotation angles (coordinate
        descent over the grid, then a diagonal Newton polish)."""
        coords, params = coords.detach(), params.detach()
        grid = (torch.arange(self.n_grid, dtype=coords.dtype,
                             device=coords.device)
                * (2.0 * math.pi / self.n_grid))
        thetas = torch.zeros(self.n_ell, dtype=coords.dtype,
                             device=coords.device)
        for _ in range(2 if self.n_ell > 1 else 1):     # coordinate descent
            for i in range(self.n_ell):
                def e_of(ti, thetas=thetas, i=i):
                    return self._energy_theta(coords, params,
                                              _set(thetas, i, ti))
                es = torch.func.vmap(e_of)(grid)
                thetas = _set(thetas, i, grid[torch.argmin(es)])

        def etot(th):
            return self._energy_theta(coords, params, th)

        for _ in range(self.newton_steps):
            g = torch.func.grad(etot)(thetas)
            h = torch.diagonal(torch.func.hessian(etot)(thetas))
            thetas = thetas - g / torch.where(h.abs() > 1e-10, h.abs(), 1.0)
        return thetas.detach()

    def energy_one(self, coords, params):
        thetas = self.relax_angles(coords, params)
        return self._energy_theta(coords, params, thetas)


@register_potential
class SpacerModelPotential(BiasPotential):
    """Implicit spacer-solvent model: `n_particles` LJ pseudo-particles fill
    the cavity around target atoms, relaxed to their own minimum at every
    energy evaluation: a deterministic Fibonacci-sphere start around the
    target centroid, then a fixed-length damped-descent loop; the relaxed
    positions enter detached (envelope theorem). `effective_hessian` is the
    Schur-complement correction of the relaxed particle bath.

    config: target (1-based atoms), n_particles, sigma_ang (particle
    eq. distance), depth_kjmol, cavity_scaling, element_z.
    """

    name = "spacer"

    def __init__(self, n_relax=400, **config):
        super().__init__(**config)
        self.target = idx0(config["target"])
        self.n_particles = int(config["n_particles"])
        z = np.asarray(config["element_z"], dtype=int)
        self.atom_sig = UFF_VDW_R[z]       # Bohr
        self.atom_eps = UFF_VDW_EPS[z]
        self.n_relax = n_relax

    def init_params(self):
        return np.asarray([
            float(self.config.get("sigma_ang", 2.5)),
            float(self.config.get("depth_kjmol", 1.0)),
            float(self.config.get("cavity_scaling", 2.0)),
        ])

    def _joint_energy(self, coords, particles, params):
        """V(x, p): atom-particle LJ + particle-particle LJ + cavity wall."""
        p_sig = params[0] * ANGSTROM2BOHR
        p_eps = params[1] / HARTREE2KJMOL
        scaling = params[2]
        a_sig = const(self.atom_sig, coords)
        a_eps = const(self.atom_eps, coords)
        tgt = const(self.target, coords)

        # atom-particle 12-6 (sigma additive, eps geometric); eps inside
        # the sqrt keeps the gradient finite at zero distance
        diff_ap = coords[:, None, :] - particles[None, :, :]
        d_ap = torch.sqrt((diff_ap ** 2).sum(-1) + 1e-12)
        sig_ap = p_sig + a_sig[:, None]
        eps_ap = torch.sqrt(p_eps * a_eps)[:, None]
        e = _lj(sig_ap / d_ap, eps_ap).sum()

        # particle-particle (sigma 2*p_sig), the diagonal masked at the
        # r_inv level so that 0^12 stays 0
        m = self.n_particles
        diff_pp = particles[:, None, :] - particles[None, :, :]
        d_pp = torch.sqrt((diff_pp ** 2).sum(-1) + 1e-12)
        iu = const(np.triu(np.ones((m, m), dtype=bool), k=1), coords)
        r_inv_pp = torch.where(iu, 2.0 * p_sig / d_pp, 0.0)
        e = e + _lj(r_inv_pp, p_eps).sum()

        # cavity wall: quintic switch on the radial mismatch between each
        # particle and its nearest-radius target atom, from the target
        # centroid
        center = coords[tgt].mean(0)
        r_tgt = torch.sqrt(((coords[tgt] - center) ** 2).sum(-1) + 1e-12)
        r_par = torch.sqrt(((particles - center) ** 2).sum(-1) + 1e-12)
        diff = (r_tgt[:, None] - r_par[None, :]).abs()      # (T, M)
        min_idx = torch.argmin(diff, dim=0)
        min_dist = diff.min(0).values
        wall_sig = scaling * a_sig[tgt][min_idx]
        nd = min_dist / (wall_sig + 1e-30)
        t = torch.clamp((nd - 0.9) / 0.1, 0.0, 1.0)
        smooth = -0.5 * (1.0 - 10.0 * t ** 3 + 15.0 * t ** 4
                         - 6.0 * t ** 5) + 0.5
        e_wall = torch.where(nd >= 1.0, 0.5 * nd, smooth)
        return e + e_wall.sum()

    def _init_particles(self, coords, params):
        """Deterministic Fibonacci-sphere start around the target
        centroid."""
        tgt = const(self.target, coords)
        center = coords[tgt].mean(0)
        r0 = (torch.linalg.vector_norm(coords[tgt] - center, dim=-1).max()
              + params[0] * ANGSTROM2BOHR)
        m = self.n_particles
        k = np.arange(m, dtype=np.float64) + 0.5
        phi = np.arccos(1.0 - 2.0 * k / m)
        lam = np.pi * (1.0 + 5.0 ** 0.5) * k
        sphere = np.stack([np.sin(phi) * np.cos(lam),
                           np.sin(phi) * np.sin(lam), np.cos(phi)], axis=-1)
        return center[None, :] + r0 * const(sphere, coords)

    def relax_particles(self, coords, params):
        p = self._init_particles(coords, params)
        grad_p = torch.func.grad(self._joint_energy, argnums=1)
        v = torch.zeros_like(p)
        dt = torch.full((), 0.05, dtype=coords.dtype, device=coords.device)
        for _ in range(self.n_relax):
            g = torch.clamp(grad_p(coords, p, params), -1.0, 1.0)
            power = (-g * v).sum()
            v = torch.where(power > 0, 0.9 * v - dt * g, -dt * g)
            dt = torch.where(power > 0, torch.clamp(dt * 1.05, max=0.5),
                             dt * 0.5)
            p = p + dt * v
        return p

    def energy_one(self, coords, params):
        p_star = self.relax_particles(coords.detach(),
                                      params.detach()).detach()
        return self._joint_energy(coords, p_star, params)

    def effective_hessian(self, coords, params=None):
        """Schur-complement correction -H_xp H_pp^-1 H_px (3N, 3N) of the
        relaxed particle bath around one structure (N, 3); add it to the
        bias Hessian for exact-Hessian steps."""
        from multioptpy_tpu_torch.ops.eigh64 import solve_f64safe

        if params is None:
            params = torch.as_tensor(self.init_params(), dtype=coords.dtype,
                                     device=coords.device)
        p_star = self.relax_particles(coords, params)
        n, m = coords.shape[0], self.n_particles

        def joint_flat(xp):
            return self._joint_energy(xp[:3 * n].reshape(n, 3),
                                      xp[3 * n:].reshape(m, 3), params)

        xp = torch.cat([coords.reshape(-1), p_star.reshape(-1)])
        h = torch.func.hessian(joint_flat)(xp)
        h_xp = h[:3 * n, 3 * n:]
        h_pp = h[3 * n:, 3 * n:] + 1e-10 * torch.eye(3 * m, dtype=h.dtype,
                                                     device=h.device)
        return -h_xp @ solve_f64safe(h_pp, h_xp.T, assume_sym=True)
