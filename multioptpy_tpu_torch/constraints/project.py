"""Geometry constraints on batches: gradient/Hessian projection and SHAKE.

Counterpart of `multioptpy_tpu/constraints/project.py`. A constraint set is
a static list of primitives with target values; its Jacobian B (K, 3N) per
structure comes from `torch.func.jacfwd` of the stacked constraint values
(the reference's `jax.jacfwd`), so

    project gradient:  g' = g - B^T (B B^T)^-1 B g
    project Hessian:   H' = P H P,  P = I - B^T (B B^T)^-1 B
    SHAKE:             30 Gauss-Newton iterations x <- x + B^T (B B^T)^-1 dc

Cartesian freezes (x/y/z of chosen atoms, whole atoms) are a mask applied
to gradients and steps. Coordinates are batched, (B, N, 3).
"""

import numpy as np
import torch

from multioptpy_tpu_torch.potentials.base import _angle, _dihedral
from multioptpy_tpu_torch.units import ANGSTROM2BOHR, DEG2RAD


def _sym_solve(a, b):
    """(B B^T + 1e-12 I)^-1 b for the small constraint systems; no error
    check (and no device sync): a singular system gives non-finite values,
    as the reference's solve does."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return torch.linalg.solve_ex(a + 1e-12 * eye, b)[0]


class Constraints:
    """Static constraint specification (1-based atoms, as on the CLI).

    bonds: (i, j, target_ang or None); angles: (i, j, k, target_deg or
    None); dihedrals: (i, j, k, l, target_deg or None) -- None freezes the
    starting value. fixed_atoms: atoms frozen in x, y and z; fixed_coords:
    (atom, 'x'|'y'|'z') pairs; fbonds: (fragment1, fragment2, target_ang or
    None) centroid distances; projection_vectors: fixed directions (3N,)
    projected out; atoms_pairs: (i, j) pairs whose mutual approach
    direction, rebuilt from the current geometry, is projected out;
    eigvec_modes: Hessian mode indices resolved by `resolve_eigvecs`."""

    def __init__(self, bonds=(), angles=(), dihedrals=(), fixed_atoms=(),
                 fixed_coords=(), fbonds=(), projection_vectors=(),
                 atoms_pairs=(), eigvec_modes=(), n_atoms=None):
        self.bond_idx = np.asarray([[b[0] - 1, b[1] - 1] for b in bonds],
                                   np.int64).reshape(-1, 2)
        self.bond_targets = [b[2] for b in bonds]
        self.angle_idx = np.asarray(
            [[a[0] - 1, a[1] - 1, a[2] - 1] for a in angles],
            np.int64).reshape(-1, 3)
        self.angle_targets = [a[3] for a in angles]
        self.dihedral_idx = np.asarray(
            [[d[0] - 1, d[1] - 1, d[2] - 1, d[3] - 1] for d in dihedrals],
            np.int64).reshape(-1, 4)
        self.dihedral_targets = [d[4] for d in dihedrals]
        self.fixed_atoms = np.asarray([a - 1 for a in fixed_atoms], np.int64)
        ax_map = {"x": 0, "y": 1, "z": 2}
        self.fixed_coords = [(a - 1, ax_map[ax]) for a, ax in fixed_coords]
        self.fbond_idx = [(np.asarray(f[0], np.int64) - 1,
                           np.asarray(f[1], np.int64) - 1) for f in fbonds]
        self.fbond_targets = [f[2] for f in fbonds]
        self.projection_vectors = [np.asarray(v, np.float64).reshape(-1)
                                   for v in projection_vectors]
        self.atoms_pairs = [(p[0] - 1, p[1] - 1) for p in atoms_pairs]
        self.eigvec_modes = [int(m) for m in eigvec_modes]
        self.n_atoms = n_atoms

    def resolve_eigvecs(self, hessian):
        """Resolve pending `eigvec_modes` against one (3N, 3N) Hessian: mode
        k = the k-th smallest eigenvalue with |eig| > 1e-10; appends the
        eigenvectors to `projection_vectors` and clears the pending list."""
        if not self.eigvec_modes:
            return self
        h = (hessian.detach().cpu().numpy() if isinstance(hessian, torch.Tensor)
             else np.asarray(hessian))
        w, v = np.linalg.eigh(h)
        valid = np.where(np.abs(w) > 1e-10)[0]
        order = valid[np.argsort(w[valid])]
        for m in self.eigvec_modes:
            self.projection_vectors.append(
                np.asarray(v[:, order[m]], np.float64).reshape(-1))
        self.eigvec_modes = []
        return self

    @property
    def n_constraints(self):
        return (len(self.bond_idx) + len(self.angle_idx)
                + len(self.dihedral_idx) + len(self.fbond_idx))

    def has_any(self):
        return (self.n_constraints > 0 or len(self.fixed_atoms) > 0
                or len(self.fixed_coords) > 0
                or len(self.projection_vectors) > 0
                or len(self.atoms_pairs) > 0)

    # --- values ------------------------------------------------------------

    def values(self, coords):
        """(B, N, 3) -> (B, K) constraint values (Bohr / radians)."""
        parts = []
        for i, j in self.bond_idx:
            d = coords[:, i] - coords[:, j]
            parts.append(torch.sqrt((d * d).sum(-1) + 1e-14))
        for i, j, k in self.angle_idx:
            parts.append(_angle(coords[:, i], coords[:, j], coords[:, k]))
        for i, j, k, l in self.dihedral_idx:
            parts.append(_dihedral(coords[:, i], coords[:, j], coords[:, k],
                                   coords[:, l]))
        for f1, f2 in self.fbond_idx:
            d = (coords[:, torch.as_tensor(f1)].mean(-2)
                 - coords[:, torch.as_tensor(f2)].mean(-2))
            parts.append(torch.sqrt((d * d).sum(-1) + 1e-14))
        if not parts:
            return coords.new_zeros((coords.shape[0], 0))
        return torch.stack(parts, dim=-1)

    def targets(self, coords0):
        """(B, K) target values; None targets take coords0's values. Units
        in: Angstrom for bonds, degrees for angles and dihedrals."""
        current = self.values(coords0)
        scales = ([ANGSTROM2BOHR] * len(self.bond_targets)
                  + [DEG2RAD] * (len(self.angle_targets)
                                 + len(self.dihedral_targets))
                  + [ANGSTROM2BOHR] * len(self.fbond_targets))
        given = (self.bond_targets + self.angle_targets
                 + self.dihedral_targets + self.fbond_targets)
        cols = [current[:, k] if t is None
                else torch.full_like(current[:, k], float(t) * s)
                for k, (t, s) in enumerate(zip(given, scales))]
        if not cols:
            return current
        return torch.stack(cols, dim=-1)

    # --- Jacobian & projections -------------------------------------------

    def jacobian(self, coords):
        """(B, N, 3) -> (B, K, 3N)."""
        b, n, _ = coords.shape

        def one(x_flat):
            return self.values(x_flat.reshape(1, n, 3))[0]

        return torch.func.vmap(torch.func.jacfwd(one))(coords.reshape(b, -1))

    def _projector_apply(self, vec_flat, coords):
        """v - B^T (B B^T)^-1 B v, then the fixed projection vectors and the
        atom-pair directions projected out. vec_flat (B, 3N)."""
        if self.n_constraints:
            b = self.jacobian(coords)
            lam = _sym_solve(b @ b.mT, (b @ vec_flat[..., None])[..., 0])
            vec_flat = vec_flat - (b.mT @ lam[..., None])[..., 0]
        for v in self.projection_vectors:
            u = torch.as_tensor(v, dtype=vec_flat.dtype,
                                device=vec_flat.device)
            u = u / (torch.linalg.vector_norm(u) + 1e-30)
            vec_flat = vec_flat - (vec_flat @ u)[:, None] * u
        for i, j in self.atoms_pairs:
            d = coords[:, j] - coords[:, i]
            u = torch.zeros_like(coords)
            u[:, i] = d
            u[:, j] = -d
            u = u.reshape(u.shape[0], -1)
            u = u / (torch.linalg.vector_norm(u, dim=-1, keepdim=True)
                     + 1e-30)
            vec_flat = vec_flat - (u * vec_flat).sum(-1, keepdim=True) * u
        return vec_flat

    def mask(self, dtype=torch.float64, device=None):
        """(N, 3) multiplicative freeze mask (1 = free)."""
        m = np.ones((self.n_atoms, 3))
        for a in self.fixed_atoms:
            m[a, :] = 0.0
        for a, ax in self.fixed_coords:
            m[a, ax] = 0.0
        return torch.as_tensor(m, dtype=dtype, device=device)

    def project_gradient(self, gradient, coords):
        """Remove constraint-violating directions and apply the freezes;
        gradient (B, N, 3)."""
        g = self._projector_apply(gradient.reshape(gradient.shape[0], -1),
                                  coords)
        return g.reshape(gradient.shape) * self.mask(gradient.dtype,
                                                     gradient.device)

    def project_hessian(self, hessian, coords):
        """P H P with the same projector; frozen DOFs get unit diagonal.
        hessian (B, 3N, 3N)."""
        if self.n_constraints:
            b = self.jacobian(coords)
            binv = _sym_solve(b @ b.mT, b)
            eye = torch.eye(b.shape[-1], dtype=hessian.dtype,
                            device=hessian.device)
            p = eye - b.mT @ binv
            hessian = p.mT @ hessian @ p
        m = self.mask(hessian.dtype, hessian.device).reshape(-1)
        hessian = hessian * m[:, None] * m[None, :] + torch.diag(1.0 - m)
        return 0.5 * (hessian + hessian.mT)

    # --- SHAKE -------------------------------------------------------------

    def shake(self, coords, targets, n_iter=30):
        """Restore c(x) = targets (B, K) by `n_iter` Gauss-Newton iterations;
        frozen DOFs do not move. Mismatches of every constraint after the
        angles (the dihedrals, and the fragment distances after them, as in
        the reference) are wrapped mod 2 pi."""
        if self.n_constraints == 0:
            return coords
        nb, na = len(self.bond_idx), len(self.angle_idx)
        is_dihedral = torch.arange(self.n_constraints,
                                   device=coords.device) >= nb + na
        mask_flat = self.mask(coords.dtype, coords.device).reshape(-1)
        x = coords
        for _ in range(n_iter):
            dc = targets - self.values(x)
            dc = torch.where(is_dihedral, torch.atan2(torch.sin(dc),
                                                      torch.cos(dc)), dc)
            b = self.jacobian(x) * mask_flat
            lam = _sym_solve(b @ b.mT, dc)
            x = x + (b.mT @ lam[..., None])[..., 0].reshape(x.shape)
        return x
