"""Redundant internal coordinates: primitive values and the autodiff Wilson
B matrix on batched coordinates, and host-side primitive detection.

Counterpart of `multioptpy_tpu/coords/internals.py`: the primitives, `q`,
`b_matrix`, the G matrix and its pseudo-inverse, the gradient and Hessian
transforms, the Gauss-Newton back-transform, the delocalized (DIC) basis,
`detect_primitives`, `linear_bend_axes` and `auto_internals`. The primitive
vector q(x) is one vectorized function of the geometry, so B = dq/dx comes
from `torch.func.jacfwd` per member of the batch, as the reference's
`jax.jacfwd`, and the curvature term from `torch.func.hessian`. The
eigendecompositions are `eigh_fast` (`torch.linalg.eigh`), the reference's
CPU branch. `cartesian_to_z_matrix` and `local_force_constants` take one
structure, as the reference's.

Primitive index arrays are static per molecule (numpy, 0-based).
"""

import itertools

import numpy as np
import torch

from multioptpy_tpu_torch.ops.eigh64 import eigh_fast
from multioptpy_tpu_torch.periodic import COVALENT_RADII_1


def _mv(m, x):
    return (m @ x[..., None])[..., 0]


def _stretch(p, idx):
    a, b = p[:, idx[:, 0]], p[:, idx[:, 1]]
    return torch.sqrt(((a - b) ** 2).sum(-1) + 1e-14)


def _bend(p, idx):
    a, b, c = p[:, idx[:, 0]], p[:, idx[:, 1]], p[:, idx[:, 2]]
    v1, v2 = a - b, c - b
    cross = torch.linalg.cross(v1, v2, dim=-1)
    return torch.atan2(torch.sqrt((cross * cross).sum(-1) + 1e-14),
                       (v1 * v2).sum(-1))


def _linear_bend(p, idx, axes):
    """Orthogonal linear-bend pair for near-linear a-b-c triples: the two
    components of unit(a-b) + unit(c-b) along the frozen axes u, v
    (Ml, 2, 3). Returns (B, 2*Ml) = [u-components..., v-components...]."""
    a, b, c = p[:, idx[:, 0]], p[:, idx[:, 1]], p[:, idx[:, 2]]
    v1 = a - b
    v2 = c - b
    v1 = v1 / torch.sqrt((v1 * v1).sum(-1, keepdim=True) + 1e-14)
    v2 = v2 / torch.sqrt((v2 * v2).sum(-1, keepdim=True) + 1e-14)
    s = v1 + v2
    qu = (axes[:, 0, :] * s).sum(-1)
    qv = (axes[:, 1, :] * s).sum(-1)
    return torch.cat([qu, qv], dim=-1)


def _torsion(p, idx):
    a, b, c, d = (p[:, idx[:, 0]], p[:, idx[:, 1]], p[:, idx[:, 2]],
                  p[:, idx[:, 3]])
    b1, b2, b3 = b - a, c - b, d - c
    n1 = torch.linalg.cross(b1, b2, dim=-1)
    n2 = torch.linalg.cross(b2, b3, dim=-1)
    b2n = b2 / torch.sqrt((b2 * b2).sum(-1, keepdim=True) + 1e-14)
    m1 = torch.linalg.cross(n1, b2n, dim=-1)
    x = (n1 * n2).sum(-1)
    y = (m1 * n2).sum(-1)
    return torch.atan2(y, x)


class InternalCoordinates:
    """Static primitive lists; functions of batched coordinates.

    bonds (Mb,2) / angles (Ma,3) / torsions (Mt,4): 0-based numpy indices.
    """

    def __init__(self, bonds=None, angles=None, torsions=None, n_atoms=None,
                 linear_bends=None, linear_axes=None):
        def as_arr(x, w):
            if x is None or len(x) == 0:
                return np.zeros((0, w), dtype=np.int32)
            return np.asarray(x, np.int32)

        self.bonds = as_arr(bonds, 2)
        self.angles = as_arr(angles, 3)
        self.torsions = as_arr(torsions, 4)
        self.linear_bends = as_arr(linear_bends, 3)
        if linear_axes is None or len(self.linear_bends) == 0:
            self.linear_axes = np.zeros((0, 2, 3))
        else:
            self.linear_axes = np.asarray(linear_axes, np.float64)
        self.n_atoms = n_atoms
        self.n_primitives = (len(self.bonds) + len(self.angles)
                             + len(self.torsions)
                             + 2 * len(self.linear_bends))
        self._idx = {name: torch.as_tensor(getattr(self, name),
                                           dtype=torch.long)
                     for name in ("bonds", "angles", "torsions",
                                  "linear_bends")}

    def torsion_mask(self, device=None):
        """(M,) bool: which primitive slots hold torsions."""
        nb, na, nt = len(self.bonds), len(self.angles), len(self.torsions)
        idx = torch.arange(self.n_primitives, device=device)
        return (idx >= nb + na) & (idx < nb + na + nt)

    # --- primitive values --------------------------------------------------

    def q(self, coords):
        """(B, N, 3) -> (B, M) primitive values (Bohr / radians)."""
        dev = coords.device
        idx = {k: v.to(dev) for k, v in self._idx.items()}
        parts = []
        if len(self.bonds):
            parts.append(_stretch(coords, idx["bonds"]))
        if len(self.angles):
            parts.append(_bend(coords, idx["angles"]))
        if len(self.torsions):
            parts.append(_torsion(coords, idx["torsions"]))
        if len(self.linear_bends):
            parts.append(_linear_bend(
                coords, idx["linear_bends"],
                torch.as_tensor(self.linear_axes, dtype=coords.dtype,
                                device=dev)))
        if not parts:
            return coords.new_zeros((coords.shape[0], 0))
        return torch.cat(parts, dim=-1)

    def q_flat(self, x_flat):
        """(B, 3N) -> (B, M)."""
        return self.q(x_flat.reshape(x_flat.shape[0], -1, 3))

    # --- Wilson B ----------------------------------------------------------

    def b_matrix(self, coords):
        """(B, M, 3N) exact Wilson matrices by forward-mode autodiff."""
        b, n, _ = coords.shape

        def one(x_flat):
            return self.q_flat(x_flat[None])[0]

        return torch.func.vmap(torch.func.jacfwd(one))(
            coords.reshape(b, 3 * n))

    @staticmethod
    def g_matrix(b):
        return b @ b.mT

    @staticmethod
    def g_pinv(g, thresh=1e-8):
        """Moore-Penrose inverse (B, M, M) via a masked eigendecomposition:
        eigenvalues at or below thresh * max|w| are dropped."""
        w, v = eigh_fast(g)
        keep = w > thresh * torch.clamp(w.abs().amax(-1, keepdim=True),
                                        min=1e-30)
        inv_w = torch.where(keep, 1.0 / torch.where(keep, w, 1.0), 0.0)
        return (v * inv_w[..., None, :]) @ v.mT

    # --- gradient / Hessian transforms ------------------------------------

    def cart_to_internal_gradient(self, g_cart, coords):
        """g_q = G^- B g_x: (B, N, 3) -> (B, M)."""
        b = self.b_matrix(coords)
        return _mv(self.g_pinv(self.g_matrix(b)),
                   _mv(b, g_cart.reshape(b.shape[0], -1)))

    def internal_to_cart_gradient(self, g_q, coords):
        """g_x = B^T g_q: (B, M) -> (B, N, 3)."""
        b = self.b_matrix(coords)
        return _mv(b.mT, g_q).reshape(coords.shape)

    def curvature_correction(self, g_q, coords):
        """K = sum_k g_q[k] d2 q_k / dx dx' (B, 3N, 3N): the Hessian of the
        contraction g_q . q(x), forward over reverse per structure."""
        b, n, _ = coords.shape

        def contracted(x_flat, gq):
            return (gq * self.q_flat(x_flat[None])[0]).sum()

        return torch.func.vmap(torch.func.hessian(contracted))(
            coords.reshape(b, 3 * n), g_q)

    def cart_hessian_from_internal(self, h_q, g_q, coords):
        """H_x = B^T H_q B + K."""
        b = self.b_matrix(coords)
        return b.mT @ h_q @ b + self.curvature_correction(g_q, coords)

    def internal_hessian_from_cart(self, h_x, g_cart, coords):
        """H_q = G^- B (H_x - K) B^T G^-."""
        b = self.b_matrix(coords)
        ginv = self.g_pinv(self.g_matrix(b))
        g_q = _mv(ginv, _mv(b, g_cart.reshape(b.shape[0], -1)))
        k = self.curvature_correction(g_q, coords)
        return ginv @ b @ (h_x - k) @ b.mT @ ginv

    # --- iterative back-transformation ------------------------------------

    def to_cartesian(self, q_target, coords0, n_iter=25):
        """x with q(x) = q_target (B, M) by `n_iter` Gauss-Newton steps from
        coords0 (B, N, 3); torsion differences wrapped mod 2 pi."""
        is_torsion = self.torsion_mask(coords0.device)
        x = coords0
        for _ in range(n_iter):
            dq = q_target - self.q(x)
            dq = torch.where(is_torsion,
                             torch.atan2(torch.sin(dq), torch.cos(dq)), dq)
            b = self.b_matrix(x)
            dx = _mv(b.mT, _mv(self.g_pinv(b @ b.mT), dq))
            x = x + dx.reshape(x.shape)
        return x

    # --- delocalized internals (Baker 1996) --------------------------------

    def delocalized_basis(self, coords, n_active=None, thresh=1e-8):
        """U (B, M, M): eigenvectors of G with nonzero eigenvalues (the DIC
        active space), the other columns zero, and the (B, M) mask of the
        kept columns."""
        del n_active
        b = self.b_matrix(coords)
        w, v = eigh_fast(self.g_matrix(b))
        keep = w > thresh * torch.clamp(w.abs().amax(-1, keepdim=True),
                                        min=1e-30)
        return torch.where(keep[..., None, :], v, 0.0), keep


# --------------------------------------------------------------------------
# primitive auto-detection (host-side)
# --------------------------------------------------------------------------

def detect_primitives(coords_np, z, scale=1.3, link_fragments=True,
                      linear_thresh_deg=170.0, with_linear=False):
    """Bond graph from covalent radii; angles and torsions from the graph;
    minimal link bonds between disconnected fragments. Returns (bonds,
    angles, torsions) numpy index arrays of one structure (N, 3).

    With `with_linear=True`, near-linear triples (angle >=
    linear_thresh_deg) leave the regular bend list and come back as a 4th
    return value, and torsions whose inner angles are near-linear are
    dropped. The default keeps every triple."""
    if not with_linear:
        linear_thresh_deg = 181.0      # unreachable: keep every triple
    coords_np = np.asarray(coords_np, dtype=np.float64)
    z = np.asarray(z)
    n = len(coords_np)
    radii = np.asarray(COVALENT_RADII_1)[z]
    d = np.linalg.norm(coords_np[:, None] - coords_np[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    adj = d < scale * (radii[:, None] + radii[None, :])

    # connect fragments with shortest inter-fragment contacts
    if link_fragments:
        labels = _components(adj)
        while len(set(labels)) > 1:
            best = None
            for a in range(n):
                for b in range(a + 1, n):
                    if labels[a] != labels[b]:
                        if best is None or d[a, b] < d[best]:
                            best = (a, b)
            adj[best[0], best[1]] = adj[best[1], best[0]] = True
            labels = _components(adj)

    bonds = [(i, j) for i in range(n) for j in range(i + 1, n) if adj[i, j]]

    def _angle_deg(a, j, c):
        v1 = coords_np[a] - coords_np[j]
        v2 = coords_np[c] - coords_np[j]
        cosv = np.dot(v1, v2) / max(np.linalg.norm(v1) * np.linalg.norm(v2),
                                    1e-30)
        return np.degrees(np.arccos(np.clip(cosv, -1.0, 1.0)))

    angles, linear = [], []
    for j in range(n):
        nb = [i for i in range(n) if adj[i, j]]
        for a, c in itertools.combinations(nb, 2):
            (linear if _angle_deg(a, j, c) >= linear_thresh_deg
             else angles).append((a, j, c))

    torsions = []
    for (j, k) in bonds:
        for i in range(n):
            if adj[i, j] and i != k:
                for l in range(n):
                    if adj[l, k] and l != j and l != i:
                        if (_angle_deg(i, j, k) < linear_thresh_deg
                                and _angle_deg(j, k, l) < linear_thresh_deg):
                            torsions.append((i, j, k, l))

    out = (np.asarray(bonds, np.int32).reshape(-1, 2),
           np.asarray(angles, np.int32).reshape(-1, 3),
           np.asarray(torsions, np.int32).reshape(-1, 4))
    if with_linear:
        out = out + (np.asarray(linear, np.int32).reshape(-1, 3),)
    return out


def linear_bend_axes(coords_np, linear):
    """Frozen orthonormal reference axes (Ml,2,3) for `_linear_bend`: for
    each near-linear a-b-c, u and v span the plane perpendicular to a->c."""
    coords_np = np.asarray(coords_np, dtype=np.float64)
    axes = np.zeros((len(linear), 2, 3))
    for m, (a, _, c) in enumerate(np.asarray(linear).reshape(-1, 3)):
        w = coords_np[c] - coords_np[a]
        w = w / max(np.linalg.norm(w), 1e-30)
        e = np.eye(3)[np.argmin(np.abs(w))]
        u = np.cross(w, e)
        u = u / max(np.linalg.norm(u), 1e-30)
        axes[m, 0] = u
        axes[m, 1] = np.cross(w, u)
    return axes


def _components(adj):
    n = adj.shape[0]
    labels = list(range(n))
    changed = True
    while changed:
        changed = False
        for i in range(n):
            for j in range(n):
                if adj[i, j] and labels[j] != labels[i]:
                    m = min(labels[i], labels[j])
                    labels[i] = labels[j] = m
                    changed = True
    return labels


def auto_internals(coords_np, z, **kw):
    """Detect primitives of one structure (N, 3) (near-linear triples as
    linear-bend pairs) and build InternalCoordinates."""
    bonds, angles, torsions, linear = detect_primitives(
        coords_np, z, with_linear=True, **kw)
    return InternalCoordinates(bonds, angles, torsions,
                               n_atoms=len(coords_np),
                               linear_bends=linear,
                               linear_axes=linear_bend_axes(coords_np,
                                                            linear))


def cartesian_to_z_matrix(coords):
    """Chain Z-matrix values [r_12, r_23, th_123, (r_i, th, phi)...] of one
    structure (N, 3): distances in Bohr, angles in degrees, vectorized over
    the chain."""
    c = torch.as_tensor(coords)
    n = c.shape[0]
    if n < 2:
        return c.new_zeros((0,))
    out = [(torch.linalg.vector_norm(c[1] - c[0]) + 1e-15)[None]]
    if n >= 3:
        r13 = torch.linalg.vector_norm(c[2] - c[0]) + 1e-15
        cosv = ((c[1] - c[0]) @ (c[2] - c[0])) / (out[0][0] * r13)
        out.append((torch.linalg.vector_norm(c[2] - c[1]) + 1e-15)[None])
        out.append(torch.rad2deg(torch.arccos(torch.clamp(cosv, -1.0,
                                                          1.0)))[None])
    if n >= 4:
        a, b, d, e = c[:-3], c[1:-2], c[2:-1], c[3:]
        r = torch.linalg.vector_norm(e - d, dim=1) + 1e-15
        r_bd = torch.linalg.vector_norm(d - b, dim=1) + 1e-15
        cos_th = ((d - b) * (e - d)).sum(1) / (r_bd * r)
        th = torch.rad2deg(torch.arccos(torch.clamp(cos_th, -1.0, 1.0)))
        n1 = torch.linalg.cross(b - a, d - b)
        n2 = torch.linalg.cross(d - b, e - d)
        n1 = n1 / (torch.linalg.vector_norm(n1, dim=1, keepdim=True) + 1e-15)
        n2 = n2 / (torch.linalg.vector_norm(n2, dim=1, keepdim=True) + 1e-15)
        cos_p = torch.clamp((n1 * n2).sum(1), -1.0, 1.0)
        sign = torch.sign((torch.linalg.cross(n1, n2) * (d - b)).sum(1))
        phi = torch.rad2deg(torch.arccos(cos_p)) * torch.where(
            sign < 0, -1.0, torch.ones_like(cos_p))
        out.append(torch.stack([r, th, phi], dim=1).reshape(-1))
    return torch.cat(out)


def local_force_constants(cart_hess, b_matrix, method="compliance"):
    """Per-primitive local force constants from a Cartesian Hessian (3N,3N)
    and a Wilson matrix (Q, 3N).

    "compliance": k_q = 1 / (B H^+ B^T)_qq (Brandhorst & Grunenberg, Chem.
    Soc. Rev. 37 (2008) 1558), with the pseudo-inverse; valid anywhere.
    "projection": B^+T H B^+ through the G-inverse (stationary points
    only). Returns the (Q,) diagonal or the full (Q, Q) matrix."""
    h = torch.as_tensor(cart_hess)
    b = torch.as_tensor(b_matrix)
    if method == "compliance":
        h_pinv = torch.linalg.pinv(0.5 * (h + h.mT), rtol=1e-8)
        return 1.0 / torch.diagonal(b @ h_pinv @ b.mT)
    if method == "projection":
        g_inv = torch.linalg.pinv(b @ b.mT, rtol=1e-10)
        b_plus = g_inv @ b
        return b_plus @ h @ b_plus.mT
    raise ValueError("method must be 'compliance' or 'projection'")
