"""Geometry utilities: distances, masses, mass weighting, TR/rot
projection, Kabsch alignment, bond connectivity and the -sc shape
conditions.

Counterpart of `multioptpy_tpu/geometry.py`. The TR/rot projection takes an
explicit leading batch axis, (B, N, 3) in Bohr, in place of the reference's
`vmap`; the distance, alignment and connectivity helpers take one
structure (N, 3), as the reference's do, or any leading batch axes.
"""

import numpy as np
import torch

from multioptpy_tpu_torch.device import bmv
from multioptpy_tpu_torch.periodic import COVALENT_RADII_1, MASS_AMU

_EPS = 1e-12


def pairwise_distances(coords):
    """(..., N, 3) -> (..., N, N) distance matrix, safe at the diagonal
    (zero there, with a finite gradient)."""
    n = coords.shape[-2]
    eye = torch.eye(n, dtype=coords.dtype, device=coords.device)
    diff = coords[..., :, None, :] - coords[..., None, :, :]
    return torch.sqrt((diff * diff).sum(-1) + eye * _EPS) * (1.0 - eye)


def safe_norm(x, axis=-1, eps=_EPS):
    """Differentiable-at-zero vector norm."""
    return torch.sqrt((x * x).sum(axis) + eps)


def mass_weight_coords(coords, masses):
    """COM-shifted mass-weighted coordinates (..., N, 3)."""
    m = masses.to(coords.dtype)
    com = (coords * m[:, None]).sum(-2, keepdim=True) / m.sum()
    return (coords - com) * torch.sqrt(m)[:, None]


def _weighted_mean(p, weights):
    return (p * weights[:, None]).sum(-2, keepdim=True) / weights.sum()


def kabsch_rotation(p, q, weights=None):
    """Optimal rotation (..., 3, 3) aligning p onto q ((..., N, 3) each,
    centered here): R with det +1, so that (p - <p>) @ R fits q - <q>; a
    reflection in the SVD is undone by flipping the sign of the last
    singular direction."""
    if weights is None:
        weights = torch.ones(p.shape[-2], dtype=p.dtype, device=p.device)
    weights = weights.to(p.dtype)
    pc = p - _weighted_mean(p, weights)
    qc = q - _weighted_mean(q, weights)
    h = (pc * weights[:, None]).mT @ qc
    u, _, vt = torch.linalg.svd(h)
    d = torch.sign(torch.linalg.det(u @ vt))
    flip = torch.ones(d.shape + (3,), dtype=p.dtype, device=p.device)
    flip = torch.cat([flip[..., :2], d[..., None]], dim=-1)
    return (u * flip[..., None, :]) @ vt


def align_to(p, q, weights=None):
    """Rigid-align p onto q (translation + rotation); returns aligned p."""
    if weights is None:
        weights = torch.ones(p.shape[-2], dtype=p.dtype, device=p.device)
    weights = weights.to(p.dtype)
    r = kabsch_rotation(p, q, weights)
    return (p - _weighted_mean(p, weights)) @ r + _weighted_mean(q, weights)


def rmsd(p, q, weights=None, align=True):
    """Root-mean-square deviation after optional Kabsch alignment."""
    if align:
        p = align_to(p, q, weights)
    return torch.sqrt(((p - q) ** 2).sum(-1).mean(-1))


def bond_connectivity(coords, z, scale=1.2):
    """Boolean (..., N, N) adjacency: r_ij < scale (R_i + R_j) with the
    single-bond covalent radii."""
    radii = torch.as_tensor(np.asarray(COVALENT_RADII_1)[np.asarray(z)],
                            dtype=coords.dtype, device=coords.device)
    d = pairwise_distances(coords)
    return (d < scale * (radii[:, None] + radii[None, :])) & (d > _EPS)


def masses_from_z(z):
    """Atomic numbers -> amu masses (float64), as a tensor beside `z`."""
    if isinstance(z, torch.Tensor):
        return torch.as_tensor(MASS_AMU, device=z.device)[z.long()]
    return torch.as_tensor(MASS_AMU[np.asarray(z)])


def center_of_mass(coords, masses):
    """(B,N,3), (N,) -> (B,3)."""
    m = masses.to(coords.dtype)
    return (coords * m[:, None]).sum(-2) / m.sum()


def _orthonormalize_masked(vectors):
    """Modified Gram-Schmidt over the rows of (B, k, D) with rank masking:
    linearly dependent rows become zero rows, so P = I - sum v v^T is
    unchanged (the reference's branchless `norm > 1e-10` drop)."""
    vecs = vectors.clone()
    k = vecs.shape[-2]
    for i in range(k):
        v = vecs[:, i]
        prev = (torch.arange(k, device=vecs.device) < i).to(v.dtype)
        coeffs = bmv(vecs, v) * prev
        v = v - bmv(vecs.mT, coeffs)
        norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        ok = norm > 1e-10
        vecs[:, i] = torch.where(ok, v / torch.where(ok, norm, 1.0), 0.0)
    return vecs


def tr_rot_basis(coords, masses=None):
    """Orthonormal translation+rotation basis, shape (B, 6, 3N); zero rows
    stand in for dependent directions (linear molecules)."""
    b, n, _ = coords.shape
    dtype = coords.dtype
    if masses is None:
        w = torch.ones(n, dtype=dtype, device=coords.device)
        centered = coords - coords.mean(-2, keepdim=True)
    else:
        w = torch.sqrt(masses.to(dtype))
        centered = coords - center_of_mass(coords, masses)[:, None, :]
    eye3 = torch.eye(3, dtype=dtype, device=coords.device)
    trans = (eye3[:, None, :] * w[None, :, None]).expand(b, 3, n, 3)
    x, y, z = centered[..., 0], centered[..., 1], centered[..., 2]
    zero = torch.zeros_like(x)
    rots = torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=1) * w[None, None, :, None]
    basis = torch.cat([trans, rots], dim=1).reshape(b, 6, 3 * n)
    return _orthonormalize_masked(basis)


def tr_rot_projector(coords, masses=None):
    """P = I - sum_k v_k v_k^T over the TR/rot basis, shape (B, 3N, 3N)."""
    basis = tr_rot_basis(coords, masses)
    n3 = basis.shape[-1]
    eye = torch.eye(n3, dtype=coords.dtype, device=coords.device)
    return eye - basis.mT @ basis


def project_gradient_tr_rot(gradient, coords):
    """Remove net translation/rotation components from (B,N,3) gradients."""
    basis = tr_rot_basis(coords)
    g = gradient.reshape(gradient.shape[0], -1)
    g = g - bmv(basis.mT, bmv(basis, g))
    return g.reshape(gradient.shape)


def project_hessian_tr_rot(hessian, coords, masses=None):
    """Project TR/rot modes out of (B,3N,3N) Hessians; symmetrized."""
    p = tr_rot_projector(coords, masses)
    h = p.mT @ hessian @ p
    return 0.5 * (h + h.mT)


def judge_shape_condition(coords, spec):
    """True -> abort: some [value, gt|lt, atoms] condition is violated.

    The host-side guard of the -sc flag, on one structure (N, 3) in Bohr.
    Triples: atoms "i,j" = bond length [Angstrom], "i,j,k" = angle at j
    [deg], "i,j,k,l" = dihedral [deg] (1-based); `gt`/`lt` states what must
    remain true."""
    spec = list(spec)
    if not spec:
        return False
    if len(spec) % 3 != 0:
        raise ValueError("-sc expects repeated [value gt|lt atoms] triples")
    c = np.asarray(coords.detach().cpu() if isinstance(coords, torch.Tensor)
                   else coords, dtype=np.float64)
    bohr2ang = 0.52917721067
    for i in range(0, len(spec), 3):
        value = float(spec[i])
        op = str(spec[i + 1]).lower()
        atoms = [int(a) - 1 for a in str(spec[i + 2]).split(",")]
        if len(atoms) == 2:
            cur = float(np.linalg.norm(c[atoms[0]] - c[atoms[1]])) * bohr2ang
        elif len(atoms) == 3:
            v1 = c[atoms[0]] - c[atoms[1]]
            v2 = c[atoms[2]] - c[atoms[1]]
            cos = np.dot(v1, v2) / max(
                np.linalg.norm(v1) * np.linalg.norm(v2), 1e-12)
            cur = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
        elif len(atoms) == 4:
            b1 = c[atoms[1]] - c[atoms[0]]
            b2 = c[atoms[2]] - c[atoms[1]]
            b3 = c[atoms[3]] - c[atoms[2]]
            n1 = np.cross(b1, b2)
            n2 = np.cross(b2, b3)
            m = np.cross(n1, b2 / max(np.linalg.norm(b2), 1e-12))
            cur = float(np.degrees(np.arctan2(np.dot(m, n2),
                                              np.dot(n1, n2))))
        else:
            raise ValueError(f"-sc atoms '{spec[i + 2]}': need 2-4 atoms")
        if op == "gt":
            ok = cur > value
        elif op == "lt":
            ok = cur < value
        else:
            raise ValueError(f"-sc operator '{op}': use gt or lt")
        if not ok:
            print(f"# shape condition violated: {spec[i + 2]} = {cur:.3f} "
                  f"not {op} {value} - aborting")
            return True
    return False
