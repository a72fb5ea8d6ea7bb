"""Model (guess) Hessians: the Lindh-2007 family with static D3 dispersion.

Counterpart of `multioptpy_tpu/hessian/model.py` for the kinds
`lindh2007d3_raw` (the flagship's initial and periodic Hessian) and
`lindh2007d3`: a diagonal force-constant vector k over internal primitives
(Lindh 2007 all-pair screening with gated D4 long-range terms), assembled
as one contraction H_x = B^T diag(k) B with the autodiff Wilson matrix,
plus the exact D3(BJ) Hessian, then TR/rot-projected. `lindh2007d3` then
applies the reference's gradient-damped transform
V diag(|lambda| 0.1 exp(-|g|^2)) V^T through the deflated eigh. Every other
kind arrives with ROADMAP Queue 1 item 10.

Everything runs on batched coordinates (B, N, 3) -> (B, 3N, 3N) for static
primitive sets.
"""

import numpy as np
import torch

from multioptpy_tpu_torch.coords.internals import (InternalCoordinates,
                                                   detect_primitives)
from multioptpy_tpu_torch.geometry import (project_hessian_tr_rot,
                                           tr_rot_projector)
from multioptpy_tpu_torch.hessian.dispersion import (d3_hessian, d4_charges,
                                                     d4_pair_force_const,
                                                     d4_pair_tables)
from multioptpy_tpu_torch.ops.eigh64 import eigh_deflated
from multioptpy_tpu_torch.periodic import COVALENT_RADII_1

SUPPORTED_KINDS = ("lindh2007d3_raw", "lindh2007d3")

# Lindh 2007 groups H | He..F | rest: screening exponents and d-table
_ALPHA_2007 = np.array([[1.0000, 0.3949, 0.3949],
                        [0.3949, 0.2800, 0.1200],
                        [0.3949, 0.1200, 0.0600]])
_D_2007 = np.array([[0.0, 3.6, 3.6],
                    [3.6, 5.3, 5.3],
                    [3.6, 5.3, 5.3]])


def _group3(z):
    z = np.asarray(z)
    return np.where(z < 2, 0, np.where(z < 10, 1, 2))


def _dist(coords, i, j):
    d = coords[:, i] - coords[:, j]
    return torch.sqrt((d * d).sum(-1) + 1e-14)


def _primitive_constants(kind, coords, z, bonds, angles, torsions, n_atoms):
    """Per-primitive diagonal force constants (B, M) of the Lindh 2007
    all-tuple screening model with D4 long-range terms: kr/kf/kt =
    0.45/0.10/0.0025, the D4 pair force constant joining a pair's screening
    only beyond twice its covalent length."""
    del n_atoms
    if kind != "lindh2007":
        raise NotImplementedError(
            f"model Hessian '{kind}': this port has {SUPPORTED_KINDS}; the "
            "other kinds arrive with ROADMAP Queue 1 item 10")
    z = np.asarray(z)
    kind_t = dict(dtype=coords.dtype, device=coords.device)
    rcov = np.asarray(COVALENT_RADII_1)[z]
    g3 = _group3(z)
    kr, kf, kt, kd = 0.45, 0.10, 0.0025, 0.05
    charges = d4_charges(coords, z)
    c6m, c8m, r0m = d4_pair_tables(z, dtype=np.float64)
    k_parts = []

    def g_pair(i, j):
        """exp screening + gated D4 term + d-table factor for pairs (i, j)."""
        i = np.asarray(i)
        j = np.asarray(j)
        r = _dist(coords, torch.as_tensor(i, dtype=torch.long,
                                          device=coords.device),
                  torch.as_tensor(j, dtype=torch.long, device=coords.device))
        rc = torch.as_tensor(rcov[i] + rcov[j], **kind_t)
        alpha = torch.as_tensor(_ALPHA_2007[g3[i], g3[j]], **kind_t)
        g = torch.exp(alpha * (rc ** 2 - r * r))
        qs = torch.exp(-3.0 * (charges[:, i] ** 2 + charges[:, j] ** 2))
        d4 = d4_pair_force_const(r, torch.as_tensor(c6m[i, j], **kind_t),
                                 torch.as_tensor(c8m[i, j], **kind_t),
                                 torch.as_tensor(r0m[i, j], **kind_t), qs)
        return (g, torch.where(r > 2.0 * rc, d4, 0.0),
                torch.as_tensor(_D_2007[g3[i], g3[j]], **kind_t))

    if len(bonds):
        g, d4, _ = g_pair(bonds[:, 0], bonds[:, 1])
        k_parts.append(kr * g + kd * d4)
    if len(angles):
        g1, d41, d01 = g_pair(angles[:, 1], angles[:, 0])
        g2, d42, d02 = g_pair(angles[:, 1], angles[:, 2])
        half = 0.5 * kd / kr
        k_parts.append(kf * (g1 + 0.5 * kd * d41 + half * d01)
                       * (g2 + 0.5 * kd * d42 + half * d02))
    if len(torsions):
        # the reference multiplies each leg's screening by the d-table
        # factor here (the angle term adds it)
        half = 0.5 * kd / kr
        legs = []
        for a, b in ((0, 1), (1, 2), (2, 3)):
            g, d4, d0 = g_pair(torsions[:, a], torsions[:, b])
            legs.append((g + 0.5 * kd * d4) * half * d0)
        k_parts.append(kt * legs[0] * legs[1] * legs[2])
    if not k_parts:
        return coords.new_zeros((coords.shape[0], 0))
    return torch.cat(k_parts, dim=-1)


def lindh2007_primitives(coords, z, rho_cutoff=1e-6):
    """Tuple lists of the Lindh-2007 all-pairs model for one structure
    (N, 3): every pair is a 'bond' primitive, triples are kept when both
    legs' screenings survive `rho_cutoff`, torsions come from ordinary
    connectivity. Host-side numpy."""
    coords = np.asarray(coords)
    z = np.asarray(z)
    n = len(z)
    rcov = np.asarray(COVALENT_RADII_1)[z]
    g3 = _group3(z)
    d = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)
    rc = rcov[:, None] + rcov[None, :]
    rho = np.exp(_ALPHA_2007[g3[:, None], g3[None, :]] * (rc ** 2 - d ** 2))

    bonds = np.array([(i, j) for i in range(n) for j in range(i + 1, n)],
                     dtype=np.int32).reshape(-1, 2)
    angles = [(j, i, k)
              for i in range(n) for j in range(n) for k in range(n)
              if j < k and i != j and i != k
              and rho[i, j] * rho[i, k] > rho_cutoff]
    angles = np.asarray(angles, dtype=np.int32).reshape(-1, 3)
    _, _, torsions = detect_primitives(coords, z)
    return bonds, angles, np.asarray(torsions, np.int32).reshape(-1, 4)


def _parse_kind(kind):
    """kind -> damp flag, for the kinds this port assembles."""
    k = kind.lower()
    if k not in SUPPORTED_KINDS:
        raise NotImplementedError(
            f"model Hessian '{kind}': this port has {SUPPORTED_KINDS}; the "
            "other kinds arrive with ROADMAP Queue 1 item 10")
    return not k.endswith("_raw")


def make_model_hessian_fn(z, bonds, angles, torsions, kind="lindh",
                          project=True):
    """`fn(coords (B,N,3), gradient (B,N,3) or None) -> (B,3N,3N)` for
    static primitives. `lindh2007d3` damps the projected spectrum by
    0.1 exp(-|g|^2) of each member's raw gradient; `lindh2007d3_raw` does
    not."""
    damp = _parse_kind(kind)
    z = np.asarray(z)
    n_atoms = len(z)
    ic = InternalCoordinates(bonds, angles, torsions, n_atoms)

    def fn(coords, gradient=None):
        k = _primitive_constants("lindh2007", coords, z, ic.bonds,
                                 ic.angles, ic.torsions, n_atoms)
        b = ic.b_matrix(coords)
        h = (b.mT * k[:, None, :]) @ b
        h = h + d3_hessian(coords, z)
        h = 0.5 * (h + h.mT)
        proj = None
        if project:
            proj = tr_rot_projector(coords)
            h = project_hessian_tr_rot(h, coords)
        if damp:
            ng2 = ((gradient ** 2).sum((-2, -1)) if gradient is not None
                   else torch.zeros(coords.shape[0], dtype=coords.dtype,
                                    device=coords.device))
            if proj is not None:
                w, v = eigh_deflated(h, proj)
            else:
                w, v = torch.linalg.eigh(h)
            scale = w.abs() * 0.1 * torch.exp(-ng2)[:, None]
            h = (v * scale[:, None, :]) @ v.mT
        return h

    return fn


def model_hessian(coords, z, kind="lindh", project=True, primitives=None,
                  gradient=None):
    """One-shot model Hessians (B, 3N, 3N) of coords (B, N, 3); unless
    `primitives` are given they are detected host-side for each member."""
    _parse_kind(kind)
    if primitives is not None:
        fn = make_model_hessian_fn(z, *primitives, kind, project)
        return fn(coords, gradient)
    out = []
    for i in range(coords.shape[0]):
        c_np = coords[i].detach().cpu().numpy()
        prims = (lindh2007_primitives(c_np, z)
                 if kind.lower().startswith("lindh2007")
                 else detect_primitives(c_np, z))
        fn = make_model_hessian_fn(z, *prims, kind, project)
        out.append(fn(coords[i:i + 1], None if gradient is None
                      else gradient[i:i + 1]))
    return torch.cat(out)
