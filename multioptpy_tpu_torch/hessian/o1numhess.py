"""O(1)-gradient seminumerical Hessians.

Counterpart of `multioptpy_tpu/hessian/o1numhess.py` (O1NumHess, arXiv
2508.07544): an accurate Hessian from O(1) gradient evaluations per atom.

`o1numhess`       compact probe-and-project variant: the softest modes of
                  a model-Hessian prior as probe directions, exact central
                  differences along them, and PSB secant corrections.
`o1numhess_full`  the published algorithm: localized displacement
                  directions on an adaptive-cutoff neighbour graph,
                  single-sided differences, the distance-masked least-
                  squares (ODLR) reconstruction and the damped low-rank
                  refinement.

In both, all displaced gradients are ONE batched calculator call; the
direction generation and the reconstruction run on the host in numpy and
scipy, as in the reference.
"""

import numpy as np
import torch

from multioptpy_tpu_torch.hessian.updates import psb_delta
from multioptpy_tpu_torch.periodic import COVALENT_RADII_1


def _gradients(calc, geoms, z):
    """Flat gradients (K, 3N) of a batch of structures (K, N, 3)."""
    return calc.energy_and_gradient(geoms, z)[1].reshape(geoms.shape[0], -1)


def o1numhess(calc, coords, z, n_probes=6, step=1e-3, prior=None,
              directions=None):
    """(N,3) -> (3N, 3N) Hessian from 2 n_probes gradients and a prior.

    prior: (3N,3N) model Hessian (default: the projected Lindh guess).
    directions: optional (k, 3N) probe directions (orthonormalized here).
    The softest prior modes include its TR/rot null space, whose basis is
    each eigensolver's own choice: runs that must agree pass
    `directions`."""
    if prior is None:
        from multioptpy_tpu_torch.hessian.model import model_hessian
        prior = model_hessian(coords[None], np.asarray(z), kind="lindh")[0]
    kind = dict(dtype=coords.dtype, device=coords.device)
    prior = torch.as_tensor(prior, **kind)
    if directions is None:
        w, v = torch.linalg.eigh(prior)
        order = torch.argsort(w.abs())
        directions = v.mT[order[:n_probes]]
    else:
        directions = torch.as_tensor(np.asarray(directions), **kind)[:n_probes]
    q, _ = torch.linalg.qr(directions.mT)
    dirs = q.mT                                       # (k, 3N)
    k = dirs.shape[0]
    flat = coords.reshape(-1)
    both = torch.cat([flat[None] + step * dirs, flat[None] - step * dirs])
    grads = _gradients(calc, both.reshape(-1, *coords.shape), z)
    hv = (grads[:k] - grads[k:]) / (2.0 * step)       # (k, 3N): H v_i
    # sequential symmetric secant corrections: after each, H s = y exactly
    h = prior
    for i in range(k):
        h = h + psb_delta(h[None], dirs[i][None], hv[i][None])[0]
        h = 0.5 * (h + h.mT)
    return h


def _adaptive_cutoffs(coords_np, z_np, rcov_scale):
    """Per-pair cutoff rcov_scale (R_i + R_j) + 1 Bohr, raised to protect
    1-2 and 1-3 topological pairs."""
    rcov = np.asarray(COVALENT_RADII_1)[z_np]
    dist = np.linalg.norm(coords_np[:, None] - coords_np[None, :], axis=-1)
    cutoff = rcov_scale * (rcov[:, None] + rcov[None, :]) + 1.0
    bond = (dist < 1.3 * (rcov[:, None] + rcov[None, :])) & (dist > 1e-3)
    angle = (bond.astype(float) @ bond.astype(float)) > 0.1
    np.fill_diagonal(angle, False)
    protected = bond | angle
    cutoff[protected] = np.maximum(cutoff[protected], dist[protected] + 2.0)
    return dist, cutoff


def _atom_adjacency(dist, cutoff):
    """Adjacency under the cutoff, with minimum-spanning-tree bridges so
    disconnected fragments still share directions."""
    from scipy.sparse.csgraph import (connected_components,
                                      minimum_spanning_tree)

    n = dist.shape[0]
    adj = dist < cutoff
    np.fill_diagonal(adj, True)
    n_comp, labels = connected_components(adj, directed=False)
    if n_comp > 1:
        big = dist.max() * 10.0
        comp_dist = np.full((n_comp, n_comp), big)
        bridge = {}
        for i in range(n):
            for j in range(i + 1, n):
                ci, cj = labels[i], labels[j]
                if ci != cj and dist[i, j] < comp_dist[ci, cj]:
                    comp_dist[ci, cj] = comp_dist[cj, ci] = dist[i, j]
                    bridge[(ci, cj)] = (i, j)
                    bridge[(cj, ci)] = (j, i)
        mst = minimum_spanning_tree(comp_dist).toarray()
        for c1 in range(n_comp):
            for c2 in range(c1 + 1, n_comp):
                if 0 < mst[c1, c2] < big:
                    i, j = bridge[(c1, c2)]
                    adj[i, j] = adj[j, i] = True
    return adj


def _displacement_directions(coords_np, adj, h0):
    """Localized displacement set: 3 translations, 3 principal rotations,
    the breathing mode, then iterated local stiffest modes of the prior on
    each atom's neighbourhood, phase-aligned and orthogonalized into global
    directions."""
    n_atom = coords_np.shape[0]
    n_dof = 3 * n_atom
    dirs = np.zeros((n_dof, n_dof))
    for i in range(3):
        dirs[i::3, i] = 1.0
    rel = coords_np - coords_np.mean(axis=0)
    inertia = np.eye(3) * np.sum(rel ** 2) - rel.T @ rel
    _, axes = np.linalg.eigh(inertia)
    for i in range(3):
        dirs[:, 3 + i] = np.cross(axes[:, i], rel).reshape(-1)
    dirs[:, 6] = rel.reshape(-1)
    norms = np.linalg.norm(dirs[:, :7], axis=0)
    ok = norms > 1e-8
    dirs[:, :7] = np.divide(dirs[:, :7], norms[None, :], where=ok[None, :])

    nb_dofs = []
    for i in range(n_atom):
        nb_atoms = np.nonzero(adj[i])[0]
        nb_dofs.append((3 * nb_atoms[:, None]
                        + np.arange(3)[None, :]).reshape(-1))

    n_final = 7
    for n_curr in range(7, n_dof):
        ev = np.zeros(n_dof)
        coverage = np.zeros(n_dof)
        for i_atom in range(n_atom):
            nb = nb_dofs[i_atom]
            if len(nb) <= n_curr:
                continue
            sub_h = h0[np.ix_(nb, nb)]
            q, _ = np.linalg.qr(dirs[np.ix_(nb, range(n_curr))])
            proj = np.eye(len(nb)) - q @ q.T
            sub_h = proj @ sub_h @ proj.T
            sub_h = 0.5 * (sub_h + sub_h.T)
            w, v = np.linalg.eigh(sub_h)
            locev = v[:, np.argmax(np.abs(w))]
            accum = coverage[nb] * ev[nb]
            sign = -1.0 if accum @ locev < -1e-6 else 1.0
            ev[nb] = (accum + sign * locev) / (coverage[nb] + 1.0)
            coverage[nb] += 1.0
        ev -= dirs[:, :n_curr] @ (dirs[:, :n_curr].T @ ev)
        nrm = np.linalg.norm(ev)
        if nrm < 1e-8:
            n_final = n_curr
            break
        dirs[:, n_curr] = ev / nrm
        n_final = n_curr + 1
    return dirs[:, :n_final]


def _odlr_reconstruct(dof_dist, dof_cutoff, dirs, g_meas, lam=1e-2,
                      beta=1.5, ddmax=5.0):
    """Distance-masked least squares: minimize |H D - G|^2 + |W H|^2 with
    W = sqrt(lam) max(0, d - cutoff)^beta, H symmetric and zero beyond
    cutoff + ddmax; the normal equations by CG over the packed upper
    triangle."""
    from scipy.sparse.linalg import LinearOperator, cg

    n = dof_dist.shape[0]
    w2 = lam * np.maximum(0.0, dof_dist - dof_cutoff) ** (2.0 * beta)
    rhs = g_meas @ dirs.T
    rhs = 0.5 * (rhs + rhs.T)
    mask = dof_dist < (dof_cutoff + ddmax)
    for i in range(n):
        mask[i, :i] = False

    def pack(m):
        return ((m + m.T) * 0.5)[mask]

    def unpack(v):
        h = np.zeros((n, n))
        h[mask] = v
        h = h + h.T
        h[np.diag_indices(n)] /= 2.0
        return h

    rhs_vec = pack(rhs)
    if rhs_vec.size == 0:
        return np.zeros((n, n))

    def matvec(x):
        h = unpack(x)
        f1 = (h @ dirs) @ dirs.T
        return pack(0.5 * (f1 + f1.T) + w2 * h)

    op = LinearOperator((rhs_vec.size, rhs_vec.size), matvec=matvec,
                        dtype=float)
    sol, _ = cg(op, rhs_vec, maxiter=1000, atol=1e-14)
    return unpack(sol)


def _lr_refine(h, dirs, g_meas, thresh=1e-5, max_iter=1000):
    """Damped low-rank refinement with momentum and a best-solution keeper:
    symmetric rank-k corrections until H reproduces every measured
    curvature column."""
    eps = 1e-3
    scales = eps / np.maximum(eps, np.linalg.norm(g_meas, axis=0))
    g_s = g_meas * scales[None, :]
    d_s = dirs * scales[None, :]
    damp, momentum = 1.0, 0.5
    prev = np.zeros_like(h)
    best_h, best_err, err0 = h.copy(), np.inf, np.inf
    g_norm = np.linalg.norm(g_s)
    for _ in range(max_iter):
        resid = g_s - h @ d_s
        err = np.linalg.norm(resid)
        if err < best_err:
            best_err, best_h = err, h.copy()
        if err < thresh:
            break
        ratio = err / err0 if np.isfinite(err0) else 0.0
        if err > err0 and err > g_norm:
            damp *= 0.5
            momentum = 0.0
            prev[:] = 0.0
            if err > 2.0 * best_err:
                h = best_h.copy()
        elif ratio < 0.999:
            damp = min(1.2, damp * 1.05)
            momentum = min(0.9, momentum + 0.05)
        elif abs(err - err0) < 1e-7:
            break
        corr = resid @ d_s.T
        corr = 0.5 * (corr + corr.T)
        update = damp * corr + momentum * prev
        h = h + update
        prev = update
        err0 = err
    return best_h


def o1numhess_full(calc, coords, z, rcov_scale=2.5, delta=0.005,
                   prior_kind="swart"):
    """The published O1NumHess algorithm on one structure (N,3), Bohr.
    Gradient cost: one reference gradient, one per displacement direction
    and one more for the double-sided breathing mode, all in one batched
    calculator call. Returns (3N, 3N) on the device of `coords`."""
    from multioptpy_tpu_torch.hessian.model import model_hessian

    coords_np = coords.detach().cpu().numpy().astype(np.float64)
    z_np = np.asarray(z)
    n_dof = coords_np.size
    dist, cutoff = _adaptive_cutoffs(coords_np, z_np, rcov_scale)
    adj = _atom_adjacency(dist, cutoff)
    h0 = model_hessian(coords[None], z_np, kind=prior_kind,
                       project=False)[0].detach().cpu().numpy()
    dirs = _displacement_directions(coords_np, adj, h0)    # (3N, K)
    k = dirs.shape[1]

    flat = coords.reshape(-1)
    d_unit = dirs / np.maximum(np.linalg.norm(dirs, axis=0), 1e-30)[None, :]
    d_unit_t = torch.as_tensor(d_unit.T, dtype=coords.dtype,
                               device=coords.device)        # (K, 3N)
    geoms = torch.cat([flat[None], flat[None] + delta * d_unit_t,
                       flat[None] - delta * d_unit_t[6:7]])
    grads = _gradients(calc, geoms.reshape(-1, *coords.shape),
                       z).detach().cpu().numpy()
    g0, g_fwd, g_bwd6 = grads[0], grads[1:1 + k], grads[1 + k]
    g_meas = np.zeros((n_dof, k))
    for i in range(3, k):                 # translations: exactly zero
        if i == 6:                        # breathing: double-sided
            g_meas[:, i] = (g_fwd[6] - g_bwd6) / (2.0 * delta)
        else:
            g_meas[:, i] = (g_fwd[i] - g0) / delta

    dof_dist = np.kron(dist, np.ones((3, 3)))
    dof_cutoff = np.kron(cutoff, np.ones((3, 3)))
    h = _odlr_reconstruct(dof_dist, dof_cutoff, d_unit, g_meas)
    h = _lr_refine(h, d_unit, g_meas)
    return torch.as_tensor(0.5 * (h + h.T), dtype=coords.dtype,
                           device=coords.device)
