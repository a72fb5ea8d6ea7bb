"""Path embeddings, convergence and IRC curvature analysis (host-side
numpy).

Counterpart of `multioptpy_tpu/analysis/pes.py`: the 2-D embeddings of a
trajectory that `mdmain` and `optmain` write under -cmds/-pca (classical
MDS of the frames' RMSD, PCA of their displacements), the Koopman (DMD)
convergence analysis of `optmain -km`, the per-point curvature
properties the euler/rk4 IRC integrators report, the per-branch table
`ircmain` writes, the path bending angles and the discrete curvature of
a path.
"""

from typing import NamedTuple

import numpy as np


class Embedding(NamedTuple):
    coords_2d: np.ndarray      # (S, 2)
    explained: np.ndarray      # variance ratios


def cmds_path_analysis(trajectory):
    """Classical MDS of the pairwise frame RMSD -> 2-D path embedding."""
    frames = np.asarray(trajectory).reshape(len(trajectory), -1)
    s = len(frames)
    d2 = (np.sum((frames[:, None] - frames[None, :]) ** 2, axis=-1)
          / frames.shape[1])
    j = np.eye(s) - np.ones((s, s)) / s
    b = -0.5 * j @ d2 @ j
    w, v = np.linalg.eigh(b)
    order = np.argsort(w)[::-1]
    w, v = w[order], v[:, order]
    w_pos = np.maximum(w[:2], 0.0)
    coords = v[:, :2] * np.sqrt(w_pos)[None, :]
    total = np.sum(np.maximum(w, 0.0)) + 1e-30
    return Embedding(coords_2d=coords, explained=w_pos / total)


def pca_path_analysis(trajectory):
    """PCA of the trajectory's displacement covariance -> 2-D embedding."""
    frames = np.asarray(trajectory).reshape(len(trajectory), -1)
    centered = frames - frames.mean(axis=0)
    u, s, _ = np.linalg.svd(centered, full_matrices=False)
    coords = u[:, :2] * s[:2]
    explained = s ** 2 / (np.sum(s ** 2) + 1e-30)
    return Embedding(coords_2d=coords, explained=explained[:2])


class KoopmanResult(NamedTuple):
    eigenvalues: np.ndarray
    decay_rates: np.ndarray
    converging: bool


def koopman_convergence_analysis(series):
    """DMD/Koopman spectrum of a convergence time series (gradient norms,
    energies): eigenvalues inside the unit circle mean contraction. A
    scalar series is delay-embedded in 4 dimensions."""
    x = np.asarray(series, dtype=np.float64)
    if x.ndim == 1:
        d = 4
        if len(x) <= d + 1:
            return KoopmanResult(np.array([]), np.array([]), True)
        x = np.stack([x[i:len(x) - d + i] for i in range(d)], axis=1)
    x0, x1 = x[:-1].T, x[1:].T  # (d, S-1)
    a = x1 @ np.linalg.pinv(x0)
    w = np.linalg.eigvals(a)
    rates = -np.log(np.maximum(np.abs(w), 1e-12))
    return KoopmanResult(eigenvalues=w, decay_rates=rates,
                         converging=bool(np.all(np.abs(w) < 1.0 + 1e-9)))


def irc_curvature_properties(grad_mw, prev_grad_mw, hessian_mw, step_size):
    """Per-point IRC curvature properties: the unit tangent g/|g| of the
    mass-weighted gradient, the curvature vector k = (g - g_prev)/ds, its
    norm, and its projections onto the positive-eigenvalue (> 1e-8) normal
    modes of the mass-weighted Hessian. Returns (unit_tangent,
    curvature_vector, scalar_curvature, curvature_coupling)."""
    g = np.asarray(grad_mw, dtype=np.float64).ravel()
    gp = np.asarray(prev_grad_mw, dtype=np.float64).ravel()
    tangent = g / (np.linalg.norm(g) + 1e-300)
    curv = (g - gp) / float(step_size)
    scalar = float(np.linalg.norm(curv))
    w, v = np.linalg.eigh(np.asarray(hessian_mw, dtype=np.float64))
    coupling = v[:, w > 1e-8].T @ curv
    return tangent, curv, scalar, coupling


def irc_branch_curvature_table(grads, masses, hessian, step_size):
    """Rows (scalar_curvature, coupling...) for steps 1..S-1 of one IRC
    branch, from its per-step Cartesian gradients (S,N,3), the atomic
    masses and the Cartesian TS Hessian (g_mw = g/sqrt(m),
    H_mw = M^-1/2 H M^-1/2)."""
    g = np.asarray(grads, dtype=np.float64)
    s = g.shape[0]
    sm = np.repeat(np.sqrt(np.asarray(masses, dtype=np.float64)), 3)
    g_mw = g.reshape(s, -1) / sm[None, :]
    h_mw = np.asarray(hessian, dtype=np.float64) / sm[:, None] / sm[None, :]
    rows = []
    for i in range(1, s):
        _, _, scalar, coupling = irc_curvature_properties(
            g_mw[i], g_mw[i - 1], h_mw, step_size)
        rows.append(np.concatenate([[scalar], coupling]))
    return np.asarray(rows)


def path_bending_angles(mw_path):
    """Bending angle (degrees) at each interior point of a mass-weighted
    path: the angle between its backward and forward displacements."""
    p = np.asarray(mw_path, dtype=np.float64).reshape(len(mw_path), -1)
    angles = []
    for i in range(1, len(p) - 1):
        u = p[i - 1] - p[i]
        v = p[i + 1] - p[i]
        denom = np.linalg.norm(u) * np.linalg.norm(v)
        if denom < 1e-300:
            angles.append(0.0)
            continue
        c = np.clip(np.dot(u, v) / denom, -1.0, 1.0)
        angles.append(float(np.degrees(np.arccos(c))))
    return np.asarray(angles)


def irc_curvature(path):
    """Discrete curvature |x''(s)| along a path (S, ...): central
    differences on the arc-length-parametrized points."""
    p = np.asarray(path).reshape(len(path), -1)
    seg = np.linalg.norm(np.diff(p, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    curv = np.zeros(len(p))
    for i in range(1, len(p) - 1):
        h1, h2 = s[i] - s[i - 1], s[i + 1] - s[i]
        if h1 < 1e-12 or h2 < 1e-12:
            continue
        d2 = 2.0 * (h1 * p[i + 1] - (h1 + h2) * p[i] + h2 * p[i - 1]) / (
            h1 * h2 * (h1 + h2))
        curv[i] = np.linalg.norm(d2)
    return curv
