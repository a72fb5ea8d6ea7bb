"""IRC curvature analysis (host-side numpy).

Counterpart of the IRC part of `multioptpy_tpu/analysis/pes.py`: the
per-point curvature properties the euler/rk4 IRC integrators report, the
per-branch table `ircmain` writes, and the path bending angles. The path
embeddings and the convergence analysis arrive with ROADMAP Queue 1 item
15.
"""

import numpy as np


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
