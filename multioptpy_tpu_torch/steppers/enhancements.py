"""Step enhancements on batches: line search, TRIM, scaling, coordinate
locking, mode following, random perturbation, geodesic correction.

Counterpart of `multioptpy_tpu/steppers/enhancements.py`. Each is a
function transforming a proposed move; the vector axis is the last one and
a leading batch axis B runs through every argument. The fixed-trip loops of
the reference (`lax.fori_loop`, `lax.scan`) are Python loops of batched
selects. The eigendecompositions are `eigh_fast` (`torch.linalg.eigh`), the
reference's CPU branch.
"""

import torch

from multioptpy_tpu_torch.ops.eigh64 import eigh_fast


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


def _mv(m, x):
    return (m @ x[..., None])[..., 0]


def backtracking_linesearch(energy_fn, coords, move, e0, g0_flat,
                            n_trials=4, shrink=0.5, c1=1e-4):
    """Armijo backtracking with a fixed trial count: every trial energy is
    evaluated, the largest step satisfying the Armijo condition wins, else
    the smallest trial. energy_fn: (B, N, 3) -> (B,); coords, move
    (B, N, 3); e0 (B,); g0_flat (B, 3N). Returns the scaled move."""
    alphas = shrink ** torch.arange(n_trials, dtype=move.dtype,
                                    device=move.device)
    slope = (g0_flat * move.reshape(move.shape[0], -1)).sum(-1)
    oks = torch.stack([
        energy_fn(coords + a * move) <= e0 + c1 * a * slope for a in alphas],
        dim=-1)                                             # (B, T)
    first = oks.to(torch.int32).argmax(-1)
    alpha = torch.where(oks.any(-1), alphas[first], alphas[-1])
    return alpha.reshape(-1, *([1] * (move.ndim - 1))) * move


def trim_step(gradient, hessian, trust_radius, saddle_order=0):
    """Trust-region image minimization (TRIM, Helgaker): the Newton step
    with a level shift mu found by doubling (40) then bisection (60) so the
    step fits the trust radius; the lowest `saddle_order` modes are
    sign-flipped (image function), and the image zetas are used as they
    are in the eigenbasis. gradient (B, D), hessian (B, D, D),
    trust_radius (B,)."""
    d, v = eigh_fast(0.5 * (hessian + hessian.mT))
    g_t = _mv(v.mT, gradient)
    n = d.shape[-1]
    sign = torch.where(torch.arange(n, device=d.device) < saddle_order,
                       -1.0, 1.0).to(d.dtype)
    d_im = d * sign
    g_im = g_t * sign

    def step_of(mu):
        den = d_im + mu[:, None]
        safe = torch.where(den.abs() > 1e-12, den, torch.where(
            den >= 0, 1e-12, -1e-12).to(den.dtype))
        return -g_im / safe

    mu0 = torch.clamp(-d_im.amin(-1), min=0.0) + 1e-8
    mu_hi = mu0
    for _ in range(40):
        too_big = _norm(step_of(mu_hi)) > trust_radius
        mu_hi = torch.where(too_big, mu_hi * 2.0 + 1e-8, mu_hi)
    lo, hi = mu0, mu_hi
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        too_big = _norm(step_of(mid)) > trust_radius
        lo, hi = torch.where(too_big, mid, lo), torch.where(too_big, hi, mid)
    use_newton = _norm(step_of(mu0)) <= trust_radius
    mu = torch.where(use_newton, mu0, 0.5 * (lo + hi))
    return _mv(v, step_of(mu))


def componentwise_scaling(move, max_component):
    """Clamp every Cartesian component of the move."""
    return torch.clamp(move, -max_component, max_component)


def coordinate_locking(move, lock_mask):
    """Zero the move on locked degrees of freedom; lock_mask: 1 = locked."""
    return move * (1.0 - lock_mask)


def mode_following_direction(hessian, reference_mode=None, index=0):
    """The eigenvector to follow, and its eigenvalue, per structure: by
    |overlap| with `reference_mode` (B, D) if given, else by ascending
    index. hessian (B, D, D) -> ((B, D), (B,))."""
    d, v = eigh_fast(0.5 * (hessian + hessian.mT))
    if reference_mode is None:
        return v[..., index], d[..., index]
    i = _mv(v.mT, reference_mode).abs().argmax(-1)
    rows = torch.arange(d.shape[0], device=d.device)
    return v[rows, :, i], d[rows, i]


def perturb_move(move, generator, magnitude=1e-3):
    """Random perturbation to escape symmetric traps: unit-normal noise
    from the explicit `generator`, scaled per structure to `magnitude`
    times the move's norm. move (B, ...)."""
    noise = torch.randn(move.shape, generator=generator, dtype=move.dtype,
                        device=move.device)
    flat = (move.shape[0], -1)
    scale = magnitude * _norm(move.reshape(flat)) / (
        _norm(noise.reshape(flat)) + 1e-30)
    return move + scale.reshape(-1, *([1] * (move.ndim - 1))) * noise


def geodesic_correct_move(move, coords, internals, n_rk4=16):
    """Re-trace a Cartesian step as a geodesic of the bond metric
    G = B B^T with Christoffel symbols frozen at the starting geometry,
    Gamma[i,j,k] = Ginv[i,k] sum_ab d2q[i,a,b] B[j,b] symmetrized over
    (j,k), integrated by `n_rk4` fixed RK4 steps; the part of the move in
    the null space of B passes through unchanged, and a wandering
    back-transform falls back to the straight step. move (B, 3N), coords
    (B, N, 3); d2q from `torch.func` (forward over forward)."""
    b_, n, _ = coords.shape
    x0 = coords.reshape(b_, 3 * n)
    b = internals.b_matrix(coords)                       # (B, M, 3N)

    def q_one(x_flat):
        return internals.q_flat(x_flat[None])[0]

    d2q = torch.func.vmap(torch.func.jacfwd(torch.func.jacfwd(q_one)))(x0)
    ginv = internals.g_pinv(b @ b.mT)
    s_ij = torch.einsum("...iab,...jb->...ij", d2q, b)
    gamma = torch.einsum("...ik,...ij->...ijk", ginv, s_ij)
    gamma = 0.5 * (gamma + gamma.transpose(-1, -2))

    q = internals.q_flat(x0)
    qd = _mv(b, move)
    dt = 1.0 / n_rk4

    def accel(v):
        return -torch.einsum("...ijk,...j,...k->...i", gamma, v, v)

    for _ in range(n_rk4):
        k1q, k1v = qd, accel(qd)
        k2q, k2v = qd + 0.5 * dt * k1v, accel(qd + 0.5 * dt * k1v)
        k3q, k3v = qd + 0.5 * dt * k2v, accel(qd + 0.5 * dt * k2v)
        k4q, k4v = qd + dt * k3v, accel(qd + dt * k3v)
        q = q + dt / 6.0 * (k1q + 2 * k2q + 2 * k3q + k4q)
        qd = qd + dt / 6.0 * (k1v + 2 * k2v + 2 * k3v + k4v)
    x1 = internals.to_cartesian(q, coords).reshape(b_, 3 * n)
    p_range = b.mT @ (ginv @ b)                 # projector onto range(B^T)
    corrected = (x1 - x0) + (move - _mv(p_range, move))
    ok = (torch.isfinite(corrected).all(-1)
          & (_norm(corrected) < 3.0 * _norm(move) + 1e-12))
    return torch.where(ok[:, None], corrected, move)
