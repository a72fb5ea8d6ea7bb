"""First-order step engines: FIRE family, conjugate gradient, L-BFGS, SD.

Counterpart of `multioptpy_tpu/steppers/first_order.py`. Each engine is
`step(state, gradient, ...) -> (move, new_state)` with the geometry update
x_new = x + move. The vector axis is the last one. FIRE runs on any leading
axes; CG and L-BFGS take a leading batch axis B on the gradient and on every
state field (the reference `vmap`s them), and their first/later branches are
per-row selects.
"""

from typing import NamedTuple

import torch

_EPS = 1e-8


def _dot(a, b):
    return (a * b).sum(-1)


# --------------------------------------------------------------------------
# FIRE family
# --------------------------------------------------------------------------

class FireState(NamedTuple):
    velocity: torch.Tensor  # (..., D)
    dt: torch.Tensor        # (...)
    alpha: torch.Tensor     # (...)
    n_good: torch.Tensor    # (...) int32: consecutive downhill steps


def fire_init(dim, dtype=torch.float64, dt0=0.1, alpha0=0.1, device=None):
    return FireState(
        velocity=torch.zeros((dim,), dtype=dtype, device=device),
        dt=torch.tensor(dt0, dtype=dtype, device=device),
        alpha=torch.tensor(alpha0, dtype=dtype, device=device),
        n_good=torch.tensor(0, dtype=torch.int32, device=device),
    )


def _fire_controls(state, downhill, dt_max, n_acc, f_inc, f_acc, f_dec,
                   alpha_start, dt_min=None):
    """(dt, alpha) after the power check, shared by the three variants."""
    accelerate = downhill & (state.n_good > n_acc)
    shrunk = state.dt * f_dec
    if dt_min is not None:
        shrunk = torch.clamp(shrunk, min=dt_min)
    dt = torch.where(downhill,
                     torch.where(accelerate,
                                 torch.clamp(state.dt * f_inc, max=dt_max),
                                 state.dt),
                     shrunk)
    alpha = torch.where(downhill,
                        torch.where(accelerate, state.alpha * f_acc,
                                    state.alpha),
                        torch.full_like(state.alpha, alpha_start))
    return dt, alpha


def _mix(v, force, alpha):
    vnorm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    fnorm = torch.linalg.vector_norm(force, dim=-1, keepdim=True)
    a = alpha[..., None]
    return (1.0 - a) * v + a * vnorm * force / (fnorm + _EPS)


def fire_step(state, gradient, dt_max=0.8, n_acc=5, f_inc=1.10, f_acc=0.99,
              f_dec=0.50, alpha_start=0.1):
    """One FIRE step (the reference's control constants); the velocity mix
    uses the previous alpha."""
    force = -gradient
    v = state.velocity
    v_mix = _mix(v, force, state.alpha)
    downhill = (v * force).sum(-1) > 0.0
    dt, alpha = _fire_controls(state, downhill, dt_max, n_acc, f_inc, f_acc,
                               f_dec, alpha_start)
    v_new = torch.where(downhill[..., None], v_mix, 0.0) + dt[..., None] * force
    n_good = torch.where(downhill, state.n_good + 1, 0).to(torch.int32)
    return dt[..., None] * v_new, FireState(v_new, dt, alpha, n_good)


def fire2_step(state, gradient, dt_max=0.8, dt_min=0.002, n_acc=5,
               f_inc=1.10, f_acc=0.99, f_dec=0.50, alpha_start=0.1):
    """FIRE 2.0: on uphill power the position is corrected half a step back
    and dt has a floor; the velocity mix uses the new alpha."""
    force = -gradient
    v = state.velocity
    downhill = (v * force).sum(-1) > 0.0
    dt, alpha = _fire_controls(state, downhill, dt_max, n_acc, f_inc, f_acc,
                               f_dec, alpha_start, dt_min=dt_min)
    correction = torch.where(downhill[..., None], 0.0,
                             -0.5 * state.dt[..., None] * v)
    v_new = (torch.where(downhill[..., None], _mix(v, force, alpha), 0.0)
             + dt[..., None] * force)
    n_good = torch.where(downhill, state.n_good + 1, 0).to(torch.int32)
    return (dt[..., None] * v_new + correction,
            FireState(v_new, dt, alpha, n_good))


def abc_fire_step(state, gradient, dt_max=0.8, n_acc=5, f_inc=1.10,
                  f_acc=0.99, f_dec=0.50, alpha_start=0.1):
    """ABC-FIRE: the velocity mix (new alpha) scaled by the bias correction
    1/(1-(1-alpha)^k), k = consecutive downhill steps + 1."""
    force = -gradient
    v = state.velocity
    downhill = (v * force).sum(-1) > 0.0
    dt, alpha = _fire_controls(state, downhill, dt_max, n_acc, f_inc, f_acc,
                               f_dec, alpha_start)
    k = torch.clamp(state.n_good.to(v.dtype) + 1.0, min=1.0)
    bias = 1.0 / torch.clamp(1.0 - (1.0 - alpha) ** k, min=_EPS)
    v_mix = bias[..., None] * _mix(v, force, alpha)
    v_new = torch.where(downhill[..., None], v_mix, 0.0) + dt[..., None] * force
    n_good = torch.where(downhill, state.n_good + 1, 0).to(torch.int32)
    return dt[..., None] * v_new, FireState(v_new, dt, alpha, n_good)


# --------------------------------------------------------------------------
# Conjugate gradient: FR / PR / HS / DY / HZ
# --------------------------------------------------------------------------

class CgState(NamedTuple):
    direction: torch.Tensor      # (B, D) current search direction (descent)
    prev_gradient: torch.Tensor  # (B, D)
    initialized: torch.Tensor    # (B,) bool


def cg_init(dim, dtype=torch.float64, device=None):
    z = torch.zeros((dim,), dtype=dtype, device=device)
    return CgState(z, z.clone(), torch.tensor(False, device=device))


def _cg_beta(variant, g, g_prev, d):
    y = g - g_prev
    if variant == "pr":
        beta = _dot(g, y) / (_dot(g_prev, g_prev) + _EPS)
    elif variant == "fr":
        beta = _dot(g, g) / (_dot(g_prev, g_prev) + _EPS)
    elif variant == "hs":
        beta = _dot(g, y) / (_dot(d, y) + _EPS)
    elif variant == "dy":
        beta = _dot(g, g) / (_dot(d, y) + _EPS)
    elif variant == "hz":  # Hager-Zhang
        dy = _dot(d, y) + _EPS
        beta = _dot(y - 2.0 * d * (_dot(y, y) / dy)[..., None], g) / dy
    else:
        raise ValueError(f"unknown CG variant {variant}")
    return torch.clamp(beta, min=0.0)  # PR+ style restart


def cg_step(state, gradient, variant="pr", delta=1.0):
    """One CG step per row: steepest descent on a row's first call, the
    `variant` direction (restarted when not descent) afterwards."""
    beta = _cg_beta(variant, gradient, state.prev_gradient, state.direction)
    d_new = -gradient + beta[..., None] * state.direction
    descent = _dot(d_new, gradient) < 0.0
    d_new = torch.where(descent[..., None], d_new, -gradient)
    alpha = _dot(gradient, d_new).abs() / (_dot(d_new, d_new) + _EPS)
    later = state.initialized[..., None]
    move = torch.where(later, delta * alpha[..., None] * d_new,
                       delta * -gradient)
    direction = torch.where(later, d_new, -gradient)
    return move, CgState(direction, gradient,
                         torch.ones_like(state.initialized))


# --------------------------------------------------------------------------
# L-BFGS: two-loop recursion over a masked ring of the last M pairs
# --------------------------------------------------------------------------

class LbfgsState(NamedTuple):
    s_hist: torch.Tensor         # (B, M, D)
    y_hist: torch.Tensor         # (B, M, D)
    rho: torch.Tensor            # (B, M)
    count: torch.Tensor          # (B,) int32: pairs stored so far
    prev_geometry: torch.Tensor  # (B, D)
    prev_gradient: torch.Tensor  # (B, D)
    initialized: torch.Tensor    # (B,) bool


def lbfgs_init(dim, history=12, dtype=torch.float64, device=None):
    return LbfgsState(
        s_hist=torch.zeros((history, dim), dtype=dtype, device=device),
        y_hist=torch.zeros((history, dim), dtype=dtype, device=device),
        rho=torch.zeros((history,), dtype=dtype, device=device),
        count=torch.tensor(0, dtype=torch.int32, device=device),
        prev_geometry=torch.zeros((dim,), dtype=dtype, device=device),
        prev_gradient=torch.zeros((dim,), dtype=dtype, device=device),
        initialized=torch.tensor(False, device=device),
    )


def ring_slot(count, m):
    """(B, M) bool: the ring slot count % m of each row."""
    return torch.arange(m, device=count.device) == (count % m)[:, None]


def lbfgs_step(state, geometry_flat, gradient, delta=1.0):
    """Push the row's (s, y) pair when it has history, then the two-loop
    recursion newest to oldest over the valid slots; a row's first step is
    steepest descent."""
    b, m, _ = state.s_hist.shape
    rows = torch.arange(b, device=gradient.device)
    s = geometry_flat - state.prev_geometry
    y = gradient - state.prev_gradient
    sy = _dot(s, y)
    admit = state.initialized & (sy.abs() > 1e-12)
    put = ring_slot(state.count, m) & admit[:, None]
    s_hist = torch.where(put[..., None], s[:, None], state.s_hist)
    y_hist = torch.where(put[..., None], y[:, None], state.y_hist)
    inv_sy = 1.0 / torch.where(sy.abs() > 1e-12, sy, 1.0)
    rho = torch.where(put, inv_sy[:, None], state.rho)
    count = torch.where(admit, state.count + 1, state.count)

    n_avail = torch.clamp(count, max=m)
    ks = torch.arange(m, device=gradient.device)
    slots = (count[:, None] - 1 - ks) % m          # newest first
    mask = ks < n_avail[:, None]

    q = gradient
    alphas = []
    for k in range(m):
        i = slots[:, k]
        a = torch.where(mask[:, k], rho[rows, i] * _dot(s_hist[rows, i], q),
                        0.0)
        q = q - a[:, None] * y_hist[rows, i]
        alphas.append(a)

    last = (count - 1) % m
    y_last = y_hist[rows, last]
    yy = _dot(y_last, y_last)
    gamma = torch.where(
        (n_avail > 0) & (yy > 1e-12),
        (1.0 / torch.clamp(rho[rows, last], min=1e-30))
        / torch.clamp(yy, min=1e-30), 1.0)
    r = torch.clamp(gamma, 1e-3, 1e3)[:, None] * q
    for k in reversed(range(m)):
        i = slots[:, k]
        bk = rho[rows, i] * _dot(y_hist[rows, i], r)
        r = r + torch.where(mask[:, k], alphas[k] - bk, 0.0)[:, None] \
            * s_hist[rows, i]

    move = torch.where(state.initialized[:, None], -delta * r,
                       -delta * gradient)
    return move, LbfgsState(s_hist, y_hist, rho, count, geometry_flat,
                            gradient, torch.ones_like(state.initialized))


# --------------------------------------------------------------------------
# Steepest descent (+ mass-weighted)
# --------------------------------------------------------------------------

def sd_step(gradient, delta=1.0):
    return -delta * gradient


def mwsd_step(gradient, masses3, delta=1.0):
    """Mass-weighted SD: each coordinate scaled by <m>/m_i."""
    w = masses3.mean(-1, keepdim=True) / masses3
    return -delta * w * gradient
