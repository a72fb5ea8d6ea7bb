"""Restricted-step (image-function) rational-function-optimization steps,
batched.

Counterpart of the RS-RFO part of `multioptpy_tpu/steppers/rfo.py`: one
eigendecomposition per step, the image flip done on (eigenvalues,
gradient components), fixed-trip bisections for the secular equation, and
the trust radius met by a parallel log-grid of alpha values. Where the
reference `vmap`s (over structures, and over the alpha grid) the port
carries explicit tensor axes: gradient (B, D), Hessian (B, D, D), trust
radius (B,), and an alpha axis inside `_rfo_step_grid`.
"""

import math

import torch

_POLE_EPS = 1e-10          # mode participates in the image flip
SMALL_EIGVAL_THRESH = 1e-6  # mode excluded from the step
# sweeps the Jacobi routes add to `jacobi_sweeps_for(D)` for an f64 RS-RFO
# Hessian: TR/rot-projected Hessians with the projected-out block at 1e3
# and clustered soft modes (model Hessians, their quasi-Newton updates)
# converge slowly. Over the 257 RFO Hessians of a reduced flagship AutoTS
# run (Diels-Alder, D = 54) the largest off-diagonal left, relative to
# max|a|, is 8.3e-6 to 3.4e-5 after 8 sweeps (the count the band keeps),
# 2.9e-11 to 4.1e-10 after 12 and below 4e-13 after 13 over three runs,
# one on an H100 and two on CPUs (`python3 -m multioptpy_tpu_torch.flagship`);
# this takes 14 (ROADMAP Queue 3, F3). f32 keeps one extra sweep: its
# rounding floor comes first.
RFO_F64_EXTRA_SWEEPS = 7


def _leftmost_secular_root(poles, g2, valid, n_iter=80):
    """Smallest root of f(lam) = lam + sum_i g2_i / (poles_i - lam) over the
    last axis (any leading axes), by bisection on a guaranteed bracket.
    Poles whose |g_i| carries no signal (<= 1e-5 |g|) do not bound it."""
    dtype = poles.dtype
    gnorm2 = torch.where(valid, g2, 0.0).sum(-1)
    active = valid & (g2 > torch.clamp(1e-10 * gnorm2, min=1e-24)[..., None])
    big = torch.finfo(dtype).max / 4
    p0 = torch.where(active, poles, big).amin(-1)
    b = torch.clamp(p0, max=0.0)
    a = b - (torch.sqrt(gnorm2) + 1.0)

    def f(lam):
        den = poles - lam[..., None]
        safe = torch.where(den.abs() > 1e-30, den, 1e-30)
        return lam + torch.where(active, g2 / safe, 0.0).sum(-1)

    lo, hi = a, b
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        neg = f(mid) < 0.0
        lo, hi = torch.where(neg, mid, lo), torch.where(neg, hi, mid)
    return 0.5 * (lo + hi)


def _rfo_step_components(eigvals, g_t, valid, alpha):
    """Step components in the eigenbasis for scaling parameter alpha (any
    leading axes, broadcast). Returns (step_t, lam)."""
    poles = eigvals / alpha
    gt = g_t / alpha
    lam = _leftmost_secular_root(poles, gt * gt, valid)
    den = poles - lam[..., None]
    safe = torch.where(den.abs() > 1e-20, den,
                       torch.where(den >= 0, 1e-20, -1e-20).to(den.dtype))
    step_t = torch.where(valid, -gt / safe, 0.0)
    return step_t, lam


def _rfo_step_grid(d_im, g_im, valid, trust_radius, alpha0=1.0,
                   alpha_max=1000.0, n_grid=24):
    """Trust-radius restriction over a log-grid of alpha values evaluated
    at once (the grid is a tensor axis): alpha0's step if it fits, else the
    largest-norm step that fits, else the smallest-norm step clipped onto
    the boundary. d_im, g_im, valid (B, D); trust_radius (B,)."""
    dtype = d_im.dtype
    grid = torch.linspace(-6.0, math.log10(alpha_max), n_grid - 1,
                          dtype=dtype, device=d_im.device)
    alphas = torch.cat([torch.full((1,), alpha0, dtype=dtype,
                                   device=d_im.device), 10.0 ** grid])
    step_all, lam_all = _rfo_step_components(
        d_im[:, None, :], g_im[:, None, :], valid[:, None, :],
        alphas[None, :, None])                   # (B, A, D), (B, A)
    norms = torch.linalg.vector_norm(step_all, dim=-1)
    fits = norms <= trust_radius[:, None]
    none_fit = ~fits.any(-1)
    best_fit = torch.where(fits, norms, -math.inf).argmax(-1)
    smallest = norms.argmin(-1)
    idx = torch.where(fits[:, 0], 0, torch.where(none_fit, smallest,
                                                 best_fit))
    step = torch.gather(step_all, 1,
                        idx[:, None, None].expand(-1, 1, step_all.shape[-1])
                        )[:, 0]
    lam = torch.gather(lam_all, 1, idx[:, None])[:, 0]
    sn = torch.gather(norms, 1, idx[:, None])[:, 0]
    scale = trust_radius / sn.clamp(min=1e-30)
    step = torch.where((sn > trust_radius)[:, None], step * scale[:, None],
                       step)
    return step, lam


def jacobi_sweeps_for(d):
    """The Jacobi sweep count `_eigh` uses at dimension d; it grows
    logarithmically: 5 + ceil(log2(max(d, 16) / 16)). The kernel runs one
    more."""
    return 5 + max(0, math.ceil(math.log2(max(d, 16) / 16.0)))


def rfo_extra_sweeps(dtype):
    """The kernel routes' extra sweeps for an RS-RFO Hessian of `dtype`."""
    return RFO_F64_EXTRA_SWEEPS if dtype == torch.float64 else 1


def _eigh(h, impl, extra_sweeps=1):
    """Symmetric eigendecomposition dispatch for batched h (B, D, D), with
    sweeps = `jacobi_sweeps_for(D)`:

    "pallas" -- the Hopper Jacobi kernel (ops/jacobi_cuda.py) on a CUDA
               tensor, in f32 and f64, with sweeps + `extra_sweeps` sweeps
               (one extra: the reference's TPU branch; the RS-RFO step
               asks for `rfo_extra_sweeps`); on a CPU tensor the
               round-robin matmul Jacobi (ops/jacobi.py) with `sweeps` (the
               reference's CPU branch).
    "kernel" -- the kernel's algorithm with sweeps + `extra_sweeps` on
               every device: the kernel on CUDA, its plain version on the
               CPU. A CPU run that must reproduce a card run uses it: at
               the reference's CPU sweep count the Jacobi is not converged
               on shifted, TR/rot-projected Hessians (Diels-Alder RFO step,
               D = 54: off-diagonals above 1e-5 after 7 sweeps; pinned by
               tests/test_torch_rfo.py).
    "jacobi" -- the round-robin matmul Jacobi.
    a callable -- called as impl(h, sweeps + `extra_sweeps`), the kernel
               routes' arguments (`python3 -m multioptpy_tpu_torch.flagship`
               passes one that keeps the matrices).
    anything else -- torch.linalg.eigh."""
    sweeps = jacobi_sweeps_for(h.shape[-1])
    if callable(impl):
        return impl(h, sweeps + extra_sweeps)
    if impl == "kernel" or (impl == "pallas" and h.is_cuda):
        from multioptpy_tpu_torch.ops.jacobi_cuda import jacobi_eigh_auto
        return jacobi_eigh_auto(h, sweeps=sweeps + extra_sweeps)
    if impl == "pallas":
        impl = "jacobi"
    if impl == "jacobi":
        from multioptpy_tpu_torch.ops.jacobi import jacobi_eigh
        return jacobi_eigh(h, sweeps=sweeps)
    return torch.linalg.eigh(h)


def rs_rfo_step(gradient, hessian, trust_radius, saddle_order=0,
                alpha0=1.0, alpha_max=1000.0, n_alpha_iter=40,
                eigh_impl="xla"):
    """One restricted-step image-RFO step for each structure of a batch.

    Parameters
    ----------
    gradient : (B, D) flat gradients (TR/rot-projected by the caller).
    hessian : (B, D, D) symmetric effective Hessians.
    trust_radius : (B,) Bohr.
    saddle_order : seek an n-th order saddle by sign-flipping the n lowest
        non-singular modes (image function).

    Returns
    -------
    step : (B, D), norm <= trust_radius
    aux : dict of (B,) tensors: predicted_energy_change, lambda, step_norm
    """
    del n_alpha_iter   # the grid replaces the sequential alpha bisection
    b, dim = gradient.shape
    eye = torch.eye(dim, dtype=hessian.dtype, device=hessian.device)
    sym = 0.5 * (hessian + hessian.mT)
    # NaN guard: a broken Hessian falls back to identity (steepest descent).
    # Non-finite members are replaced before the solve, which would raise
    # on them (LAPACK) where the reference's eigh returns NaN.
    bad = ~torch.isfinite(sym).all(-1).all(-1)
    d, v = _eigh(torch.where(bad[:, None, None], eye, sym), eigh_impl,
                 rfo_extra_sweeps(sym.dtype))
    bad = bad | ~(torch.isfinite(d).all(-1) & torch.isfinite(v).all((-2, -1)))
    d = torch.where(bad[:, None], 1.0, d)
    v = torch.where(bad[:, None, None], eye, v)

    g_t = (v.mT @ gradient[..., None])[..., 0]

    # image flip of the first saddle_order non-singular modes
    participate = d.abs() > _POLE_EPS
    rank = torch.cumsum(participate.to(torch.int32), dim=-1)
    flip = participate & (rank <= saddle_order)
    sign = torch.where(flip, -1.0, 1.0).to(d.dtype)
    d_im = d * sign
    g_im = g_t * sign

    valid = d.abs() >= SMALL_EIGVAL_THRESH
    step_t, lam = _rfo_step_grid(d_im, g_im, valid, trust_radius,
                                 alpha0, alpha_max)
    step = (v @ step_t[..., None])[..., 0]

    # final NaN guard -> trust-clipped steepest descent
    finite = torch.isfinite(step).all(-1)
    sd = -gradient
    sd_n = torch.linalg.vector_norm(sd, dim=-1)
    sd = torch.where((sd_n > trust_radius)[:, None],
                     sd * (trust_radius / sd_n.clamp(min=1e-30))[:, None], sd)
    step = torch.where(finite[:, None], step, sd)

    predicted = (gradient * step).sum(-1) + 0.5 * (
        step * (hessian @ step[..., None])[..., 0]).sum(-1)
    return step, {"predicted_energy_change": predicted, "lambda": lam,
                  "step_norm": torch.linalg.vector_norm(step, dim=-1)}


def update_trust_radius(trust_radius, actual_change, predicted_change,
                        tr_min=0.01, tr_max=0.5, good=0.75, poor=0.25,
                        increase=1.2, decrease=0.5, overshoot=2.0):
    """Ratio-based trust-radius control with a two-sided accept band,
    elementwise over a batch."""
    ok = predicted_change.abs() >= 1e-10
    ratio = torch.where(ok, actual_change / torch.where(
        ok, predicted_change, 1.0), 1.0)
    grown = torch.clamp(trust_radius * increase, max=tr_max)
    shrunk = torch.clamp(trust_radius * decrease, min=tr_min)
    new = torch.where((ratio > good) & (ratio < overshoot), grown,
                      torch.where((ratio < poor) | (ratio > overshoot),
                                  shrunk, trust_radius))
    return torch.where(ok, new, trust_radius)
