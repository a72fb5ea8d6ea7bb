"""The port's eigensolvers: one planner, one executor, and the f64
helpers built on them.

Counterpart of `multioptpy_tpu/ops/eigh64.py`. Every eigenproblem of the
port reaches a kernel through this module, and nothing else chooses which
kernel runs it, at how many sweeps: `plan` makes that choice from the
call's shape alone, `eigh` opens the solve's `eigh` span and runs what the
plan names. The kernel modules (`ops/jacobi_cuda.py`: K1, the Hopper
Jacobi kernel; `ops/tridiag_cuda.py`: K3, the batched tridiagonal
eigensolver past K1's shared-memory gate; `ops/jacobi.py`: the round-robin
Jacobi) describe their kernels and import nothing of this module.

`eigh_fast`, the reference's `jnp.linalg.eigh`, takes whichever exact
route is faster at the call's shape (`eigh_route`). `seeded_eigh` keeps
the f32-seed + f64 Jacobi polish; its f32 seed is K1 on CUDA, as the TPU
branch used the Pallas kernel. `eigh_solve` and `inv_sqrt_psd` are
`torch.autograd.Function`s whose backward passes are the transposes of
the reference's JVP rules. torch.linalg.eigh is called here alone on the
eigensolver paths, counted as "cusolver" on the card, "cpu" on the CPU;
K1's `launch` and `tridiag_eigh_cuda` count the calls they take
("k1.block", "k1.warp", "k3"), the round-robin Jacobi as "jacobi".
"""

import math

import torch

from multioptpy_tpu_torch.logging_utils import count_eigh, spanned
from multioptpy_tpu_torch.ops.jacobi import (jacobi_eigh, jacobi_sweeps,
                                              pad_to_even, sort_and_trim)
from multioptpy_tpu_torch.ops.jacobi_cuda import jacobi_eigh_cuda, max_dim
from multioptpy_tpu_torch.ops.tridiag_cuda import tridiag_eigh_cuda

# ---------------------------------------------------------------- sweeps

# sweeps the RS-RFO step adds to `jacobi_sweeps_for(D)` for an f64
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
# the K1 sweeps of `seeded_eigh`'s f32 seed
SEED_SWEEPS = 8


def jacobi_sweeps_for(d):
    """The Jacobi sweep count at dimension d, the reference's CPU count;
    it grows logarithmically: 5 + ceil(log2(max(d, 16) / 16)). The K1
    routes add the caller's extra sweeps (`plan`)."""
    return 5 + max(0, math.ceil(math.log2(max(d, 16) / 16.0)))


def rfo_extra_sweeps(dtype):
    """The K1 routes' extra sweeps for an RS-RFO Hessian of `dtype`."""
    return RFO_F64_EXTRA_SWEEPS if dtype == torch.float64 else 1


def k1_sweeps(d, dtype):
    """The sweeps `eigh_fast` gives K1 at dimension d: the f64 RS-RFO
    count (14 at D = 54, 15 at D = 72-104, 13 at D = 28), which converges
    shifted, TR/rot-projected Hessians, the hardest matrices the route
    receives (tests/test_torch_rfo.py pins it)."""
    return jacobi_sweeps_for(d) + rfo_extra_sweeps(dtype)


# ------------------------------------------------------------- crossovers

# the smallest batch from which `eigh_fast` sends a (B, D, D) call to K1,
# by dtype and even D: from there on the wrapper (padding and sort
# included), at `k1_sweeps(D)`, beat torch.linalg.eigh at every batch
# scanned (B = 1, 2, 3, 4, 6, 8, 16; `python3 -m
# multioptpy_tpu_torch.scan_jacobi --crossover` on an H100 80GB HBM3 at
# 700 W, PERF.md section 6). At D <= 32 the kernel won from one matrix on
# (at D = 28 by 5-12 %); at B = 1 cuSOLVER took 0.74 ms at D = 54 against
# the kernel's 0.76, 1.41 against 3.36 at D = 104.
EIGH_MIN_BATCH = {
    torch.float64: {20: 1, 28: 1, 54: 2, 56: 2, 72: 2, 78: 2, 80: 2, 104: 3,
                    120: 6},
    torch.float32: {24: 1, 32: 1},
}
# the smallest batch from which `eigh_fast` sends a (B, D, D) f64 call with
# D past K1's gate to K3, by D: from there on the wrapper beat
# torch.linalg.eigh at every batch scanned (B = 1, 2, 3, 4, 6, 8, 16, 588;
# the same scan). K3 takes the QL chain's time whatever the batch (4.4,
# 11.6, 24.2 and 42.9 ms at B = 1), cuSOLVER about its B = 1 time a matrix
# (1.7, 1.9, 3.0 and 4.0 ms); at 588 K3 took 7.9, 26.1, 86.4 and 174.3 ms
# against 921, 1,019, 1,651 and 2,231.
K3_MIN_BATCH = {
    torch.float64: {122: 4, 200: 8, 294: 16, 392: 16},
}


def b_min(d, dtype, table=None):
    """The smallest batch a kernel takes at D d by `table` (dtype -> D ->
    batch; EIGH_MIN_BATCH if None, K3_MIN_BATCH for K3): the scanned
    entry, between two scanned D the larger of the two; None (no batch
    goes to the kernel) outside the scanned D."""
    table = (EIGH_MIN_BATCH if table is None else table).get(dtype, {})
    if d in table:
        return table[d]
    below = [k for k in table if k < d]
    above = [k for k in table if k > d]
    if not below or not above:
        return None
    return max(table[max(below)], table[min(above)])


def eigh_route(device_type, dtype, d, b, tracks_grad):
    """Where `eigh_fast` sends b matrices of dimension d: "cpu" (LAPACK)
    off the card; on it "k1" where K1 is faster (f32 or f64, even-padded
    D at most `max_dim`, b at least `b_min`), "k3" where K3 is faster
    (past K1's gate: b at least `b_min` by K3_MIN_BATCH, which only f64
    has), else "cusolver". A call whose input autograd tracks keeps
    torch.linalg.eigh's backward."""
    if device_type != "cuda":
        return "cpu"
    if tracks_grad or dtype not in (torch.float32, torch.float64):
        return "cusolver"
    d_even = d + d % 2
    if d_even > max_dim(dtype):
        need, route = b_min(d, dtype, K3_MIN_BATCH), "k3"
    else:
        need, route = b_min(d_even, dtype), "k1"
    return route if need is not None and b >= need else "cusolver"


# ------------------------------------------------------------ the planner

# `eigh_impl`, the eigensolver knob of the RS-RFO step
# (`OptimizeConfig.eigh_impl`, the CLI's `--eigh_impl`, default "xla") and
# of the SQM band (`SQM(eigh_impl=...)`, default "auto"), as its two
# callers read it, by device:
#
#             step: CUDA   step: CPU    band: CUDA   band: CPU
ROUTES = {
    "pallas": ("k1_gated", "jacobi", "k1_gated", "jacobi"),
    "kernel": ("k1_gated", "k1_gated", "k1_gated", "k1_gated"),
    "jacobi": ("jacobi", "jacobi", "eigh_fast", "eigh_fast"),
    "auto": ("eigh_fast", "eigh_fast", "k1_gated", "eigh_fast"),
    "seeded": ("eigh_fast", "eigh_fast", "seeded", "seeded"),
}
# "xla" and any other string: `eigh_fast` everywhere
_FAST = ("eigh_fast",) * 4


def plan(impl, caller, device_type, dtype, d, b, tracks_grad):
    """(route, sweeps) for b matrices of order d of `dtype` on
    `device_type`, which `caller` ("step": the RS-RFO and RS-P-RFO steps;
    "band": the SQM band; "seed": `seeded_eigh`'s f32 seed) solves under
    the knob value `impl` (ROUTES). The caller's sweeps are
    `jacobi_sweeps_for(d)` plus `rfo_extra_sweeps(dtype)` for the step, 1
    for the band; the seed takes SEED_SWEEPS.

    The rules of ROUTES:
    "k1_gated" -- K1 at the caller's sweeps where the even-padded d is at
        most `max_dim(dtype)` (on a CPU tensor its plain version: a CPU
        run that must reproduce a card run uses "kernel"), else
        "eigh_fast". "pallas" is the reference's TPU branch on the card,
        its CPU branch ("jacobi") off it.
    "jacobi" -- the round-robin Jacobi at `jacobi_sweeps_for(d)`.
    "eigh_fast" -- `eigh_route`'s answer, K1 at `k1_sweeps`.
    "seeded" -- `seeded_eigh`.
    A callable impl is called as impl(a, sweeps) at the caller's sweeps
    (route "callable"); the seed reads ("k1_gated", "eigh_fast") whatever
    the knob. Returns a route of `eigh`'s ("k1", "k3", "jacobi",
    "seeded", "callable", "cusolver", "cpu") and its sweeps, None for a
    route that takes none. The two callers read "jacobi", "auto" and
    "seeded" differently (ROADMAP 7.7)."""
    on_card = device_type == "cuda"
    if caller == "seed":
        rule, sweeps = ("k1_gated" if on_card else "eigh_fast"), SEED_SWEEPS
    else:
        extra = {"step": rfo_extra_sweeps(dtype), "band": 1}[caller]
        sweeps = jacobi_sweeps_for(d) + extra
        if callable(impl):
            return "callable", sweeps
        column = (0 if caller == "step" else 2) + (0 if on_card else 1)
        rule = ROUTES.get(impl, _FAST)[column]
    if rule == "jacobi":
        return "jacobi", jacobi_sweeps_for(d)
    if rule == "seeded":
        return "seeded", None
    if rule == "k1_gated" and d + d % 2 <= max_dim(dtype):
        return "k1", sweeps
    route = eigh_route(device_type, dtype, d, b, tracks_grad)
    return route, (k1_sweeps(d, dtype) if route == "k1" else None)


# ----------------------------------------------------------- the executor


def _solve(a, impl, caller):
    route, sweeps = plan(impl, caller, a.device.type, a.dtype, a.shape[-1],
                         math.prod(a.shape[:-2]),
                         torch.is_grad_enabled() and a.requires_grad)
    if route == "callable":
        return impl(a, sweeps)
    if route == "k1":
        return jacobi_eigh_cuda(a, sweeps)
    if route == "k3":
        return tridiag_eigh_cuda(a)
    if route == "jacobi":
        return jacobi_eigh(a, sweeps)
    if route == "seeded":
        return _seeded(a)
    count_eigh(route, a)
    return torch.linalg.eigh(a)


@spanned("eigh")
def eigh(a, impl="xla", caller="step"):
    """Ascending (w, v) of symmetric a (..., D, D), a = v @ diag(w) @ v.T,
    by the route `plan` gives `caller` under the knob value `impl`."""
    return _solve(a, impl, caller)


def eigh_fast(a, polish_sweeps=2):
    """The eigh entry point of the f64 hot paths, ascending (w, v) of
    symmetric a (..., D, D): K1 at `k1_sweeps` where `eigh_route` says
    "k1", K3 where it says "k3", else torch.linalg.eigh."""
    del polish_sweeps
    return eigh(a)


@spanned("eigh")
def seeded_eigh(a, polish_sweeps=2):
    """Eigendecomposition of symmetric f64 a (..., D, D), ascending; returns
    (w, v) with a = v @ diag(w) @ v.T. f32 seed, one Newton
    orthonormalization, then `polish_sweeps` f64 round-robin sweeps."""
    return _seeded(a, polish_sweeps)


def _seeded(a, polish_sweeps=2):
    a, d0, batch_shape = pad_to_even(a)
    d = a.shape[-1]
    dtype = a.dtype
    _, v32 = _solve(a.to(torch.float32), "seeded", "seed")
    v = v32.to(dtype)
    eye = torch.eye(d, dtype=dtype, device=a.device)
    vtv = v.mT @ v
    v = v @ (1.5 * eye - 0.5 * vtv)
    a1 = v.mT @ (a @ v)
    a1 = 0.5 * (a1 + a1.mT)
    a1, v = jacobi_sweeps(a1, v, polish_sweeps)
    return sort_and_trim(torch.diagonal(a1, dim1=-2, dim2=-1), v, d0,
                         batch_shape)


def eigh_deflated(h_proj, p, shift=1e3):
    """Eigendecomposition of a TR/rot-projected symmetric matrix with the
    projected-out block shifted to `shift` (h_proj and I - P commute, so the
    eigenvectors are unchanged) and each eigenvalue restored afterwards.
    Returns (w, v) ascending, projected-out modes back at ~0."""
    eye = torch.eye(h_proj.shape[-1], dtype=h_proj.dtype,
                    device=h_proj.device)
    w, v = eigh_fast(h_proj + shift * (eye - p))
    q = 1.0 - (v * (p @ v)).sum(-2)
    w = w - shift * q
    w, order = torch.sort(w, dim=-1, stable=True)
    v = torch.gather(v, -1, order[..., None, :].expand_as(v))
    return w, v


class _EighSolve(torch.autograd.Function):
    """x = A^-1 b through one eigh of symmetric A. Backward (transpose of
    the reference JVP dx = A^-1 (db - dA x)): b_bar = A^-1 x_bar,
    A_bar = -b_bar x^T."""

    @staticmethod
    def forward(ctx, a, b):
        w, v = eigh_fast(a)
        x = v @ ((v.mT @ b[..., None])[..., 0] / w)[..., None]
        x = x[..., 0]
        ctx.save_for_backward(w, v, x)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        w, v, x = ctx.saved_tensors
        lam = (v @ ((v.mT @ x_bar[..., None])[..., 0] / w)[..., None])[..., 0]
        return -lam[..., :, None] * x[..., None, :], lam


def eigh_solve(a, b):
    """Solve symmetric (possibly indefinite) a @ x = b for vectors b (..., n)
    through one `eigh_fast` factorization; degeneracy-safe derivative."""
    return _EighSolve.apply(a, b)


class _InvSqrtPSD(torch.autograd.Function):
    """S^-1/2 = V w^-1/2 V^T with eigenvalues floored at floor * max(w).
    Backward: the Daleckii-Krein map is self-adjoint, so
    S_bar = V (F * (V^T Y_bar V)) V^T with the cancellation-free Loewner
    matrix F_ij = -1 / (sqrt(w_i) sqrt(w_j) (sqrt(w_i) + sqrt(w_j)))."""

    @staticmethod
    def forward(ctx, s, floor):
        w, v = eigh_fast(s)
        w = torch.maximum(w, floor * w.amax(-1, keepdim=True))
        ctx.save_for_backward(w, v)
        return (v * w[..., None, :] ** -0.5) @ v.mT

    @staticmethod
    def backward(ctx, y_bar):
        w, v = ctx.saved_tensors
        sq = torch.sqrt(w)
        f = -1.0 / (sq[..., :, None] * sq[..., None, :]
                    * (sq[..., :, None] + sq[..., None, :]))
        return v @ (f * (v.mT @ y_bar @ v)) @ v.mT, None


def inv_sqrt_psd(s, floor=1e-12):
    """S^{-1/2} of symmetric PSD matrices (..., n, n) via one eigh."""
    return _InvSqrtPSD.apply(s, floor)


def solve_f64safe(a, b, assume_sym=False):
    """A linear solve; Hopper factorizes f64 natively (the reference's CPU
    branch), so `assume_sym` changes nothing here."""
    del assume_sym
    return torch.linalg.solve(a, b)
