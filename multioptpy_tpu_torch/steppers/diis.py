"""DIIS geometry extrapolation (the GDIIS family) on batches.

Counterpart of `multioptpy_tpu/steppers/diis.py`: GDIIS, GEDIIS, KDIIS,
EDIIS, ADIIS and C2DIIS as state machines over ring-buffer histories with a
leading batch axis B on every field, applied by the driver on top of the
quasi-Newton step. The fixed-trip loops (the masked Gram-Schmidt of KDIIS,
the 400 exponentiated-gradient iterations of `_simplex_qp`) are Python
loops of batched operations; the restarts of `_simplex_qp` are a tensor
axis.

GDIIS: with histories {x_k} and error vectors {e_k} (quasi-Newton steps),
find c minimizing |sum c_k e_k|^2 subject to sum c = 1, then
x* = sum c_k x_k + sum c_k e_k; the plain step is kept where the system is
unusable or the extrapolated move too long.
"""

from typing import NamedTuple

import torch

from multioptpy_tpu_torch.ops.eigh64 import eigh_fast
from multioptpy_tpu_torch.steppers.first_order import ring_slot


def _dot(a, b):
    return (a * b).sum(-1)


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


def _solve(a, b):
    """Batched LU solve without the error check: a singular system gives
    non-finite values, which `_safeguard` rejects, as with the reference's
    solve."""
    return torch.linalg.solve_ex(a, b)[0]


def _push(hist, value, slot_mask):
    """Write value (B, ...) into the ring slot marked by slot_mask (B, M)."""
    m = slot_mask.reshape(*slot_mask.shape, *([1] * (hist.ndim - 2)))
    return torch.where(m, value[:, None], hist)


def _combine(c, hist):
    """sum_k c_k hist_k per row: c (B, M), hist (B, M, D)."""
    return (c[..., None] * hist).sum(-2)


class DiisState(NamedTuple):
    x_hist: torch.Tensor   # (B, M, D)
    e_hist: torch.Tensor   # (B, M, D)
    count: torch.Tensor    # (B,) int32


def diis_init(dim, history=5, dtype=torch.float64, device=None):
    z = torch.zeros((history, dim), dtype=dtype, device=device)
    return DiisState(z, z.clone(),
                     torch.tensor(0, dtype=torch.int32, device=device))


def _valid(count, m, dtype):
    n_avail = torch.clamp(count, max=m)
    vbool = torch.arange(m, device=count.device) < n_avail[:, None]
    return n_avail, vbool, vbool.to(dtype)


def _bordered_diis_coefficients(e_hist, vmask):
    """Solve [B 1; 1 0][c; lam] = [0; 1] over the valid history slots
    (vmask (B, M) of 0/1). Returns (B, M) coefficients."""
    b_, m, _ = e_hist.shape
    dtype = e_hist.dtype
    bmat = e_hist @ e_hist.mT
    scale = torch.clamp(bmat.abs().amax((-2, -1)), min=1e-30)[:, None, None]
    eye = torch.eye(m, dtype=dtype, device=e_hist.device)
    bmat = (bmat * vmask[:, :, None] * vmask[:, None, :]
            + torch.diag_embed(1.0 - vmask) * scale)
    big = e_hist.new_zeros((b_, m + 1, m + 1))
    big[:, :m, :m] = bmat + 1e-10 * scale * eye
    big[:, :m, m] = vmask
    big[:, m, :m] = vmask
    rhs = e_hist.new_zeros((b_, m + 1))
    rhs[:, m] = 1.0
    return _solve(big, rhs)[:, :m] * vmask


def _safeguard(move_diis, plain_step, n_avail, max_step_ratio, min_points=2):
    """The plain step where DIIS is unusable: too few points, a non-finite
    move, or one longer than max_step_ratio plain steps."""
    ok = ((n_avail >= min_points)
          & torch.isfinite(move_diis).all(-1)
          & (_norm(move_diis) <= max_step_ratio * _norm(plain_step) + 1e-30))
    return torch.where(ok[:, None], move_diis, plain_step)


def gdiis_step(state, x, error, plain_step, max_step_ratio=3.0):
    """Push (x, e) and return (move, new_state). error: the quasi-Newton
    step at the current point; plain_step: the fallback move."""
    m = state.x_hist.shape[-2]
    slot = ring_slot(state.count, m)
    x_hist = _push(state.x_hist, x, slot)
    e_hist = _push(state.e_hist, error, slot)
    count = state.count + 1
    n_avail, _, vmask = _valid(count, m, x.dtype)
    c = _bordered_diis_coefficients(e_hist, vmask)
    x_star = _combine(c, x_hist) + _combine(c, e_hist)
    move = _safeguard(x_star - x, plain_step, n_avail, max_step_ratio)
    return move, DiisState(x_hist, e_hist, count)


class GediisState(NamedTuple):
    x_hist: torch.Tensor       # (B, M, D)
    e_hist: torch.Tensor       # (B, M, D) quasi-Newton steps (DIIS errors)
    g_hist: torch.Tensor       # (B, M, D) gradients (for EDIIS)
    energy_hist: torch.Tensor  # (B, M)
    count: torch.Tensor        # (B,) int32
    score_e: torch.Tensor      # (B,) EDIIS success counter
    score_g: torch.Tensor      # (B,) GDIIS success counter
    prev_energy: torch.Tensor  # (B,)
    prev_gnorm: torch.Tensor   # (B,)


def gediis_init(dim, history=5, dtype=torch.float64, device=None):
    z = torch.zeros((history, dim), dtype=dtype, device=device)

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)

    return GediisState(z, z.clone(), z.clone(),
                       torch.zeros((history,), dtype=dtype, device=device),
                       torch.tensor(0, dtype=torch.int32, device=device),
                       scalar(0.0), scalar(0.0), scalar(float("inf")),
                       scalar(float("inf")))


def _push_gediis_history(state, x, grad, energy, plain_step):
    """Ring-buffer insert shared by the GEDIIS/EDIIS/ADIIS/C2DIIS engines."""
    slot = ring_slot(state.count, state.x_hist.shape[-2])
    return state._replace(
        x_hist=_push(state.x_hist, x, slot),
        e_hist=_push(state.e_hist, plain_step, slot),
        g_hist=_push(state.g_hist, grad, slot),
        energy_hist=_push(state.energy_hist, energy, slot),
        count=state.count + 1)


def gediis_step(state, x, energy, grad, plain_step, max_step_ratio=3.0):
    """GEDIIS: a blend of the GDIIS and EDIIS extrapolations with the weight
    w_EDIIS = clip(0.3 + 0.4 score_ratio + 0.3 phase, 0.2, 0.8); the
    counters rise when their own signal (energy for EDIIS, gradient norm for
    GDIIS) improved, and phase decays over the first 20 iterations. A blend
    that does not descend takes the plain step."""
    pushed = _push_gediis_history(state, x, grad, energy, plain_step)
    m = state.x_hist.shape[-2]
    dtype = x.dtype
    n_avail, vbool, vmask = _valid(pushed.count, m, dtype)
    c_g = _bordered_diis_coefficients(pushed.e_hist, vmask)
    move_gdiis = _combine(c_g, pushed.x_hist) + _combine(c_g, pushed.e_hist) - x
    c_e = ediis_coefficients(pushed.energy_hist, pushed.x_hist,
                             pushed.g_hist, vbool)
    move_ediis = _combine(c_e, pushed.x_hist) + _combine(c_e, pushed.e_hist) - x

    gnorm = _norm(grad)
    score_e = torch.where(energy < state.prev_energy, state.score_e + 1.0,
                          torch.clamp(state.score_e - 1.0, min=0.0))
    score_g = torch.where(gnorm < state.prev_gnorm, state.score_g + 1.0,
                          torch.clamp(state.score_g - 1.0, min=0.0))
    raw = score_e / (score_e + score_g + 1.0)
    phase = torch.clamp((20.0 - pushed.count.to(dtype)) / 20.0, 0.0, 1.0)
    w_e = torch.clamp(0.3 + 0.4 * raw + 0.3 * phase, 0.2, 0.8)[:, None]
    move = w_e * move_ediis + (1.0 - w_e) * move_gdiis
    move = torch.where((_dot(move, grad) < 0.0)[:, None], move, plain_step)
    move = _safeguard(move, plain_step, n_avail, max_step_ratio)
    return move, pushed._replace(score_e=score_e, score_g=score_g,
                                 prev_energy=energy.to(dtype),
                                 prev_gnorm=gnorm)


class KdiisState(NamedTuple):
    x_hist: torch.Tensor   # (B, M, D)
    g_hist: torch.Tensor   # (B, M, D)
    count: torch.Tensor    # (B,) int32


def kdiis_init(dim, history=6, dtype=torch.float64, device=None):
    z = torch.zeros((history, dim), dtype=dtype, device=device)
    return KdiisState(z, z.clone(),
                      torch.tensor(0, dtype=torch.int32, device=device))


def kdiis_step(state, x, grad, plain_step, reg=1e-8, max_step_ratio=3.0):
    """Krylov-DIIS: a projected Newton step in the subspace of the masked
    Gram-Schmidt basis of [g, dg_1, ..., dg_{M-1}] (newest first), its
    Hessian a regularized least-squares fit to all secant pairs, blended
    with geometry DIIS (gradients as errors) and the plain step by their
    descent alignment."""
    b_, m, _ = state.x_hist.shape
    dtype = x.dtype
    dev = x.device
    slot_idx = state.count % m
    slot = ring_slot(state.count, m)
    x_hist = _push(state.x_hist, x, slot)
    g_hist = _push(state.g_hist, grad, slot)
    count = state.count + 1
    n_avail, _, vmask = _valid(count, m, dtype)

    order = (slot_idx[:, None] - torch.arange(m, device=dev)) % m   # (B, M)
    rows = torch.arange(b_, device=dev)[:, None]
    x_ord = x_hist[rows, order]
    g_ord = g_hist[rows, order]
    pair_valid = (torch.arange(m - 1, device=dev)
                  < (n_avail - 1)[:, None]).to(dtype)
    dx = (x_ord[:, :-1] - x_ord[:, 1:]) * pair_valid[..., None]
    dg = (g_ord[:, :-1] - g_ord[:, 1:]) * pair_valid[..., None]

    cands = torch.cat([grad[:, None], dg], dim=1)               # (B, M, D)
    cand_valid = torch.cat([torch.ones((b_, 1), dtype=dtype, device=dev),
                            pair_valid], dim=1) > 0
    basis = torch.zeros_like(cands)
    n_basis = torch.zeros(b_, dtype=dtype, device=dev)
    for i in range(m):
        v = cands[:, i]
        proj = (basis @ v[..., None])[..., 0]
        v = v - (proj[..., None] * basis).sum(-2)
        nrm = _norm(v)
        ok = cand_valid[:, i] & (nrm > 1e-10)
        v = torch.where(ok[:, None], v / torch.where(ok, nrm, 1.0)[:, None],
                        0.0)
        basis[:, i] = v
        n_basis = n_basis + ok.to(dtype)

    a = dx @ basis.mT                                           # (B, M-1, M)
    b_s = dg @ basis.mT
    eye = torch.eye(m, dtype=dtype, device=dev)
    h_proj = _solve(a.mT @ a + reg * eye, a.mT @ b_s).mT        # (B, M, M)
    h_proj = 0.5 * (h_proj + h_proj.mT)
    shift = torch.clamp(1e-3 - torch.linalg.eigvalsh(h_proj).amin(-1),
                        min=0.0)
    g_proj = (basis @ grad[..., None])[..., 0]
    s_proj = _solve(h_proj + shift[:, None, None] * eye, -g_proj)
    step_krylov = (s_proj[..., None] * basis).sum(-2)

    c = _bordered_diis_coefficients(g_hist, vmask)
    step_diis = _combine(c, x_hist) - x

    ghat = grad / (_norm(grad) + 1e-30)[:, None]

    def align(s):
        return _dot(s, -ghat) / (_norm(s) + 1e-30)

    a_k = align(step_krylov)
    a_d = align(step_diis)
    w_k = torch.where((a_k > 0.1) & (n_basis >= 2),
                      torch.clamp(a_k, 0.3, 0.7), 0.0)
    w_d = torch.where((a_d > 0.0) & (n_avail >= 3),
                      0.9 * torch.clamp(a_d, 0.2, 0.8), 0.0) * (1.0 - w_k)
    w_o = torch.clamp(1.0 - w_k - w_d, min=0.0)
    move = (w_o[:, None] * plain_step + w_k[:, None] * step_krylov
            + w_d[:, None] * step_diis)
    move = _safeguard(move, plain_step, n_avail, max_step_ratio, min_points=1)
    return move, KdiisState(x_hist, g_hist, count)


def _simplex_qp(b_mat, lin, n_iter=400, lr=0.5):
    """Minimize c^T lin + 0.5 c^T B c over the probability simplex, per row:
    multi-start exponentiated-gradient descent from the barycentre and the
    M vertex-biased starts (a tensor axis), `n_iter` iterations, the lowest
    objective wins. b_mat (B, M, M), lin (B, M)."""
    b_, m = lin.shape
    dtype = b_mat.dtype
    scale = torch.clamp(lin.abs().amax(-1) + b_mat.abs().amax((-2, -1)),
                        min=1e-12)[:, None, None]
    eye = torch.eye(m, dtype=dtype, device=lin.device)
    starts = torch.cat([torch.full((1, m), 1.0 / m, dtype=dtype,
                                   device=lin.device),
                        0.9 * eye + 0.1 / m], dim=0)        # (S, M)
    c = starts.expand(b_, -1, -1)                           # (B, S, M)
    lin_r = lin[:, None, :]
    for _ in range(n_iter):
        grad_c = (lin_r + c @ b_mat.mT) / scale
        c_new = c * torch.exp(-lr * (grad_c - _dot(c, grad_c)[..., None]))
        c = c_new / c_new.sum(-1, keepdim=True)
    objs = _dot(lin_r, c) + 0.5 * _dot(c @ b_mat.mT, c)     # (B, S)
    best = objs.argmin(-1)
    return c[torch.arange(b_, device=lin.device), best]


def ediis_coefficients(energies, x_hist, g_hist, valid_mask):
    """EDIIS: minimize sum c_i E_i - 0.5 sum_ij c_i c_j (g_i - g_j).(x_i -
    x_j) with c on the simplex; invalid slots get a deterring energy.
    Returns (B, M) coefficients."""
    gx = g_hist @ x_hist.mT
    diag = torch.diagonal(gx, dim1=-2, dim2=-1)
    b = -(diag[..., :, None] + diag[..., None, :] - gx - gx.mT)
    big = energies.abs().amax(-1, keepdim=True) + 1.0
    lin = torch.where(valid_mask, energies, big)
    vm = valid_mask.to(x_hist.dtype)
    return _simplex_qp(b * vm[..., :, None] * vm[..., None, :], lin)


def adiis_coefficients(energies, x_hist, g_hist, valid_mask, x_n=None,
                       g_n=None):
    """ADIIS: the linear term uses gradient-displacement overlaps against
    the latest point (x_n, g_n), (B, D); the last slot when not given."""
    del energies
    x_n = x_hist[:, -1] if x_n is None else x_n
    g_n = g_hist[:, -1] if g_n is None else g_n
    dxh = x_hist - x_n[:, None]
    lin = 2.0 * (dxh @ g_n[..., None])[..., 0]
    b = 2.0 * dxh @ (g_hist - g_n[:, None]).mT
    b = 0.5 * (b + b.mT)
    vm = valid_mask.to(x_hist.dtype)
    big = lin.abs().amax(-1, keepdim=True) + 1.0
    lin = torch.where(valid_mask, lin, big)
    return _simplex_qp(b * vm[..., :, None] * vm[..., None, :], lin)


def c2diis_coefficients(e_hist, valid_mask):
    """C2-DIIS: the eigenvector of the error-overlap matrix with the
    smallest predicted residual, normalized to sum 1. valid_mask (B, M) of
    0/1."""
    bmat = e_hist @ e_hist.mT
    vm = valid_mask.to(e_hist.dtype)
    scale = torch.clamp(bmat.abs().amax((-2, -1)), min=1e-30)[:, None, None]
    bmat = (bmat * vm[..., :, None] * vm[..., None, :]
            + torch.diag_embed(1.0 - vm) * scale * 1e6)
    _, v = eigh_fast(bmat)
    sums = v.sum(-2)                                        # (B, M)
    usable = sums.abs() > 1e-8
    cands = v / torch.where(usable, sums, 1.0)[:, None, :]
    res = torch.einsum("...im,...ij,...jm->...m", cands, bmat, cands)
    res = torch.where(usable, res, float("inf"))
    best = res.argmin(-1)
    return cands[torch.arange(e_hist.shape[0], device=e_hist.device), :, best]


def _simplex_engine(coefficients, state, x, energy, grad, plain_step,
                    max_step_ratio, descent_check=True):
    """Push, interpolate with `coefficients(pushed, n_avail, vbool)` and
    step along the interpolated quasi-Newton step."""
    state = _push_gediis_history(state, x, grad, energy, plain_step)
    n_avail, vbool, _ = _valid(state.count, state.x_hist.shape[-2], x.dtype)
    c = coefficients(state, vbool)
    move = _combine(c, state.x_hist) + _combine(c, state.e_hist) - x
    if descent_check:
        move = torch.where((_dot(move, grad) < 0.0)[:, None], move,
                           plain_step)
    return _safeguard(move, plain_step, n_avail, max_step_ratio), state


def ediis_step(state, x, energy, grad, plain_step, max_step_ratio=3.0):
    """EDIIS as a step engine: simplex-constrained energy interpolation over
    the history, stepped along the interpolated quasi-Newton step. State is
    a GediisState (`gediis_init`)."""
    return _simplex_engine(
        lambda st, vb: ediis_coefficients(st.energy_hist, st.x_hist,
                                          st.g_hist, vb),
        state, x, energy, grad, plain_step, max_step_ratio)


def adiis_step(state, x, energy, grad, plain_step, max_step_ratio=3.0):
    """ADIIS as a step engine, anchored at the current point."""
    return _simplex_engine(
        lambda st, vb: adiis_coefficients(st.energy_hist, st.x_hist,
                                          st.g_hist, vb, x_n=x, g_n=grad),
        state, x, energy, grad, plain_step, max_step_ratio)


def c2diis_step(state, x, energy, grad, plain_step, max_step_ratio=3.0):
    """C2-DIIS as a step engine: eigenvector coefficients over the error
    overlap, extrapolated like GDIIS (no descent check)."""
    return _simplex_engine(
        lambda st, vb: c2diis_coefficients(st.e_hist, vb.to(x.dtype)),
        state, x, energy, grad, plain_step, max_step_ratio,
        descent_check=False)
