"""Multi-secant (block) quasi-Newton Hessian updates on batches.

Counterpart of `multioptpy_tpu/hessian/block_updates.py`: block
BFGS/SR1/PSB/FSB/Bofill over a sliding window of (s, y) pairs kept as a
ring buffer (B, W, D) with column masking; a window of fewer than two pairs,
or a non-finite block update, falls back to the rank-2 rule per row.

Block forms (S, Y are (D, w) with w valid columns):
  BFGS:  dH = Y (Y^T S)^-1 Y^T - H S (S^T H S)^-1 S^T H
  SR1:   dH = R (R^T S)^-1 R^T,  R = Y - H S
  PSB:   dH = R V^T + V R^T - V (R^T S) V^T,  V = S (S^T S)^-1
"""

from functools import partial
from typing import NamedTuple

import torch

from multioptpy_tpu_torch.hessian.updates import double_damping, update_hessian


class BlockWindow(NamedTuple):
    s_win: torch.Tensor    # (B, W, D)
    y_win: torch.Tensor    # (B, W, D)
    count: torch.Tensor    # (B,) int32 total pairs pushed


def block_window_init(dim, window=8, dtype=torch.float64, device=None):
    return BlockWindow(
        s_win=torch.zeros((window, dim), dtype=dtype, device=device),
        y_win=torch.zeros((window, dim), dtype=dtype, device=device),
        count=torch.tensor(0, dtype=torch.int32, device=device),
    )


def block_window_push(win, s, y):
    w = win.s_win.shape[-2]
    put = (torch.arange(w, device=s.device)
           == (win.count % w)[:, None])[..., None]
    return BlockWindow(
        s_win=torch.where(put, s[:, None], win.s_win),
        y_win=torch.where(put, y[:, None], win.y_win),
        count=win.count + 1,
    )


def _masked_sy(win):
    w = win.s_win.shape[-2]
    n_valid = torch.clamp(win.count, max=w)
    mask = (torch.arange(w, device=n_valid.device)
            < n_valid[:, None]).to(win.s_win.dtype)
    s = win.s_win * mask[..., None]   # zero rows for unused slots
    y = win.y_win * mask[..., None]
    return s.mT, y.mT, mask           # (B, D, W)


def _solve(a, b):
    """A batched LU solve without the error check (and its device sync): a
    singular system gives non-finite values, as the reference's solve does,
    and the caller's finiteness test falls back."""
    return torch.linalg.solve_ex(a, b)[0]


def _reg_solve(a, b, eps=1e-10):
    """Solve a x = b with Tikhonov regularisation scaled to a's magnitude."""
    w = a.shape[-1]
    scale = torch.clamp(a.abs().amax((-2, -1)), min=1e-30)
    eye = torch.eye(w, dtype=a.dtype, device=a.device)
    return _solve(a + eps * scale[:, None, None] * eye, b)


def block_bfgs_delta(h, win):
    s, y, _ = _masked_sy(win)
    yts = y.mT @ s
    yts = 0.5 * (yts + yts.mT)     # symmetrized multisecant condition
    hs = h @ s
    shs = s.mT @ hs
    return y @ _reg_solve(yts, y.mT) - hs @ _reg_solve(shs, hs.mT)


def block_sr1_delta(h, win):
    s, y, _ = _masked_sy(win)
    r = y - h @ s
    rts = r.mT @ s
    rts = 0.5 * (rts + rts.mT)
    return r @ _reg_solve(rts, r.mT)


def block_psb_delta(h, win):
    s, y, _ = _masked_sy(win)
    r = y - h @ s
    sts = s.mT @ s
    eye = torch.eye(sts.shape[-1], dtype=s.dtype, device=s.device)
    v = s @ _reg_solve(sts, eye.expand_as(sts))
    rv = r @ v.mT
    return rv + rv.mT - v @ (r.mT @ s) @ v.mT


def _phi2_aggregate(h, win, cfd=False):
    """Aggregated Bofill constant over the flattened window, (B,)."""
    s, y, _ = _masked_sy(win)
    fac = 2.0 if cfd else 1.0
    r = (fac * (y - h @ s)).flatten(1)
    sf = s.flatten(1)
    num = (r * sf).sum(-1) ** 2
    den = (r * r).sum(-1) * (sf * sf).sum(-1)
    phi2 = torch.where(den > 1e-30, num / torch.clamp(den, min=1e-30), 0.0)
    return torch.clamp(phi2, 0.0, 1.0)


def _phi2_per_pair_mean(h, win, cfd=False):
    """Mean of the per-pair Bofill constants over the valid window, (B,)."""
    s, y, mask = _masked_sy(win)                      # (B, D, W)
    fac = 2.0 if cfd else 1.0
    r = fac * (y - h @ s)
    num = (r * s).sum(-2) ** 2                        # (B, W)
    den = (r * r).sum(-2) * (s * s).sum(-2)
    phi2 = torch.where((mask > 0) & (den > 1e-30),
                       num / torch.clamp(den, min=1e-30), 0.0)
    phi2 = torch.clamp(phi2, 0.0, 1.0)
    return phi2.sum(-1) / torch.clamp(mask.sum(-1), min=1.0)


def block_fsb_delta(h, win, cfd=False, weighted=False):
    """phi-mixed block SR1/BFGS; phi = sqrt of the aggregated Bofill
    constant (plain) or of the per-pair mean ('weighted'); cfd doubles the
    residual in the weight."""
    phi2 = (_phi2_per_pair_mean(h, win, cfd) if weighted
            else _phi2_aggregate(h, win, cfd))
    phi = torch.sqrt(phi2)[:, None, None]
    return (1.0 - phi) * block_bfgs_delta(h, win) + phi * block_sr1_delta(
        h, win)


def block_bofill_delta(h, win, cfd=False, weighted=False):
    phi2 = (_phi2_per_pair_mean(h, win, cfd) if weighted
            else _phi2_aggregate(h, win, cfd))[:, None, None]
    return (1.0 - phi2) * block_psb_delta(h, win) + phi2 * block_sr1_delta(
        h, win)


_BLOCK_RULES = {
    "block_bfgs": block_bfgs_delta,
    "block_sr1": block_sr1_delta,
    "block_psb": block_psb_delta,
    "block_fsb": block_fsb_delta,
    "block_cfd_fsb": partial(block_fsb_delta, cfd=True),
    "block_fsb_weighted": partial(block_fsb_delta, weighted=True),
    "block_cfd_fsb_weighted": partial(block_fsb_delta, cfd=True,
                                      weighted=True),
    "block_bofill": block_bofill_delta,
    "block_cfd_bofill": partial(block_bofill_delta, cfd=True),
    "block_bofill_weighted": partial(block_bofill_delta, weighted=True),
    "block_cfd_bofill_weighted": partial(block_bofill_delta, cfd=True,
                                         weighted=True),
}


def block_update_hessian(h, win, s, y, method="block_fsb"):
    """Push (s, y) and apply the block rule; rows whose window holds < 2
    pairs take the rank-2 rule. A `_dd` suffix double-damps the pair before
    the push. h (B, D, D), s and y (B, D). Returns (h_new, win_new)."""
    if method.endswith("_dd") and method not in _BLOCK_RULES:
        y = double_damping(s, y)
        method = method[: -len("_dd")]
    win = block_window_push(win, s, y)
    h_block = h + _BLOCK_RULES[method](h, win)
    h_block = 0.5 * (h_block + h_block.mT)
    rank2 = method.replace("block_", "").replace("_weighted", "")
    h_rank2 = update_hessian(h, s, y, rank2)
    use_block = (win.count >= 2) & torch.isfinite(h_block).all(-1).all(-1)
    return torch.where(use_block[:, None, None], h_block, h_rank2), win
