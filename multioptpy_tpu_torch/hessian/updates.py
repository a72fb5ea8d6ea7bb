"""Quasi-Newton Hessian update rules on batches.

Counterpart of `multioptpy_tpu/hessian/updates.py` with an explicit leading
batch axis: h (B, D, D), s and y (B, D). Every `if denom < eps` guard of the
reference engine is a `where`, so one call updates a whole ensemble. Every
rule returns delta_H with H_new = H + delta_H.

References: FSB/Bofill: Farkas & Schlegel, JCP 111, 10806 (1999).
MSP: Anglada et al., THEOCHEM 591, 35 (2002). CFD: JCTC 9, 54 (2013).
Double damping: arXiv:2006.08877. Flowchart: Theor Chem Acc 135, 84 (2016).
"""

import torch

from multioptpy_tpu_torch.device import bmv

_DENOM_EPS = 1e-10   # the reference's absolute guard
_REL_EPS = 1e-12     # relative degeneracy threshold
_TINY = 1e-300


def _dot(a, b):
    return (a * b).sum(-1)


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


def _m(cond):
    """(B,) condition -> (B,1,1) for matrix-valued selects."""
    return cond[..., None, None]


def _safe_div(num, den, scale):
    """num/den (num (B,D,D), den (B,)), zero when |den| is degenerate
    relative to its natural scale."""
    ok = den.abs() >= _REL_EPS * scale + _TINY
    return torch.where(_m(ok), num / _m(torch.where(ok, den, 1.0)), 0.0)


def bfgs_delta(h, s, y):
    """delta = y y^T/(y.s) - (H s)(H s)^T/(s.H s); zero as a whole if either
    denominator is degenerate."""
    hs = bmv(h, s)
    sy = _dot(s, y)
    shs = _dot(s, hs)
    ok = ((sy.abs() >= _REL_EPS * _norm(s) * _norm(y) + _TINY)
          & (shs.abs() >= _REL_EPS * _norm(s) * _norm(hs) + _TINY))
    t1 = _outer(y, y) / _m(torch.where(ok, sy, 1.0))
    t2 = _outer(hs, hs) / _m(torch.where(ok, shs, 1.0))
    return torch.where(_m(ok), t1 - t2, 0.0)


def _sr1_delta_from_a(a, s):
    return _safe_div(_outer(a, a), _dot(a, s), _norm(a) * _norm(s))


def sr1_delta(h, s, y):
    """delta = a a^T/(a.s), a = y - H s."""
    return _sr1_delta_from_a(y - bmv(h, s), s)


def psb_delta(h, s, y):
    """Powell symmetric Broyden."""
    a = y - bmv(h, s)
    ss = _dot(s, s)
    ok = ss >= _TINY
    ss_safe = _m(torch.where(ok, ss, 1.0))
    term = (-_m(_dot(a, s)) * _outer(s, s) / ss_safe ** 2
            + (_outer(a, s) + _outer(s, a)) / ss_safe)
    return torch.where(_m(ok), term, 0.0)


def _safe_ratio(num, den):
    """num/den for (B,) values, zero when |den| is degenerate."""
    ok = den.abs() >= _REL_EPS * (den + _TINY) + _TINY
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


def _bofill_const(a, s):
    """phi^2 = (a.s)^2 / ((a.a)(s.s)), (B,)."""
    return _safe_ratio(_dot(a, s) ** 2,
                       _dot(a, a) * _dot(s, s)).clamp(0.0, 1.0)


def fsb_delta(h, s, y, cfd=False):
    """Farkas-Schlegel-Bofill: sqrt(phi^2)-weighted SR1/BFGS mix."""
    a = (2.0 if cfd else 1.0) * (y - bmv(h, s))
    d_sr1 = _sr1_delta_from_a(a, s)
    d_bfgs = bfgs_delta(h, s, y)
    phi = _m(torch.sqrt(_bofill_const(a, s).clamp(0.0, 1.0)))
    return (1.0 - phi) * d_bfgs + phi * d_sr1


def bofill_delta(h, s, y, cfd=False):
    """Bofill: phi^2-weighted SR1/PSB mix."""
    a = (2.0 if cfd else 1.0) * (y - bmv(h, s))
    d_sr1 = _sr1_delta_from_a(a, s)
    d_psb = psb_delta(h, s, y)
    c = _m(_bofill_const(a, s))
    return (1.0 - c) * d_psb + c * d_sr1


def msp_delta(h, s, y):
    """Murtagh-Sargent-Powell: sin^2-weighted SR1/PSB mix."""
    a = y - bmv(h, s)
    d_ms = _sr1_delta_from_a(a, s)
    d_p = psb_delta(h, s, y)
    den = _norm(a) * _norm(s)
    cos_arg = _safe_ratio(_dot(s, a), den).clamp(-1.0, 1.0)
    phi = _m(1.0 - cos_arg ** 2)
    return phi * d_p + (1.0 - phi) * d_ms


def flowchart_delta(h, s, y):
    """Auto-select SR1/BFGS/FSB per step, with the reference's
    z = y - H y convention."""
    z = y - bmv(h, y)
    zs = _safe_ratio(_dot(z, s), _norm(s) * _norm(z))
    ys = _safe_ratio(_dot(y, s), _norm(s) * _norm(y))
    d_sr1 = sr1_delta(h, s, y)
    d_bfgs = bfgs_delta(h, s, y)
    d_fsb = fsb_delta(h, s, y)
    return torch.where(_m(zs < -0.1), d_sr1,
                       torch.where(_m(ys > 0.1), d_bfgs, d_fsb))


def double_damping(s, y, mu2=0.2):
    """Powell damping of y with B = I ("DD step 2"). Returns y_tilde."""
    sy = _dot(s, y)
    ss = _dot(s, s)
    den = ss - sy
    ok = den.abs() >= _DENOM_EPS
    theta2 = torch.where(ok, (1.0 - mu2) * ss / torch.where(ok, den, 1.0),
                         0.1).clamp(0.0, 1.0)[..., None]
    return torch.where((sy < mu2 * ss)[..., None],
                       theta2 * y + (1.0 - theta2) * s, y)


def auto_scale(h, s, y, is_identity):
    """Initial-identity scaling H <- H (y.y)/(y.s) where `is_identity` (B,)."""
    ss = _dot(s, s)
    yy = _dot(y, y)
    ys = _dot(y, s).abs()
    ok = (ss > _TINY) & (yy > _TINY) & (ys > _REL_EPS * torch.sqrt(ss * yy))
    scale = torch.where(ok & is_identity, yy / torch.where(ok, ys, 1.0), 1.0)
    return h * _m(scale)


def pcfd_bofill_delta(h, s, y):
    """Perturbed CFD-Bofill: the CFD-Bofill delta plus 2 P D P with
    P = I - s s^T / |s|^2."""
    d = bofill_delta(h, s, y, cfd=True)
    s2 = _dot(s, s)
    ok = s2 > 1e-300
    eye = torch.eye(s.shape[-1], dtype=s.dtype, device=s.device)
    p = eye - _outer(s, s) / _m(torch.where(ok, s2, 1.0))
    return torch.where(_m(ok), d + 2.0 * (p @ d @ p), d)


UPDATE_RULES = {
    "bfgs": bfgs_delta,
    "bfgs_dd": lambda h, s, y: bfgs_delta(h, s, double_damping(s, y)),
    "sr1": sr1_delta,
    "psb": psb_delta,
    "fsb": fsb_delta,
    "fsb_dd": lambda h, s, y: fsb_delta(h, s, double_damping(s, y)),
    "cfd_fsb": lambda h, s, y: fsb_delta(h, s, y, cfd=True),
    "cfd_fsb_dd": lambda h, s, y: fsb_delta(h, s, double_damping(s, y),
                                            cfd=True),
    "bofill": bofill_delta,
    "cfd_bofill": lambda h, s, y: bofill_delta(h, s, y, cfd=True),
    "pcfd_bofill": pcfd_bofill_delta,
    "msp": msp_delta,
    "flowchart": flowchart_delta,
    "auto": flowchart_delta,
}


def update_hessian(h, s, y, method="auto"):
    """H + delta_H by named rule, symmetrized; h (B,D,D), s and y (B,D)."""
    h_new = h + UPDATE_RULES[method](h, s, y)
    return 0.5 * (h_new + h_new.mT)
