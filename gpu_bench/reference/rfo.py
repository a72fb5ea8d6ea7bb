"""The quasi-Newton optimizer step of `optmain`'s default method, rfo_fsb
(minimization), in plain PyTorch, float64: the translation/rotation
projection, the Farkas-Schlegel-Bofill Hessian update, the restricted-step
rational-function step over a grid of alpha values, ratio-based trust-radius
control, the four convergence criteria, and the rejection of an uphill step
with a BFGS update from the failed trial.

`replay` follows the program's run: at every step it works out the next
trial geometry from its own state, compares it with the geometry the
program evaluated next, and then takes that geometry and the program's
energy and gradient there as the step's outcome (the calculator's answers
are compared elsewhere). The Hessian it carries is its own, from its own
exact Hessian at the start, so the program's Hessian never enters it.
"""

import math

import torch

ANGSTROM2BOHR = 1.0 / 0.52917721067
_EPS = 1e-12
_TINY = 1e-300


def _dot(a, b):
    return (a * b).sum(-1)


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


def _mv(a, x):
    return (a @ x[..., None])[..., 0]


def _sym(h):
    return 0.5 * (h + h.mT)


def projector(x):
    """I - Q Q^T (B, 3N, 3N), Q an orthonormal basis of the rigid
    translations and of the rotations about the centroid of x (B, N, 3)."""
    b, n, _ = x.shape
    c = x - x.mean(-2, keepdim=True)
    eye3 = torch.eye(3, dtype=x.dtype, device=x.device)
    trans = eye3[:, None, :].expand(b, 3, n, 3)
    rots = torch.linalg.cross(eye3[None, :, None, :].expand(b, 3, n, 3),
                              c[:, None].expand(b, 3, n, 3), dim=-1)
    basis = torch.cat([trans, rots], 1).reshape(b, 6, 3 * n).mT
    u, s, _ = torch.linalg.svd(basis, full_matrices=False)
    keep = (s > 1e-8 * s[:, :1]).to(x.dtype)
    q = u * keep[:, None, :]
    return torch.eye(3 * n, dtype=x.dtype, device=x.device) - q @ q.mT


def bfgs_delta(h, s, y):
    hs = _mv(h, s)
    sy, shs = _dot(s, y), _dot(s, hs)
    ok = ((sy.abs() >= _EPS * _norm(s) * _norm(y) + _TINY)
          & (shs.abs() >= _EPS * _norm(s) * _norm(hs) + _TINY))
    d = (_outer(y, y) / torch.where(ok, sy, 1.0)[:, None, None]
         - _outer(hs, hs) / torch.where(ok, shs, 1.0)[:, None, None])
    return torch.where(ok[:, None, None], d, 0.0)


def fsb_delta(h, s, y):
    """sqrt(phi^2)-weighted mix of the SR1 and BFGS updates."""
    a = y - _mv(h, s)
    a_s = _dot(a, s)
    ok = a_s.abs() >= _EPS * _norm(a) * _norm(s) + _TINY
    sr1 = torch.where(ok[:, None, None],
                      _outer(a, a) / torch.where(ok, a_s, 1.0)[:, None, None],
                      0.0)
    den = _dot(a, a) * _dot(s, s)
    ok2 = den.abs() >= _EPS * (den + _TINY) + _TINY
    phi2 = torch.where(ok2, a_s ** 2 / torch.where(ok2, den, 1.0), 0.0)
    phi = torch.sqrt(phi2.clamp(0.0, 1.0))[:, None, None]
    return (1.0 - phi) * bfgs_delta(h, s, y) + phi * sr1


def trust_update(trust, actual, predicted, tr_min, tr_max):
    ok = predicted.abs() >= 1e-10
    ratio = torch.where(ok, actual / torch.where(ok, predicted, 1.0), 1.0)
    grown = torch.clamp(trust * 1.2, max=tr_max)
    shrunk = torch.clamp(trust * 0.5, min=tr_min)
    new = torch.where((ratio > 0.75) & (ratio < 2.0), grown,
                      torch.where((ratio < 0.25) | (ratio > 2.0), shrunk,
                                  trust))
    return torch.where(ok, new, trust)


def _leftmost_root(poles, g2, valid, n_iter=80):
    """Smallest root of lam + sum g2 / (poles - lam) over the poles that
    carry gradient, by bisection on a bracket that holds it."""
    gnorm2 = torch.where(valid, g2, 0.0).sum(-1)
    active = valid & (g2 > torch.clamp(1e-10 * gnorm2, min=1e-24)[..., None])
    big = torch.finfo(poles.dtype).max / 4
    hi = torch.clamp(torch.where(active, poles, big).amin(-1), max=0.0)
    lo = hi - (torch.sqrt(gnorm2) + 1.0)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        den = poles - mid[..., None]
        den = torch.where(den.abs() > 1e-30, den, 1e-30)
        neg = mid + torch.where(active, g2 / den, 0.0).sum(-1) < 0.0
        lo, hi = torch.where(neg, mid, lo), torch.where(neg, hi, mid)
    return 0.5 * (lo + hi)


def rs_rfo_step(g, h, trust):
    """The restricted-step RFO step (B, D) for a minimum: the step of
    alpha = 1 if it fits the trust radius, else the longest that fits on a
    log grid of alpha, else the shortest, clipped onto the radius."""
    d, v = torch.linalg.eigh(_sym(h))
    g_t = _mv(v.mT, g)
    valid = d.abs() >= 1e-6
    alphas = torch.cat([torch.ones(1, dtype=g.dtype, device=g.device),
                        10.0 ** torch.linspace(-6.0, 3.0, 23, dtype=g.dtype,
                                               device=g.device)])
    a = alphas[None, :, None]
    poles = d[:, None, :] / a
    gt = g_t[:, None, :] / a
    lam = _leftmost_root(poles, gt * gt, valid[:, None, :])
    den = poles - lam[..., None]
    den = torch.where(den.abs() > 1e-20, den,
                      torch.where(den >= 0, 1e-20, -1e-20).to(den.dtype))
    steps = torch.where(valid[:, None, :], -gt / den, 0.0)      # (B, A, D)
    norms = _norm(steps)
    fits = norms <= trust[:, None]
    pick = torch.where(fits[:, 0], 0, torch.where(
        fits.any(-1), torch.where(fits, norms, -math.inf).argmax(-1),
        norms.argmin(-1)))
    rows = torch.arange(g.shape[0], device=g.device)
    st, sn = steps[rows, pick], norms[rows, pick]
    st = torch.where((sn > trust)[:, None],
                     st * (trust / sn.clamp(min=1e-30))[:, None], st)
    step = _mv(v, st)
    sd = -g * torch.clamp(trust / _norm(g).clamp(min=1e-30), max=1.0)[:, None]
    return torch.where(torch.isfinite(step).all(-1)[:, None], step, sd)


def _masked_rms(v, thresh=1e-10):
    mask = v.abs() > thresh
    return torch.sqrt(torch.where(mask, v * v, 0.0).sum(-1)
                      / mask.sum(-1).clamp(min=1))


def converged(g, move, criteria):
    mf, rf, md, rd = criteria
    max_f, rms_f = g.abs().amax(-1), _masked_rms(g)
    return ((max_f < mf) & (rms_f < rf)
            & (move.abs().amax(-1) < md + torch.clamp(mf - max_f, min=0.0))
            & (_masked_rms(move) < rd + torch.clamp(rf - rms_f, min=0.0)))


def replay(x0, e0, g0, h0, trials, opt):
    """Follow one run of B structures (B, N, 3) from x0 with energies e0 and
    gradients g0 and the reference's own exact Hessian h0 (B, 3N, 3N)
    through the program's evaluated trial points `trials`, a list of
    (x, e, g). Returns the largest |reference trial - program trial|
    (Bohr) of each structure over the steps (B,), and the geometries the
    run ends at (B, N, 3) when each step's outcome is accepted or rejected
    as the reference decides."""
    b, n, _ = x0.shape
    crit = (opt["max_force"], opt["rms_force"], opt["max_displacement"],
            opt["rms_displacement"])
    tr_max = opt["trust_radius_ang"] * ANGSTROM2BOHR
    tr_min = opt["trust_radius_min_ang"] * ANGSTROM2BOHR
    flat = lambda t: t.reshape(b, -1).to(torch.float64)  # noqa: E731
    x, e, g = flat(x0), e0.to(torch.float64), flat(g0)
    px, pe, pg = x, e, g
    h = h0.to(torch.float64)
    trust = torch.full((b,), tr_max, dtype=torch.float64, device=x.device)
    pred = torch.zeros_like(trust)
    it = 0
    conv = torch.zeros(b, dtype=torch.bool, device=x.device)
    gap = torch.zeros_like(trust)
    for xt, et, gt in trials:
        xt, et, gt = flat(xt), et.to(torch.float64), flat(gt)
        p = projector(x.reshape(b, n, 3))
        gp = _mv(p, g)
        s, y = x - px, g - pg
        pair = (it > 0) & (_norm(s) > 1e-12)
        h_upd = torch.where(pair[:, None, None], _sym(h + fsb_delta(h, s, y)),
                            h)
        eye = torch.eye(3 * n, dtype=x.dtype, device=x.device)
        h_eff = _sym(p @ h_upd @ p) + 1e3 * (eye - p)
        trust_new = (trust_update(trust, e - pe, pred, tr_min, tr_max)
                     if it > 0 else trust)
        step = rs_rfo_step(gp, h_eff, trust_new)
        pred_new = _dot(gp, step) + 0.5 * _dot(step, _mv(h_eff, step))
        move = torch.where(conv[:, None], 0.0, step)
        gap = torch.maximum(gap, (x + move - xt).abs().amax(-1))

        move = xt - x                     # the program's trial from here on
        conv_now = converged(gp, move, crit)
        reject = ~conv & ~conv_now & (et > e + 1e-14)
        y_t = gt - g
        ok = torch.isfinite(y_t).all(-1) & (_dot(y_t, move) > 1e-14)
        h_rej = torch.where(ok[:, None, None],
                            _sym(h_upd + bfgs_delta(h_upd, move, y_t)), h_upd)
        keep = lambda old, acc, rej: torch.where(  # noqa: E731
            conv.reshape(-1, *[1] * (old.ndim - 1)), old, torch.where(
                reject.reshape(-1, *[1] * (old.ndim - 1)), rej, acc))
        x, px, e, pe, g, pg, h, trust, pred = (
            keep(x, xt, x), keep(px, x, x), keep(e, et, e),
            keep(pe, e, pe), keep(g, gt, g), keep(pg, g, g),
            keep(h, h_upd, h_rej),
            keep(trust, trust_new, torch.clamp(_norm(move) * 0.25, min=1e-5)),
            keep(pred, pred_new, torch.zeros_like(pred)))
        conv = conv | conv_now
        it += 1
    return gap, x.reshape(b, n, 3)


def _worst(t):
    v = float(t.abs().max()) if t.numel() else 0.0
    return v if math.isfinite(v) else math.inf


def missing(record, steps):
    """Steps reported without an answer of the calculator: a job's record
    holds its start's energy and gradient, its exact Hessian, then one
    evaluation a step."""
    return abs(steps - (len(record) - 2))


def job_gaps(record, result, config, calc_ref, model):
    """The gaps of one job (`spans.SpanCalc` record, the program's result):
    the calculator at every geometry the program evaluated, the exact
    Hessian it started from, and every trial geometry and the final one
    against `replay`'s."""
    (_, x0, e0, g0), (_, xh, h_prog) = record[0], record[1]
    h_ref = calc_ref.hessian(xh, model)
    evals = [r for r in record if r[0] == "eg"]
    xs = torch.cat([r[1] for r in evals])
    e_ref, g_ref = calc_ref.energy_and_gradient(xs, model)
    gap, x_end = replay(x0, e0, g0, h_ref, [r[1:] for r in record[2:]],
                        config["optimizer"])
    end = result.coords.reshape(x_end.shape).double() - x_end
    return {
        "hessian_gap": _worst(h_prog - h_ref),
        "energy_gap": _worst(torch.cat([r[2] for r in evals]).double()
                             - e_ref),
        "gradient_gap": _worst(torch.cat([r[3] for r in evals]).double()
                               - g_ref),
        "step_gap": max(_worst(gap), _worst(end)),
    }
