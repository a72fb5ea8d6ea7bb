"""ML-style steppers: Adam, AdaBelief, RAdam and Eve, on batches.

Counterpart of `multioptpy_tpu/steppers/ml.py`. The reference wraps optax
transformations; here `adam`, `adabelief` and `radam` are written out with
optax 0.2.6's formulas and defaults (moments, bias correction, eps, eps_root,
the RAdam rectification threshold) followed by the learning-rate scale.
Every state field has a leading batch axis B.

The reference lists six more names (`OPTAX_STEPPERS`). Its `optax_step`
calls `tx.update` without `params`, so those six raise at their first step
(ROADMAP Queue 3, F4); here they parse, and their step raises a ValueError
naming F4. Passing the geometry as `params` would give them weight decay
toward the coordinate origin, which is not a choice a port makes.
"""

from typing import NamedTuple

import torch

OPTAX_STEPPERS = ("adam", "adabelief", "radam", "lars", "lamb", "lion",
                  "adamw", "prodigy", "lookahead_adam")
PORTED_OPTAX = ("adam", "adabelief", "radam")

# optax 0.2.6 defaults: (b1, b2, eps, eps_root)
_DEFAULTS = {"adam": (0.9, 0.999, 1e-8, 0.0),
             "adabelief": (0.9, 0.999, 1e-16, 1e-16),
             "radam": (0.9, 0.999, 1e-8, 0.0)}
_RADAM_THRESHOLD = 5.0


class OptaxState(NamedTuple):
    count: torch.Tensor   # (B,) int32
    mu: torch.Tensor      # (B, D) first moment
    nu: torch.Tensor      # (B, D) second (AdaBelief: central) moment


def _f4(name):
    return ValueError(
        f"optax stepper '{name}': the reference's optax_step calls "
        "tx.update without params, so this rule raises at its first step "
        "there; the port keeps that (ROADMAP Queue 3, F4)")


def optax_init(name, dim, lr=0.05, dtype=torch.float64, device=None):
    if name not in OPTAX_STEPPERS:
        raise ValueError(f"unknown optax stepper '{name}'")
    del lr
    z = torch.zeros((dim,), dtype=dtype, device=device)
    return OptaxState(torch.tensor(0, dtype=torch.int32, device=device), z,
                      z.clone())


def _bias_correction(moment, decay, count):
    """moment / (1 - decay**count), the power taken in float64 and cast to
    the moment's dtype (optax's `tree_bias_correction`)."""
    bc = 1.0 - decay ** count.to(torch.float64)
    return moment / bc.to(moment.dtype)[..., None]


def optax_step(name, state, gradient, lr=0.05):
    """-> (move, new_state), move a displacement (x + move)."""
    if name not in PORTED_OPTAX:
        raise _f4(name)
    b1, b2, eps, eps_root = _DEFAULTS[name]
    g = gradient
    mu = (1 - b1) * g + b1 * state.mu
    if name == "adabelief":
        nu = (1 - b2) * (g - mu) ** 2 + b2 * state.nu + eps_root
    else:
        nu = (1 - b2) * g ** 2 + b2 * state.nu
    count = state.count + 1
    mu_hat = _bias_correction(mu, b1, count)
    nu_hat = _bias_correction(nu, b2, count)
    if name == "adabelief":
        updates = mu_hat / (torch.sqrt(nu_hat) + eps)
    else:
        updates = mu_hat / (torch.sqrt(nu_hat + eps_root) + eps)
    if name == "radam":
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = b2 ** count.to(torch.float64)
        ro = ro_inf - 2 * count.to(torch.float64) * b2t / (1 - b2t)
        r = torch.sqrt(torch.clamp((ro - 4.0) * (ro - 2.0) * ro_inf
                                   / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro),
                                   min=0.0))
        updates = torch.where((ro >= _RADAM_THRESHOLD)[..., None],
                              r.to(g.dtype)[..., None] * updates, mu_hat)
    return -lr * updates, OptaxState(count, mu, nu)


class EveState(NamedTuple):
    """Eve: Adam moments plus the energy-feedback scale d_tilde that shrinks
    the step when the objective stagnates."""
    m: torch.Tensor             # (B, D)
    v: torch.Tensor             # (B, D)
    d_tilde: torch.Tensor       # (B,)
    count: torch.Tensor         # (B,) int32
    prev_energy: torch.Tensor   # (B,)


def eve_init(dim, dtype=torch.float64, device=None):
    z = torch.zeros((dim,), dtype=dtype, device=device)
    return EveState(z, z.clone(), torch.tensor(1.0, dtype=dtype,
                                                device=device),
                    torch.tensor(0, dtype=torch.int32, device=device),
                    torch.tensor(0.0, dtype=dtype, device=device))


def eve_step(state, gradient, energy, delta=0.03, beta_m=0.9, beta_v=0.999,
             beta_d=0.999, c=10.0, eps=1e-12):
    """One Eve move; a row's first step skips the d-feedback."""
    count = state.count + 1
    m = beta_m * state.m + (1.0 - beta_m) * gradient
    v = beta_v * state.v + (1.0 - beta_v) * gradient ** 2
    t = count.to(gradient.dtype)[..., None]
    m_hat = m / (1.0 - beta_m ** t)
    v_hat = v / (1.0 - beta_v ** t)
    denom = torch.minimum(energy.abs(), state.prev_energy.abs()) + eps
    d_hat = torch.clamp((energy - state.prev_energy).abs() / denom, 1.0 / c,
                        c)
    d_tilde_new = beta_d * state.d_tilde + (1.0 - beta_d) * d_hat
    d_tilde = torch.where(count > 1, d_tilde_new, state.d_tilde)
    move = -(delta / d_tilde)[..., None] * m_hat / (torch.sqrt(v_hat) + eps)
    return move, EveState(m, v, d_tilde, count, energy.to(gradient.dtype))
