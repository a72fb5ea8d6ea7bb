"""First-order step engines: FIRE.

Counterpart of the FIRE part of `multioptpy_tpu/steppers/first_order.py`
(`FireState`, `fire_init`, `fire_step`); FIRE2, ABC-FIRE, L-BFGS, CG and SD
arrive with ROADMAP Queue 1 item 9. `step(state, gradient) -> (move,
new_state)`, with the geometry update x_new = x + move. The vector axis is
the last one; leading axes (if any) are independent members.
"""

from typing import NamedTuple

import torch

_EPS = 1e-8


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


def fire_step(state, gradient, dt_max=0.8, n_acc=5, f_inc=1.10, f_acc=0.99,
              f_dec=0.50, alpha_start=0.1):
    """One FIRE step (the reference's control constants)."""
    force = -gradient
    v = state.velocity
    vnorm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    fnorm = torch.linalg.vector_norm(force, dim=-1, keepdim=True)
    a = state.alpha[..., None]
    v_mix = (1.0 - a) * v + a * vnorm * force / (fnorm + _EPS)

    power = (v * force).sum(-1)
    downhill = power > 0.0
    accelerate = downhill & (state.n_good > n_acc)

    dt = torch.where(downhill,
                     torch.where(accelerate,
                                 torch.clamp(state.dt * f_inc, max=dt_max),
                                 state.dt),
                     state.dt * f_dec)
    alpha = torch.where(downhill,
                        torch.where(accelerate, state.alpha * f_acc,
                                    state.alpha),
                        torch.full_like(state.alpha, alpha_start))
    v_new = torch.where(downhill[..., None], v_mix, 0.0) + dt[..., None] * force
    n_good = torch.where(downhill, state.n_good + 1, 0).to(torch.int32)

    move = dt[..., None] * v_new
    return move, FireState(v_new, dt, alpha, n_good)
