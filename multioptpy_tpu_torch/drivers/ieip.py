"""Double-ended and single-ended TS-search engines: iEIP, dimer, spring
pair.

Counterpart of `multioptpy_tpu/drivers/ieip.py` (iEIP, JCTC 2023,
10.1021/acs.jctc.3c00293; the dimer method, Henkelman & Jonsson JCP 111,
7010). The image pair advances as one batch of 2, so each iteration is one
calculator call over both images; the loops check their stop rule on the
host once an iteration.
"""

import dataclasses
from typing import NamedTuple

import torch

from multioptpy_tpu_torch.device import calc_device, on_device
from multioptpy_tpu_torch.ops import hosteval


@dataclasses.dataclass(frozen=True)
class IEIPConfig:
    engine: str = "eip"            # eip | dimer | spring_pair
    n_steps: int = 300
    step_size: float = 0.05        # Bohr per iteration
    pull_strength: float = 0.05    # image-pair attraction (eip/spring_pair)
    min_pair_distance: float = 0.3  # Bohr: stop when images meet
    dimer_separation: float = 0.01  # dimer half-length
    dimer_rot_step: float = 0.5     # rotation mixing per iteration
    dimer_trans_rate: float = 0.5   # translation rate: the step is rate*F
                                    # clipped to step_size
    fmax: float = 1e-4


class IEIPResult(NamedTuple):
    ts_guess: torch.Tensor
    ts_energy: float
    image_a: torch.Tensor
    image_b: torch.Tensor
    n_iterations: int
    converged: bool


def _perp(v, d_hat):
    return v - (v * d_hat).sum() * d_hat


def ieip(calc, coords_a, coords_b, z, config=IEIPConfig(), bias_engine=None,
         device=None):
    """Run the selected engine from an (A, B) geometry pair (N,3) each, on
    `device` (None means the CUDA card), where `calc` lives."""
    dev = calc_device(calc, device, "the search")
    a = on_device(coords_a, dev)
    b = on_device(coords_b, dev)

    def energy_grad(x):
        """(B,N,3) -> (e (B,), g (B,N,3)), bias included."""
        return hosteval.energy_and_gradient(calc, x, z, bias_engine)

    if config.engine in ("eip", "spring_pair"):
        return _elastic_image_pair(energy_grad, a, b, config)
    if config.engine == "dimer":
        mid = 0.5 * (a + b)
        direction = (b - a) / (torch.linalg.vector_norm(b - a) + 1e-30)
        return _dimer(energy_grad, mid, direction, config)
    raise ValueError(f"unknown iEIP engine '{config.engine}'")


def _clip(f, ds):
    n = torch.linalg.vector_norm(f)
    return torch.where(n > ds, f * ds / n, f)


def _elastic_image_pair(energy_grad, a, b, config):
    """iEIP core: both images relax perpendicular to the pair axis while a
    pulling force closes the gap; the near-meeting midpoint approximates
    the TS."""
    ds = config.step_size
    pull = config.pull_strength
    it = 0
    dist = None
    for it in range(1, config.n_steps + 1):
        _, g = energy_grad(torch.stack([a, b]))
        d = b - a
        dist = torch.linalg.vector_norm(d) + 1e-30
        d_hat = d / dist
        f_a = -_perp(g[0], d_hat) + pull * dist * d_hat
        f_b = -_perp(g[1], d_hat) - pull * dist * d_hat
        a, b = a + _clip(f_a, ds), b + _clip(f_b, ds)
        if float(dist) < config.min_pair_distance:
            break
    mid = 0.5 * (a + b)
    e_mid, g_mid = energy_grad(mid[None])
    dist = float(dist) if dist is not None else float("inf")
    return IEIPResult(
        ts_guess=mid, ts_energy=float(e_mid[0]), image_a=a, image_b=b,
        n_iterations=it,
        converged=(float(torch.linalg.vector_norm(g_mid)) < 10 * config.fmax
                   or dist < config.min_pair_distance))


def _dimer(energy_grad, x0, v0, config):
    """Dimer method: rotate the dimer toward the lowest-curvature mode with
    gradient differences (4 rotations an iteration), then translate by a
    FIRE walk on the effective force: -g + 2(g.v)v where the curvature is
    negative, +(g.v)v where it is positive (climb out along the mode)."""
    dr = config.dimer_separation
    ds = config.step_size
    n_rot = 4

    def step(x, v, vel, dt):
        e0, g0 = energy_grad(x[None])
        g0 = g0[0]
        g_flat = g0.reshape(-1)
        v_flat = v.reshape(-1)
        curv = torch.zeros((), dtype=x.dtype, device=x.device)
        for _ in range(n_rot):
            _, g1 = energy_grad((x + dr * v_flat.reshape(x.shape))[None])
            df = (g1[0] - g0).reshape(-1)
            curv = (df @ v_flat) / dr
            f_rot = -(df - (df @ v_flat) * v_flat)
            v_new = v_flat + config.dimer_rot_step * f_rot / (
                torch.linalg.vector_norm(df) + 1e-10)
            v_flat = v_new / (torch.linalg.vector_norm(v_new) + 1e-30)
        f_eff = torch.where(curv < 0.0,
                            -(g_flat - 2.0 * (g_flat @ v_flat) * v_flat),
                            (g_flat @ v_flat) * v_flat)
        power = f_eff @ vel
        vel = torch.where(power > 0.0, 0.9 * vel + dt * f_eff, dt * f_eff)
        dt = torch.where(power > 0.0, torch.clamp(dt * 1.1, max=2.0),
                         torch.clamp(dt * 0.5, min=0.02))
        move = _clip(vel * config.dimer_trans_rate, ds)
        return (x + move.reshape(x.shape), v_flat.reshape(v.shape), vel, dt,
                g0.abs().max())

    x, v = x0, v0
    vel = torch.zeros(x.numel(), dtype=x.dtype, device=x.device)
    dt = torch.full((), 0.5, dtype=x.dtype, device=x.device)
    it = 0
    converged = False
    for it in range(1, config.n_steps + 1):
        x, v, vel, dt, gmax = step(x, v, vel, dt)
        if float(gmax) < config.fmax:
            converged = True
            break
    e_fin, _ = energy_grad(x[None])
    return IEIPResult(ts_guess=x, ts_energy=float(e_fin[0]),
                      image_a=x - config.dimer_separation * v,
                      image_b=x + config.dimer_separation * v,
                      n_iterations=it, converged=converged)
