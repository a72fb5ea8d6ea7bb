"""IRC: intrinsic reaction coordinate following in mass-weighted coordinates.

Counterpart of `multioptpy_tpu/drivers/irc.py` for its integrators: LQA
(Page & McIver: the mass-weighted equations of motion integrated exactly on
the local quadratic surface, the step length matched by a fixed count of
doublings and bisections on t), Euler, RK4, DVV and the Hessian predictor-
corrector HPC. The forward and backward branches run as one batch of 2, so
each step's gradients and Hessians are one calculator call over both
branches (2 x 6N displaced structures for an SQM/SQM2 Hessian).

`meta_irc` follows the downhill path from a non-stationary point, and
`modekill` walks a higher-order saddle down its surplus imaginary modes.
Coordinates are mass-weighted as q = sqrt(m) x (amu^1/2 Bohr).
"""

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from multioptpy_tpu_torch.device import calc_device, on_device
from multioptpy_tpu_torch.geometry import (masses_from_z,
                                           project_hessian_tr_rot,
                                           tr_rot_projector)
from multioptpy_tpu_torch.ops import hosteval
from multioptpy_tpu_torch.ops.eigh64 import eigh_deflated, eigh_fast


def _sqrt_masses(z, coords):
    m = masses_from_z(z).to(device=coords.device, dtype=coords.dtype)
    return torch.repeat_interleave(torch.sqrt(m), 3), m


def mass_weighted_modes(hessian, coords, z):
    """Project TR/rot and diagonalize the mass-weighted Hessians of a batch
    (B,3N,3N), (B,N,3). Returns (eigvals (B,3N), eigvecs (B,3N,3N) in mw
    coords, sqrt_m (3N,))."""
    sm, masses = _sqrt_masses(z, coords)
    h_mw = hessian / sm[:, None] / sm[None, :]
    if coords.shape[-2] > 1:
        p = tr_rot_projector(coords, masses)
        h_mw = project_hessian_tr_rot(h_mw, coords, masses)
        w, v = eigh_deflated(h_mw, p)
    else:
        w, v = eigh_fast(h_mw)
    return w, v, sm


def _lqa_modes(hessian, coords, sm):
    """TR/rot-projected mass-weighted eigenmodes (B,3N), (B,3N,3N) for the
    LQA integrator, via the deflated solver."""
    h_mw = hessian / sm[:, None] / sm[None, :]
    h_mw = 0.5 * (h_mw + h_mw.mT)
    if coords.shape[-2] > 1:
        masses = sm.reshape(-1, 3)[:, 0] ** 2
        p = tr_rot_projector(coords, masses)
        h_mw = project_hessian_tr_rot(h_mw, coords, masses)
        return eigh_deflated(h_mw, p)
    return eigh_fast(h_mw)


def initial_displacements(hessian, coords, z, step_ang_amu=0.1):
    """+/- displacement along the imaginary mode at saddles (B,N,3).
    Returns (x_fwd, x_bwd), both (B,N,3)."""
    _, v, sm = mass_weighted_modes(hessian, coords, z)
    mode = v[..., 0]  # most negative eigenvalue
    dx = (mode / sm).reshape(coords.shape)
    norm = torch.linalg.vector_norm(dx.reshape(dx.shape[0], -1), dim=-1)
    dx = dx / norm[:, None, None] * step_ang_amu
    return coords + dx, coords - dx


def _mw_gradient(g, sm):
    """Mass-weighted gradient (3N,) of one structure's g (N,3)."""
    return g.reshape(-1) / sm


@dataclasses.dataclass(frozen=True)
class IRCConfig:
    method: str = "lqa"
    step_size: float = 0.05        # mass-weighted step length
    n_steps: int = 200
    grad_threshold: float = 1e-4   # stop when |g| below
    init_displacement: float = 0.1


IRC_METHODS = ("lqa", "euler", "rk4", "dvv", "hpc")


def _unit(v):
    """Rows of (B, D) over their norms (+1e-30)."""
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-30)


def make_irc_step(calc, z, config=IRCConfig(), bias_engine=None):
    """coords (B,N,3) -> (coords', energy (B,), gradient (B,N,3)): one step
    of `config.method` for each member, energy and gradient at the input
    coords. "euler" and "dvv" step ds along -g_mw/|g_mw| (dvv resets its
    velocity to the gradient direction every step); "rk4" integrates
    dq/ds = -g_mw/|g_mw| with four more gradient batches; "lqa" solves the
    local quadratic exactly (Page-McIver); "hpc" corrects the LQA step with
    a second LQA at the predicted point and averages the two (Hratchian &
    Schlegel, JCP 120 (2004) 9918), rescaled to ds."""
    method = config.method
    if method not in IRC_METHODS:
        raise ValueError(f"unknown IRC method '{method}'")
    ds = config.step_size

    def lqa_dq(coords, g_mw, sm):
        # exact integration of dq/dt = -(g + H dq) on the local quadratic,
        # on the TR/rot-projected mass-weighted Hessian (deflated eigh)
        h = hosteval.hessian(calc, coords, z, bias_engine)
        w, v = _lqa_modes(h, coords, sm)
        g_t = (v.mT @ g_mw[..., None])[..., 0]
        small = w.abs() < 1e-8
        w_safe = torch.where(small, 1.0, w)

        def dq_of_t(t):
            # dq_i = g_i (exp(-w t) - 1) / w  (limit -g t as w -> 0)
            wt = w * t[:, None]
            coef = torch.where(small, -t[:, None] * (1.0 - 0.5 * wt),
                               (torch.exp(-wt) - 1.0) / w_safe)
            return coef * g_t

        def norm_at(t):
            return torch.linalg.vector_norm(dq_of_t(t), dim=-1)

        # bracket t: 40 doublings while the step is shorter than ds, then
        # 60 bisections (the reference's fixed counts)
        t_hi = ds / (torch.linalg.vector_norm(g_mw, dim=-1) + 1e-30)
        for _ in range(40):
            t_hi = torch.where(norm_at(t_hi) < ds, t_hi * 2.0, t_hi)
        lo, hi = torch.zeros_like(t_hi), t_hi
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            too_small = norm_at(mid) < ds
            lo, hi = (torch.where(too_small, mid, lo),
                      torch.where(too_small, hi, mid))
        return (v @ dq_of_t(0.5 * (lo + hi))[..., None])[..., 0]

    def step(coords):
        b = coords.shape[0]
        sm, _ = _sqrt_masses(z, coords)
        e, g = hosteval.energy_and_gradient(calc, coords, z, bias_engine)
        g_mw = g.reshape(b, -1) / sm
        if method in ("euler", "dvv"):
            dq = -ds * _unit(g_mw)
        elif method == "rk4":
            def f(q_mw):
                x = (q_mw / sm).reshape(coords.shape)
                _, gg = hosteval.energy_and_gradient(calc, x, z, bias_engine)
                return -_unit(gg.reshape(b, -1) / sm)

            q0 = coords.reshape(b, -1) * sm
            k1 = f(q0)
            k2 = f(q0 + 0.5 * ds * k1)
            k3 = f(q0 + 0.5 * ds * k2)
            k4 = f(q0 + ds * k3)
            dq = ds * (k1 + 2 * k2 + 2 * k3 + k4) / 6.0
        elif method == "lqa":
            dq = lqa_dq(coords, g_mw, sm)
        else:  # hpc
            dq_pred = lqa_dq(coords, g_mw, sm)
            x_pred = coords + (dq_pred / sm).reshape(coords.shape)
            _, g_pred = hosteval.energy_and_gradient(calc, x_pred, z,
                                                     bias_engine)
            dq_corr = lqa_dq(x_pred, g_pred.reshape(b, -1) / sm, sm)
            dq = 0.5 * (dq_pred + dq_corr)
            dq = dq * (ds / (torch.linalg.vector_norm(dq, dim=-1,
                                                      keepdim=True) + 1e-30))
        return coords + (dq / sm).reshape(coords.shape), e, g

    return step


class IRCResult(NamedTuple):
    forward_path: np.ndarray       # (S,N,3)
    backward_path: np.ndarray
    forward_energies: np.ndarray
    backward_energies: np.ndarray
    ts_coords: torch.Tensor
    ts_energy: float
    forward_gradients: Optional[np.ndarray] = None
    backward_gradients: Optional[np.ndarray] = None
    ts_hessian: Optional[np.ndarray] = None


def irc(calc, ts_coords, z, hessian=None, config=IRCConfig(),
        bias_engine=None, device=None):
    """Full IRC from a saddle (N,3): eigenmode kick, then both branches as
    a batch of 2, in segments of 8 steps with the host's early exit at
    segment ends (both branches done). A branch stops on a small gradient
    or an energy rise, and a non-finite step freezes it at its last finite
    point; the returned paths include the frozen tail up to the segment
    boundary. `device` (None means the CUDA card) must be where `calc`
    lives."""
    dev = calc_device(calc, device, "the IRC")
    ts = on_device(ts_coords, dev)
    if hessian is None:
        hessian = hosteval.hessian(calc, ts[None], z, bias_engine)[0]
    hessian = torch.as_tensor(hessian, dtype=ts.dtype, device=dev)

    e_ts, _ = hosteval.energy_and_gradient(calc, ts[None], z)
    x_f, x_b = initial_displacements(hessian[None], ts[None], z,
                                     config.init_displacement)
    step = make_irc_step(calc, z, config, bias_engine)
    seg = max(1, min(8, config.n_steps))

    coords = torch.cat([x_f, x_b])
    prev_e = torch.full((2,), torch.inf, dtype=ts.dtype, device=dev)
    done = torch.zeros(2, dtype=torch.bool, device=dev)
    rows = []
    n_done = 0
    while n_done < config.n_steps:
        # the reference runs a whole segment; only its first `take` steps
        # are kept, and the last segment is also the last one run
        take = min(seg, config.n_steps - n_done)
        for _ in range(take):
            coords_new, e, g = step(coords)
            gnorm = torch.linalg.vector_norm(g.reshape(2, -1), dim=-1)
            bad = ~(torch.isfinite(e)
                    & torch.isfinite(coords_new).reshape(2, -1).all(-1))
            keep = done | bad
            done = keep | (gnorm < config.grad_threshold) | (e > prev_e)
            coords = torch.where(keep[:, None, None], coords, coords_new)
            prev_e = torch.where(keep, prev_e, e)
            rows.append((coords, prev_e, g))
        n_done += take
        if bool(done.all()):
            break
    paths = torch.stack([r[0] for r in rows], 1).cpu().numpy()
    energies = torch.stack([r[1] for r in rows], 1).cpu().numpy()
    grads = torch.stack([r[2] for r in rows], 1).cpu().numpy()
    return IRCResult(
        forward_path=paths[0], backward_path=paths[1],
        forward_energies=energies[0], backward_energies=energies[1],
        ts_coords=ts, ts_energy=float(e_ts[0]),
        forward_gradients=grads[0], backward_gradients=grads[1],
        ts_hessian=hessian.cpu().numpy())


def meta_irc(calc, coords, z, config=IRCConfig(), bias_engine=None,
             device=None):
    """meta-IRC: a one-directional downhill path from a non-stationary
    point (N,3): the first kick is along the mass-weighted gradient-descent
    direction, then `config.method` follows the path to the nearest
    minimum, in segments of 8 steps with the host's early exit at segment
    ends. Returns an IRCResult whose forward branch is the path (the
    backward branch holds the start)."""
    dev = calc_device(calc, device, "the IRC")
    coords = on_device(coords, dev)
    e0, g0 = hosteval.energy_and_gradient(calc, coords[None], z, bias_engine)
    sm = torch.sqrt(masses_from_z(z).to(device=dev, dtype=coords.dtype))
    kick = (g0[0] / (torch.linalg.vector_norm(g0[0]) + 1e-30)) / sm[:, None]
    x = (coords - config.init_displacement * kick)[None]
    step = make_irc_step(calc, z, config, bias_engine)
    seg = max(1, min(8, config.n_steps))

    prev_e = torch.full((1,), torch.inf, dtype=coords.dtype, device=dev)
    done = torch.zeros(1, dtype=torch.bool, device=dev)
    rows = []
    n_done = 0
    while n_done < config.n_steps:
        take = min(seg, config.n_steps - n_done)
        for _ in range(take):
            x_new, e, g = step(x)
            gnorm = torch.linalg.vector_norm(g.reshape(1, -1), dim=-1)
            bad = ~(torch.isfinite(e)
                    & torch.isfinite(x_new).reshape(1, -1).all(-1))
            keep = done | bad
            done = keep | (gnorm < config.grad_threshold) | (e > prev_e)
            x = torch.where(keep[:, None, None], x, x_new)
            prev_e = torch.where(keep, prev_e, e)
            rows.append((x[0], prev_e[0]))
        n_done += take
        if bool(done[0]):
            break
    return IRCResult(
        forward_path=torch.stack([r[0] for r in rows]).cpu().numpy(),
        backward_path=coords[None].cpu().numpy(),
        forward_energies=torch.stack([r[1] for r in rows]).cpu().numpy(),
        backward_energies=np.asarray([float(e0[0])]),
        ts_coords=coords, ts_energy=float(e0[0]))


def modekill(calc, coords, z, keep_order=0, max_rounds=30, step_size=0.1,
             mode_thresh=-5.0, bias_engine=None, opt_config=None,
             device=None):
    """Remove surplus imaginary modes from a stationary structure (N,3):
    displace along the softest surplus mode (the side of lower trial
    energy), re-optimize, and repeat until at most `keep_order` imaginary
    modes remain. Returns (coords, n_imaginary)."""
    from multioptpy_tpu_torch.analysis.vibrations import (count_imaginary,
                                                          normal_modes)
    from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig, optimize

    dev = calc_device(calc, device, "ModeKill")
    opt_config = opt_config or OptimizeConfig(
        method="rfo_fsb", nsteps=60, saddle_order=keep_order,
        fc_count=10 if calc.on_device else -1)
    coords = on_device(coords, dev)
    n_imag = -1
    for _ in range(max_rounds):
        h = hosteval.hessian(calc, coords[None], z, bias_engine)[0]
        nm = normal_modes(h, coords, z)
        n_imag = count_imaginary(nm.frequencies_cm1, mode_thresh)
        if n_imag <= keep_order:
            break
        mode = nm.modes[keep_order]
        mode = mode / torch.linalg.vector_norm(mode)
        e_p, e_m = calc.energy(torch.stack([coords + step_size * mode,
                                            coords - step_size * mode]),
                               z).tolist()
        coords = coords + (step_size if e_p < e_m else -step_size) * mode
        coords = optimize(calc, coords, z, bias_engine=bias_engine,
                          config=opt_config, device=dev).coords
    return coords, n_imag
