"""NEB: nudged elastic band with the whole path as one batched tensor.

Counterpart of `multioptpy_tpu/drivers/neb.py` for the improved-tangent NEB
and CI-NEB force laws (Henkelman & Jonsson, JCP 113 (2000) 9978 and 9901)
relaxed by one FIRE clock over the whole band. The path is an (I, N, 3)
tensor, and the band's energies and gradients are ONE batched calculator
call over the I images. Endpoint images are frozen.

The other variants, band optimizers, IDPP paths, per-image trust radii and
spline climbing insertion arrive with ROADMAP Queue 1 item 11.
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from multioptpy_tpu_torch.device import resolve_device
from multioptpy_tpu_torch.interpolation import redistribute_path
from multioptpy_tpu_torch.ops import hosteval
from multioptpy_tpu_torch.steppers.first_order import (FireState, fire_init,
                                                       fire_step)

_ITEM11 = "arrives with ROADMAP Queue 1 item 11"


def _image_dot(a, b):
    """Per-image inner product: (I,N,3)x(I,N,3) -> (I,1,1)."""
    return (a * b).sum((-1, -2), keepdim=True)


def _normalize(v, eps=1e-14):
    return v / torch.sqrt(_image_dot(v, v) + eps)


def _tangents_from_halo(coords, x_prev, x_next, e, e_prev, e_next):
    """Improved tangents given explicit +-1 neighbor halos."""
    d_plus = x_next - coords
    d_minus = coords - x_prev

    uphill = (e_next > e) & (e > e_prev)
    downhill = (e_next < e) & (e < e_prev)

    de_max = torch.maximum((e_next - e).abs(), (e_prev - e).abs())
    de_min = torch.minimum((e_next - e).abs(), (e_prev - e).abs())
    next_higher = e_next > e_prev
    w_plus = torch.where(next_higher, de_max, de_min)[:, None, None]
    w_minus = torch.where(next_higher, de_min, de_max)[:, None, None]

    tau = torch.where(uphill[:, None, None], d_plus,
                      torch.where(downhill[:, None, None], d_minus,
                                  w_plus * d_plus + w_minus * d_minus))
    return _normalize(tau)


def improved_tangents(coords, energies):
    """(I,N,3),(I,) -> unit tangents (I,N,3), Henkelman improved tangent."""
    return _tangents_from_halo(
        coords, torch.roll(coords, 1, 0), torch.roll(coords, -1, 0),
        energies, torch.roll(energies, 1), torch.roll(energies, -1))


def neb_forces(coords, energies, gradients, k_spring=0.01, variant="neb",
               climbing=False, optimize_endpoints=False, dmf_beta=10.0,
               dmf_nsegs=4):
    """Whole-path NEB force (I,N,3) for `variant` "neb" or "cineb" (the
    climbing image is switched on by `climbing`). Endpoints get -g when
    relaxed, else zero."""
    del dmf_beta, dmf_nsegs
    if variant not in ("neb", "cineb"):
        raise NotImplementedError(f"NEB variant '{variant}' {_ITEM11}")
    n_images = coords.shape[0]
    tau = improved_tangents(coords, energies)

    g = gradients
    g_par = _image_dot(g, tau) * tau
    g_perp = g - g_par

    x_prev = torch.roll(coords, 1, 0)
    x_next = torch.roll(coords, -1, 0)
    d_plus_n = torch.sqrt(_image_dot(x_next - coords, x_next - coords)
                          + 1e-14)
    d_minus_n = torch.sqrt(_image_dot(coords - x_prev, coords - x_prev)
                           + 1e-14)
    force = -g_perp + k_spring * (d_plus_n - d_minus_n) * tau

    # climbing image: the highest interior image feels -g + 2 g_par
    idx = torch.arange(n_images, device=coords.device)
    interior = (idx > 0) & (idx < n_images - 1)
    if climbing:
        ci_idx = torch.argmax(torch.where(interior, energies, -torch.inf))
        is_ci = (idx == ci_idx)[:, None, None]
        force = torch.where(is_ci, -g + 2.0 * g_par, force)

    # endpoints: plain -g (relaxed) or zero (frozen)
    is_end = ~interior[:, None, None]
    end_force = -g if optimize_endpoints else torch.zeros_like(g)
    return torch.where(is_end, end_force, force)


def interpolate_linear(start, end, n_images):
    """(N,3),(N,3) -> (I,N,3) linear interpolation including endpoints."""
    t = torch.as_tensor(np.linspace(0.0, 1.0, n_images), dtype=start.dtype,
                        device=start.device)[:, None, None]
    return (1.0 - t) * start[None] + t * end[None]


@dataclasses.dataclass(frozen=True)
class NEBConfig:
    """The reference's fields and defaults. This port runs `variant`
    "neb"/"cineb" with `optimizer` "fire" and `redistribute` "linear" or
    off; the other options raise NotImplementedError naming ROADMAP Queue 1
    item 11."""

    variant: str = "cineb"
    optimizer: str = "fire"
    rfo_ratio: float = 0.5
    n_steps: int = 100
    k_spring: float = 0.01
    climbing_start: int = 10
    optimize_endpoints: bool = False
    fmax: float = 4.5e-4          # max |force| component convergence
    dt0: float = 0.3
    dt_max: float = 1.0
    sd_step: float = 0.5
    max_move: float = 0.3         # per-image move clamp (Bohr)
    per_image_trust: bool = False
    dmf_beta: float = 10.0
    dmf_nsegs: int = 4
    # in-loop image redistribution every `redistribute_every` iterations
    redistribute: str = ""
    redistribute_every: int = 0
    savgol_window: int = 5
    savgol_order: int = 3
    spline_ci_start: int = 0
    spline_ci_interval: int = 0
    scan_chunk: int = 0           # >1: the chunked driver's order (neb())


class NEBResult(NamedTuple):
    path: torch.Tensor          # (I,N,3)
    energies: torch.Tensor      # (I,)
    converged: bool
    n_iterations: int
    energy_history: np.ndarray
    ts_index: int               # highest-energy interior image


def _check_supported(config):
    if config.variant not in ("neb", "cineb"):
        raise NotImplementedError(f"NEB variant '{config.variant}' {_ITEM11}")
    unported = {
        f"optimizer={config.optimizer}": config.optimizer != "fire",
        "per_image_trust": config.per_image_trust,
        "spline_ci_interval": config.spline_ci_interval > 0,
        f"redistribute={config.redistribute}":
            config.redistribute not in ("", "linear"),
    }
    for name, on in unported.items():
        if on:
            raise NotImplementedError(f"NEBConfig {name} {_ITEM11}")


def make_neb_step(calc, z, config=NEBConfig(), bias_engine=None):
    """One NEB iteration: (path, fire_state, it) -> (path', fire_state',
    energies, gradients, fmax) with the energies and gradients of the band
    the step started from."""
    _check_supported(config)

    def step(path, fire_state, iteration):
        energies, grads = hosteval.energy_and_gradient(calc, path, z,
                                                       bias_engine)
        climbing = (config.variant == "cineb"
                    and iteration >= config.climbing_start)
        forces = neb_forces(path, energies, grads, config.k_spring, "neb",
                            climbing, config.optimize_endpoints)
        # one optimizer clock for the whole path (a single vector)
        move, fire_new = fire_step(fire_state, -forces.reshape(-1),
                                   dt_max=config.dt_max)
        mv = move.reshape(path.shape)
        # per-image norm clamp (see NEBConfig.max_move)
        mv_norm = torch.sqrt(_image_dot(mv, mv) + 1e-30)
        mv = mv * torch.clamp(config.max_move / mv_norm, max=1.0)
        fmax = forces.abs().amax()
        return path + mv, fire_new, energies, grads, fmax

    return step


def neb_state_from_numpy(path, fire_state, iteration, device=None):
    """(path (I,N,3), FireState, iteration) tensors from the reference's
    band, FIRE state and iteration as numpy, so a band can be resumed in
    both packages. `fire_state` is a FireState or a dict of its fields."""
    dev = resolve_device(device)
    path = np.asarray(path)
    dtype = torch.float64 if path.dtype == np.float64 else torch.float32
    fs = fire_state._asdict() if hasattr(fire_state, "_asdict") \
        else dict(fire_state)
    state = FireState(
        velocity=torch.as_tensor(np.asarray(fs["velocity"]), dtype=dtype,
                                 device=dev),
        dt=torch.as_tensor(np.asarray(fs["dt"]), dtype=dtype, device=dev),
        alpha=torch.as_tensor(np.asarray(fs["alpha"]), dtype=dtype,
                              device=dev),
        n_good=torch.as_tensor(np.asarray(fs["n_good"]), dtype=torch.int32,
                               device=dev))
    return (torch.as_tensor(path, dtype=dtype, device=dev), state,
            int(iteration))


def _redistribute_due(config, it):
    return bool(config.redistribute and config.redistribute_every
                and it % config.redistribute_every == 0
                and it < config.n_steps)


def _result(path, energies, converged, it, e_hist):
    e_np = energies.detach().cpu().numpy()
    ts_index = int(np.argmax(e_np[1:-1])) + 1 if len(e_np) > 2 else 0
    return NEBResult(path=path, energies=energies, converged=converged,
                     n_iterations=it, energy_history=np.asarray(e_hist),
                     ts_index=ts_index)


def neb(calc, path0, z, config=NEBConfig(), bias_engine=None, callback=None,
        device=None):
    """Run NEB on an (I,N,3) initial path. `device` (None means the CUDA
    card) must be where `calc` lives. With `config.scan_chunk > 1` (and no
    callback) a step whose fmax falls below `config.fmax` returns its band
    before the redistribution due at its iteration, as the reference's
    chunked driver does (it redistributes only between segments, which end
    on every redistribution iteration); otherwise after it, as its
    per-step loop."""
    dev = resolve_device(device)
    if calc.device != dev:
        raise ValueError(f"the calculator lives on {calc.device}, but the "
                         f"band was asked to run on {dev}")
    path = (path0.detach().to(dev) if isinstance(path0, torch.Tensor)
            else torch.as_tensor(np.array(path0), device=dev))
    step = make_neb_step(calc, z, config, bias_engine)
    fire_state = fire_init(path.numel(), path.dtype, dt0=config.dt0,
                           device=dev)
    chunked = bool(config.scan_chunk and config.scan_chunk > 1
                   and callback is None)

    e_hist = []
    converged = False
    it = 0
    energies = None
    for it in range(1, config.n_steps + 1):
        path_pre = path
        path, fire_state, energies, grads, fmax = step(path, fire_state, it)
        e_hist.append(energies.cpu().numpy())
        converged = float(fmax) < config.fmax
        if converged and chunked:
            break
        if _redistribute_due(config, it):
            path = redistribute_path(path, config.redistribute)
        if callback is not None:
            callback(it, path_pre, energies, grads, fmax)
        if converged:
            break
    return _result(path, energies, converged, it, e_hist)
