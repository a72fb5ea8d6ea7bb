"""Geometry-optimization driver: batched state + one step function.

Counterpart of `multioptpy_tpu/drivers/optimize.py` for the RS-RFO methods
(`rfo_<update>`). The reference's step is one jitted program `vmap`ped over
structures; here the state carries an explicit leading batch axis and the
step is a plain function over it: biased energy/gradient, quasi-Newton
Hessian update (with periodic exact and model Hessians), TR/rot projection,
the RS-RFO step, convergence masking (converged members are frozen) and
uphill-step rejection with a measured-curvature BFGS update.

* `optimize()` — host loop on one structure with early exit; with
  `config.scan_chunk > 1` the chunked semantics of the reference's
  `_optimize_chunked` (see `_optimize_chunked`).
* `optimize_batch()` — a fixed number of steps over a batch (a Python loop
  in place of the reference's `lax.scan`).

Convergence semantics are the reference's (Gaussian-style 4 criteria with
force-coupled displacement thresholds, masked RMS).
"""

import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from multioptpy_tpu_torch.coords.internals import detect_primitives
from multioptpy_tpu_torch.device import resolve_device
from multioptpy_tpu_torch.geometry import (project_gradient_tr_rot,
                                           tr_rot_projector)
from multioptpy_tpu_torch.hessian.model import (make_model_hessian_fn,
                                                model_hessian)
from multioptpy_tpu_torch.hessian.updates import auto_scale, update_hessian
from multioptpy_tpu_torch.ops import hosteval
from multioptpy_tpu_torch.steppers.rfo import rs_rfo_step, update_trust_radius
from multioptpy_tpu_torch.units import ANGSTROM2BOHR


@dataclasses.dataclass(frozen=True)
class OptimizeConfig:
    """Driver configuration (defaults = reference defaults); the same fields
    as the reference. This port runs `rfo_*` methods, bias engines, model
    Hessians of the kinds `hessian/model.py` assembles, `mfc_count` and
    `scan_chunk`; the options that select other engines raise
    NotImplementedError naming the ROADMAP item that ports them."""

    method: str = "rfo_fsb"
    nsteps: int = 1000
    saddle_order: int = 0
    max_force: float = 3e-4          # Hartree/Bohr
    rms_force: float = 2e-4
    max_displacement: float = 1.5e-3  # Bohr
    rms_displacement: float = 1e-3
    trust_radius_ang: Optional[float] = None  # default 0.5 (min) / 0.1 (saddle)
    trust_radius_min_ang: float = 0.01
    delta: float = 1.0
    fc_count: int = -1               # exact Hessian every k steps (-1: never)
    mfc_count: int = -1
    init_hessian: str = "auto"       # auto | exact | identity | model:<kind>
    use_gdiis: bool = False
    diis_variant: Optional[str] = None
    follow_mode_index: int = 0
    # "xla" | "jacobi" | "pallas" | "kernel" | a callable (steppers.rfo._eigh)
    eigh_impl: str = "xla"
    switch_method: Optional[str] = None
    project_tr_rot: bool = True
    scan_chunk: int = 0

    def effective_diis(self):
        return self.diis_variant or ("gdiis" if self.use_gdiis else None)

    def initial_trust_bohr(self):
        tr = self.trust_radius_ang
        if tr is None:
            tr = 0.1 if self.saddle_order > 0 else 0.5
        return tr * ANGSTROM2BOHR

    def criteria(self, tight=False, loose=False):
        if tight:
            return (1.5e-5, 1e-5, 6e-5, 4e-5)
        if loose:
            return (3e-3, 2e-3, 1e-2, 7e-3)
        return (self.max_force, self.rms_force,
                self.max_displacement, self.rms_displacement)


class OptState(NamedTuple):
    """Batched optimizer state; every field has a leading batch axis B."""

    coords: torch.Tensor        # (B,N,3) Bohr
    energy: torch.Tensor        # (B,)
    gradient: torch.Tensor      # (B,N,3) effective gradient
    raw_gradient: torch.Tensor  # (B,N,3) unbiased gradient
    prev_coords: torch.Tensor
    prev_energy: torch.Tensor
    prev_raw_gradient: torch.Tensor
    hessian: torch.Tensor       # (B,3N,3N)
    trust_radius: torch.Tensor  # (B,) Bohr
    predicted_change: torch.Tensor
    move: torch.Tensor          # (B,N,3) last displacement
    iteration: torch.Tensor     # (B,) int32
    converged: torch.Tensor     # (B,) bool
    fo_state: tuple = ()


def _select(cond, a, b):
    """Fieldwise where(cond, a, b) over two OptStates, cond (B,)."""
    def pick(x, y):
        if not isinstance(x, torch.Tensor):
            return x
        return torch.where(cond.reshape(-1, *([1] * (x.ndim - 1))), x, y)
    return OptState(*(pick(x, y) for x, y in zip(a, b)))


def _masked_rms(v, thresh=1e-10):
    """RMS over components with |v| > thresh, per row of (B, D)."""
    mask = v.abs() > thresh
    n = mask.sum(-1)
    s = torch.where(mask, v * v, 0.0).sum(-1)
    return torch.sqrt(s / n.clamp(min=1))


def check_convergence(gradient, displacement, criteria):
    """Four Gaussian-style criteria with force-coupled displacement
    thresholds, per structure: (B, ...) inputs -> (B,) bool."""
    max_f_th, rms_f_th, max_d_th, rms_d_th = criteria
    g = gradient.reshape(gradient.shape[0], -1)
    d = displacement.reshape(displacement.shape[0], -1)
    max_force = g.abs().amax(-1)
    rms_force = _masked_rms(g)
    max_disp = d.abs().amax(-1)
    rms_disp = _masked_rms(d)
    d_max_th = max_d_th + torch.clamp(max_f_th - max_force, min=0.0)
    d_rms_th = rms_d_th + torch.clamp(rms_f_th - rms_force, min=0.0)
    return ((max_force < max_f_th) & (rms_force < rms_f_th)
            & (max_disp < d_max_th) & (rms_disp < d_rms_th))


def _parse_method(method):
    """-> ("rfo", update rule) for the RS-RFO methods this port runs."""
    m = method.lower()
    if m.startswith("rsirfo"):
        m = "rfo" + m[len("rsirfo"):]
    if m.startswith("rfo") and "trim" not in m:
        update = m.split("_", 1)[1] if "_" in m else "auto"
        if not update.startswith("block"):
            return ("rfo", update)
    raise NotImplementedError(
        f"method '{method}': this port runs the rfo_<update> methods; the "
        "rest arrive with ROADMAP Queue 1 item 9 (optimizer layer) and "
        "item 8 (CLI)")


def _check_supported(config):
    """Raise for the options whose engines are not ported yet."""
    _parse_method(config.method)
    unported = {
        "diis": config.effective_diis(),
        "switch_method": config.switch_method,
    }
    for name, on in unported.items():
        if on:
            raise NotImplementedError(
                f"OptimizeConfig {name}: arrives with ROADMAP Queue 1 item 9")


def init_state(coords, z, calc, bias_engine=None, config=OptimizeConfig(),
               hessian0=None):
    """The initial batched OptState of coords (B,N,3) (one energy/gradient
    evaluation, plus the model or exact Hessian where the config asks for
    it; the model Hessian reads the raw gradient)."""
    _check_supported(config)
    b, n, _ = coords.shape
    dtype, dev = coords.dtype, coords.device
    e, g, raw_g = hosteval.eg_with_raw(calc, coords, z, bias_engine)
    eye = torch.eye(3 * n, dtype=dtype, device=dev)
    if hessian0 is None:
        use_exact = (config.init_hessian == "exact"
                     or (config.init_hessian == "auto" and calc.on_device))
        if config.init_hessian.startswith("model:"):
            hessian0 = model_hessian(
                coords, z, kind=config.init_hessian.split(":", 1)[1],
                gradient=raw_g)
        elif use_exact:
            hessian0 = hosteval.hessian(calc, coords, z, bias_engine)
        else:
            hessian0 = eye.expand(b, -1, -1)
    hessian0 = torch.as_tensor(hessian0, dtype=dtype, device=dev)
    return OptState(
        coords=coords, energy=e, gradient=g, raw_gradient=raw_g,
        prev_coords=coords, prev_energy=e, prev_raw_gradient=raw_g,
        hessian=hessian0.expand(b, -1, -1).clone(),
        trust_radius=torch.full((b,), config.initial_trust_bohr(),
                                dtype=dtype, device=dev),
        predicted_change=torch.zeros(b, dtype=dtype, device=dev),
        move=torch.zeros_like(coords),
        iteration=torch.zeros(b, dtype=torch.int32, device=dev),
        converged=torch.zeros(b, dtype=torch.bool, device=dev),
    )


_STATE_FLOATS = ("coords", "energy", "gradient", "raw_gradient",
                 "prev_coords", "prev_energy", "prev_raw_gradient", "hessian",
                 "trust_radius", "predicted_change", "move")


def state_from_numpy(fields, device=None):
    """An OptState from numpy fields named as the reference's OptState
    (coords, energy, gradient, ..., iteration, converged). Unbatched fields
    (coords (N,3)) get a batch axis of one. fo_state must be empty (the
    RS-RFO methods carry none)."""
    dev = resolve_device(device)
    coords = np.asarray(fields["coords"])
    batched = coords.ndim == 3
    dtype = torch.float64 if coords.dtype == np.float64 else torch.float32

    def conv(name, tdtype):
        x = torch.as_tensor(np.array(fields[name]), dtype=tdtype,
                            device=dev)
        return x if batched else x[None]

    if len(fields.get("fo_state", ())):
        raise NotImplementedError("first-order engine states are not ported")
    return OptState(**{k: conv(k, dtype) for k in _STATE_FLOATS},
                    iteration=conv("iteration", torch.int32),
                    converged=conv("converged", torch.bool))


def make_step_fn(calc, z, bias_engine=None, config=OptimizeConfig(),
                 model_hessian_fn=None):
    """Build the batched `state -> state` transition of an `rfo_*` method.
    `model_hessian_fn(coords, raw_gradient)` rebuilds the Hessian every
    `config.mfc_count` steps."""
    _check_supported(config)
    _, sub = _parse_method(config.method)
    criteria = config.criteria()
    saddle_order = config.saddle_order
    tr_max = config.initial_trust_bohr()
    tr_min = config.trust_radius_min_ang * ANGSTROM2BOHR

    def quasi_newton_move(state, g_flat):
        b, n3 = g_flat.shape
        eye = torch.eye(n3, dtype=g_flat.dtype, device=g_flat.device)
        s = (state.coords - state.prev_coords).reshape(b, -1)
        y = (state.raw_gradient - state.prev_raw_gradient).reshape(b, -1)
        have_pair = (state.iteration > 0) & (
            torch.linalg.vector_norm(s, dim=-1) > 1e-12)
        is_identity = (state.hessian == eye).all(-1).all(-1)
        h = auto_scale(state.hessian, s, y, is_identity & have_pair)
        h = torch.where(have_pair[:, None, None], update_hessian(h, s, y, sub),
                        h)
        if config.fc_count > 0 and calc.on_device:
            # periodic exact Hessian rebuild (only where it is due)
            rebuild = (state.iteration % config.fc_count) == 0
            if bool(rebuild.any()):
                idx = rebuild.nonzero()[:, 0]
                h = h.clone()
                h[idx] = hosteval.hessian(calc, state.coords[idx], z,
                                          bias_engine)
        if config.mfc_count > 0 and model_hessian_fn is not None:
            # periodic model-Hessian rebuild from the raw gradient
            rebuild = (state.iteration % config.mfc_count) == 0
            if bool(rebuild.any()):
                idx = rebuild.nonzero()[:, 0]
                h = h.clone()
                h[idx] = model_hessian_fn(state.coords[idx],
                                          state.raw_gradient[idx])

        # TR/rot-projected effective Hessian, the projected-out subspace
        # shifted to +1e3 so it can never be chosen as a saddle mode
        if config.project_tr_rot and state.coords.shape[1] > 1:
            p = tr_rot_projector(state.coords)
            h_eff = p.mT @ h @ p
            h_eff = 0.5 * (h_eff + h_eff.mT) + 1e3 * (eye - p)
        else:
            h_eff = h
        # trust-radius feedback from the previous step's prediction
        actual = state.energy - state.prev_energy
        trust_new = update_trust_radius(
            state.trust_radius, actual, state.predicted_change,
            tr_min=tr_min, tr_max=tr_max)
        trust_new = torch.where(state.iteration > 0, trust_new,
                                state.trust_radius)
        step, aux = rs_rfo_step(g_flat, h_eff, trust_new,
                                saddle_order=saddle_order,
                                eigh_impl=config.eigh_impl)
        return step, h, trust_new, aux["predicted_energy_change"]

    def step(state):
        b = state.coords.shape[0]
        g = state.gradient
        if config.project_tr_rot and state.coords.shape[1] > 1:
            g = project_gradient_tr_rot(g, state.coords)
        g_flat = g.reshape(b, -1)
        mv_flat, h, trust, predicted = quasi_newton_move(state, g_flat)

        move = mv_flat.reshape(state.coords.shape)
        move = torch.where(state.converged[:, None, None], 0.0, move)
        new_coords = state.coords + move
        e_new, g_new, raw_g_new = hosteval.eg_with_raw(calc, new_coords, z,
                                                       bias_engine)

        conv_now = check_convergence(g, move, criteria)
        converged = state.converged | conv_now
        new_state = OptState(
            coords=new_coords, energy=e_new, gradient=g_new,
            raw_gradient=raw_g_new,
            prev_coords=state.coords, prev_energy=state.energy,
            prev_raw_gradient=state.raw_gradient,
            hessian=h, trust_radius=trust,
            predicted_change=predicted.to(state.energy.dtype),
            move=move, iteration=state.iteration + 1, converged=converged)

        # trust-region step rejection (minimization only): revert an
        # uphill move, shrink the radius, and learn the measured curvature
        # of the failed trial with one BFGS update
        if saddle_order == 0:
            reject = (~state.converged) & ~conv_now & (
                e_new > state.energy + 1e-14)
            s_trial = mv_flat
            y_trial = (raw_g_new - state.raw_gradient).reshape(b, -1)
            upd_ok = torch.isfinite(y_trial).all(-1) & (
                (y_trial * s_trial).sum(-1) > 1e-14)
            h_learn = torch.where(upd_ok[:, None, None],
                                  update_hessian(h, s_trial, y_trial, "bfgs"),
                                  h)
            rejected = state._replace(
                hessian=h_learn,
                prev_coords=state.coords,
                prev_raw_gradient=state.raw_gradient,
                trust_radius=torch.clamp(
                    torch.linalg.vector_norm(mv_flat, dim=-1) * 0.25,
                    min=1e-5),
                predicted_change=torch.zeros_like(state.predicted_change),
                iteration=state.iteration + 1)
            new_state = _select(reject, rejected, new_state)

        # converged members keep their state frozen entirely
        return _select(state.converged, state._replace(converged=converged),
                       new_state)

    return step


class OptResult(NamedTuple):
    coords: torch.Tensor
    energy: torch.Tensor
    gradient: torch.Tensor
    converged: torch.Tensor
    n_iterations: int
    energy_history: np.ndarray
    coords_history: Optional[np.ndarray]


def dissociation_detected(coords, limit=10.0):
    """True if any atom's nearest neighbor is farther than `limit` Bohr."""
    c = np.asarray(coords.detach().cpu() if isinstance(coords, torch.Tensor)
                   else coords)
    if len(c) < 2:
        return False
    d = np.linalg.norm(c[:, None] - c[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    return bool(np.max(np.min(d, axis=1)) > limit)


def _as_coords(coords, device):
    """Coordinates onto `device`; the dtype follows the input (f32 or f64)."""
    if isinstance(coords, torch.Tensor):
        return coords.detach().to(device)
    return torch.as_tensor(np.asarray(coords), device=device)


def _check_device(calc, device):
    if calc.device != device:
        raise ValueError(f"the calculator lives on {calc.device}, but the "
                         f"optimization was asked to run on {device}")


def _model_hessian_fn(coords, z, config):
    """The mfc_count rebuild: primitives detected once on the starting
    structure (N,3); the kind of `init_hessian="model:<kind>"`, else the
    reference's default "lindh"."""
    if config.mfc_count <= 0:
        return None
    kind = (config.init_hessian.split(":", 1)[1]
            if config.init_hessian.startswith("model:") else "lindh")
    b, a, t = detect_primitives(coords.detach().cpu().numpy(), z)
    return make_model_hessian_fn(z, b, a, t, kind)


def _optimize_chunked(step, state, config, record_trajectory=False,
                      callback=None, stop_file="end.txt",
                      dissociation_limit=None):
    """`config.scan_chunk` steps between the host's checks, with the
    semantics of the reference's chunked driver (one `lax.scan` per chunk
    there, one launch sequence per step here):

    * a step whose energy is non-finite or beyond |E| > 1e8 is rejected:
      the state stays at the last finite one and the run stops at the end
      of the chunk ("runaway");
    * steps past `config.nsteps` (the chunk count rounds it up) are
      discarded;
    * `n_iterations` counts up to the step where convergence latched;
    * stop file, dissociation and callbacks act at chunk boundaries.

    Steps that cannot change the state are not launched: those past the
    budget, and the rest of a chunk once the structure has converged
    (frozen) or a step was rejected (the reference discards them); their
    rows repeat the state, as the reference's do.
    """
    chunk = int(config.scan_chunk)
    energies = [float(state.energy[0])]
    traj = [state.coords[0].cpu().numpy()] if record_trajectory else None
    it = 0
    n_chunks = -(-config.nsteps // chunk)
    for ci in range(n_chunks):
        stopped = torch.zeros_like(state.converged)
        e_h, conv_h, c_h = [], [], []
        for _ in range(min(chunk, config.nsteps - ci * chunk)):
            if bool((state.converged | stopped).all()):
                break
            new = step(state)
            active = (~stopped) & (state.iteration < config.nsteps)
            bad = active & (~torch.isfinite(new.energy)
                            | (new.energy.abs() > 1e8))
            state = _select((~active) | bad, state, new)
            stopped = stopped | bad
            e_h.append(state.energy[0])
            conv_h.append(state.converged[0])
            if record_trajectory:
                c_h.append(state.coords[0])
        while len(e_h) < chunk:
            e_h.append(state.energy[0])
            conv_h.append(state.converged[0])
            if record_trajectory:
                c_h.append(state.coords[0])
        # one transfer for everything the host inspects
        e_np = torch.stack(e_h).cpu().numpy()
        conv_np = torch.stack(conv_h).cpu().numpy()
        take = min(chunk, config.nsteps - ci * chunk)
        if conv_np.any():
            take = min(take, int(np.argmax(conv_np)) + 1)
        it = ci * chunk + take
        energies.extend(float(e) for e in e_np[:take])
        if record_trajectory:
            traj.extend(c.cpu().numpy() for c in c_h[:take])
        if callback is not None:
            callback(it, state)
        if bool(stopped[0]):
            print(f"# runaway detected (|E| > 1e8 or non-finite) in "
                  f"method={config.method} saddle_order="
                  f"{config.saddle_order} around iteration {it} - "
                  "keeping the last finite state")
            break
        if bool(conv_np[-1]):
            break
        if stop_file and os.path.exists(stop_file):
            break
        if dissociation_limit and dissociation_detected(
                state.coords[0], dissociation_limit):
            break
    return OptResult(
        coords=state.coords[0], energy=state.energy[0],
        gradient=state.gradient[0], converged=state.converged[0],
        n_iterations=it, energy_history=np.asarray(energies),
        coords_history=np.stack(traj) if record_trajectory else None)


def optimize(calc, coords, z, bias_engine=None, config=OptimizeConfig(),
             hessian0=None, record_trajectory=False, callback=None,
             stop_file="end.txt", dissociation_limit=None, device=None):
    """Host-driven optimization loop on one structure (N,3) with early exit.

    `device` (None means the CUDA card) must be where `calc` lives. A
    `stop_file` in the working directory breaks the loop gracefully, and
    `dissociation_limit` (Bohr) aborts a run whose molecule broke apart.
    `callback(it, state)` sees the batched state (batch of one). With
    `config.scan_chunk > 1` the loop runs `_optimize_chunked`."""
    dev = resolve_device(device)
    _check_device(calc, dev)
    x = _as_coords(coords, dev)[None]
    h0 = None if hessian0 is None else torch.as_tensor(
        hessian0, dtype=x.dtype, device=dev)
    state = init_state(x, z, calc, bias_engine, config, h0)
    step = make_step_fn(calc, z, bias_engine, config,
                        _model_hessian_fn(x[0], z, config))
    if config.scan_chunk and config.scan_chunk > 1:
        return _optimize_chunked(
            step, state, config, record_trajectory=record_trajectory,
            callback=callback, stop_file=stop_file,
            dissociation_limit=dissociation_limit)

    energies = [float(state.energy[0])]
    traj = [state.coords[0].cpu().numpy()] if record_trajectory else None
    it = 0
    for it in range(1, config.nsteps + 1):
        state = step(state)
        e_now = float(state.energy[0])      # waits for the step
        energies.append(e_now)
        if record_trajectory:
            traj.append(state.coords[0].cpu().numpy())
        if callback is not None:
            callback(it, state)
        if bool(state.converged[0]):
            break
        if stop_file and os.path.exists(stop_file):
            break
        if dissociation_limit and dissociation_detected(
                state.coords[0], dissociation_limit):
            break
        if not np.isfinite(e_now) or abs(e_now) > 1e8:
            print("# runaway detected (|E| > 1e8 or non-finite) - aborting")
            break

    return OptResult(
        coords=state.coords[0], energy=state.energy[0],
        gradient=state.gradient[0], converged=state.converged[0],
        n_iterations=it, energy_history=np.asarray(energies),
        coords_history=np.stack(traj) if record_trajectory else None)


def optimize_batch(calc, coords_batch, z, bias_engine=None,
                   config=OptimizeConfig(), n_steps=None, hessian0=None,
                   device=None):
    """Batched optimization: `n_steps` steps of the whole batch (B,N,3) in
    lockstep, converged members frozen. `device` as in `optimize`."""
    dev = resolve_device(device)
    _check_device(calc, dev)
    n_steps = int(n_steps if n_steps is not None else config.nsteps)
    x = _as_coords(coords_batch, dev)
    h0 = None if hessian0 is None else torch.as_tensor(
        hessian0, dtype=x.dtype, device=dev)
    state = init_state(x, z, calc, bias_engine, config, h0)
    step = make_step_fn(calc, z, bias_engine, config)
    e_hist = []
    for _ in range(n_steps):
        state = step(state)
        e_hist.append(state.energy)
    e_hist = (torch.stack(e_hist).cpu().numpy() if e_hist
              else np.zeros((0, x.shape[0])))
    return OptResult(
        coords=state.coords, energy=state.energy, gradient=state.gradient,
        converged=state.converged, n_iterations=n_steps,
        energy_history=e_hist, coords_history=None)
