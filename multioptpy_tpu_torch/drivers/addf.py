"""ADDF: anharmonic-downward-distortion following (scaled hypersphere
search).

Counterpart of `multioptpy_tpu/drivers/addf.py` (Ohno & Maeda, CPL 384
(2004) 277). From an equilibrium structure, reaction channels appear as
directions where the true energy falls below the harmonic reference:
  1. the harmonic reference is the Hessian at the minimum; positions are
     scaled by the square roots of its vibrational eigenvalues, so that
     the reference is an isotropic paraboloid;
  2. channel seeds are +/- the softest vibrational eigenvectors;
  3. on each hypersphere |q| = r the energy is minimized with the radial
     direction projected out (a fixed number of projected FIRE steps);
  4. r grows until the energy turns over: the channel crossed its TS.
The frontier stays on the device; the host reads one energy per sphere.
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from multioptpy_tpu_torch.device import calc_device, on_device
from multioptpy_tpu_torch.geometry import (align_to, project_hessian_tr_rot,
                                           tr_rot_projector)
from multioptpy_tpu_torch.ops import hosteval
from multioptpy_tpu_torch.ops.eigh64 import eigh_deflated, eigh_fast


@dataclasses.dataclass(frozen=True)
class ADDFConfig:
    n_channels: int = 4          # follow the 2*k softest modes -> k pairs
    r_start: float = 0.3         # initial hypersphere radius (scaled coords)
    r_step: float = 0.15
    n_spheres: int = 40
    n_relax: int = 60            # on-sphere projected FIRE steps
    relax_rate: float = 0.4
    eig_floor: float = 1e-4      # vibrational-mode cutoff (TR/rot excluded)
    max_rise: float = 0.8        # Hartree above the minimum: abandon the
                                 # channel as a repulsive-wall escape


class ADDFChannel(NamedTuple):
    path: np.ndarray             # (S,N,3) cartesian
    energies: np.ndarray
    ts_guess: np.ndarray
    ts_energy: float
    crossed_ts: bool


def _energy_fn(calc, z, bias_engine):
    """(N,3) -> () energy with bias, differentiable."""
    def energy(x):
        e = calc.energy(x[None], z)[0]
        if bias_engine is not None and len(bias_engine):
            e = e + bias_engine.total_energy(x[None])[0]
        return e
    return energy


def _gradient_of(fn):
    def grad(q):
        with torch.enable_grad():
            qq = q.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(fn(qq), qq)
        return g
    return grad


def relax_on_sphere(grad_q, q, r, n_relax, relax_rate):
    """Projected FIRE on the sphere |q| = r: the tangential gradient drives
    the move, and each step is retracted onto the sphere."""
    vel = torch.zeros_like(q)
    dt = torch.full((), relax_rate, dtype=q.dtype, device=q.device)
    for _ in range(n_relax):
        g = grad_q(q)
        q_hat = q / (torch.linalg.vector_norm(q) + 1e-30)
        g_t = g - (g @ q_hat) * q_hat
        power = (-g_t * vel).sum()
        vel = torch.where(power > 0, 0.9 * vel - dt * g_t, -dt * g_t)
        q = q + dt * vel
        q = q * (r / (torch.linalg.vector_norm(q) + 1e-30))
    return q


def _harmonic_modes(calc, coords, z, bias_engine):
    """(w (3N,), v (3N,3N), P or None) of the Hessian at `coords`, TR/rot
    projected and deflated for molecules."""
    h = hosteval.hessian(calc, coords[None], z, bias_engine)[0]
    if coords.shape[0] > 1:
        p = tr_rot_projector(coords[None])[0]
        h = project_hessian_tr_rot(h[None], coords[None])[0]
        w, v = eigh_deflated(0.5 * (h + h.T), p)
        return w, v, p
    w, v = eigh_fast(0.5 * (h + h.T))
    return w, v, None


def addf_search(calc, coords, z, config=ADDFConfig(), bias_engine=None,
                device=None):
    """-> list[ADDFChannel], one per followed ADD, on `device` (None means
    the CUDA card)."""
    dev = calc_device(calc, device, "the search")
    coords = on_device(coords, dev)
    n = coords.shape[0]
    energy = _energy_fn(calc, z, bias_engine)

    # scaled coordinates q = S Vvib^T (x - x0), S = diag(sqrt(w_vib)),
    # restricted to the vibrational subspace
    w, v, p = _harmonic_modes(calc, coords, z, bias_engine)
    w_np, v_np = w.cpu().numpy(), v.cpu().numpy()
    if p is not None:
        # TR/rot removal by mode count (the rank of I - P; the deflated
        # modes sit at ~0 and sort first), not by an eigenvalue cutoff,
        # which would drop genuine soft modes; eig_floor only floors the
        # scale
        n_trrot = int(round(float(np.trace(np.eye(3 * n)
                                           - p.cpu().numpy()))))
        vib = np.zeros(3 * n, dtype=bool)
        vib[n_trrot:] = True
    else:
        vib = w_np > config.eig_floor
    kind = dict(dtype=coords.dtype, device=dev)
    v_vib = torch.as_tensor(v_np[:, vib], **kind)
    scale = torch.sqrt(torch.as_tensor(
        np.maximum(w_np[vib], config.eig_floor), **kind))
    w_vib = w_np[vib]
    x0_flat = coords.reshape(-1)

    def to_cart(q):
        return (x0_flat + v_vib @ (q / scale)).reshape(n, 3)

    def energy_q(q):
        return energy(to_cart(q))

    grad_q = _gradient_of(energy_q)

    order = np.argsort(w_vib)
    seeds = []
    for k in range(min(max(config.n_channels // 2, 1), len(w_vib))):
        e_k = torch.zeros(len(w_vib), **kind)
        e_k[int(order[k])] = 1.0
        seeds.extend([e_k, -e_k])

    channels = []
    e0 = float(energy(coords).detach())
    for seed in seeds[: config.n_channels]:
        q = seed * config.r_start
        path = [coords]
        energies = [e0]
        crossed = False
        r = config.r_start
        for _ in range(config.n_spheres):
            q = relax_on_sphere(grad_q, q, r, config.n_relax,
                                config.relax_rate)
            path.append(to_cart(q))
            energies.append(float(energy_q(q).detach()))   # one sync
            if len(energies) > 2 and energies[-1] < energies[-2]:
                crossed = True              # the energy turned over
                break
            if energies[-1] > e0 + config.max_rise:
                break                       # a repulsive-wall escape
            r += config.r_step
            q = q * (r / torch.linalg.vector_norm(q))
        path = torch.stack(path).detach().cpu().numpy()
        ts_idx = int(np.argmax(energies))
        channels.append(ADDFChannel(
            path=path, energies=np.asarray(energies),
            ts_guess=path[ts_idx], ts_energy=energies[ts_idx],
            crossed_ts=crossed))
    return channels


class ADDFTransitionState(NamedTuple):
    coords: np.ndarray
    energy: float
    n_imaginary: int
    converged: bool
    channel: int                 # which ADD channel produced it


def addf_explore(calc, coords, z, config=ADDFConfig(), saddle_config=None,
                 bias_engine=None, dedupe_rmsd=0.2, refine_all=False,
                 device=None):
    """Multi-channel ADD following with a saddle refinement of each
    crossing and a dedupe by aligned RMSD. Returns (ts_list, channels):
    `ts_list` holds the distinct refined saddles sorted by energy,
    `channels` the raw `addf_search` output."""
    from multioptpy_tpu_torch.analysis.vibrations import (count_imaginary,
                                                          normal_modes)
    from multioptpy_tpu_torch.workflows.autots import refine_saddle

    dev = calc_device(calc, device, "the search")
    coords = on_device(coords, dev)
    channels = addf_search(calc, coords, z, config=config,
                           bias_engine=bias_engine, device=dev)
    ts_list = []
    for idx, ch in enumerate(channels):
        if not (ch.crossed_ts or refine_all):
            continue
        res = refine_saddle(calc, torch.as_tensor(ch.ts_guess,
                                                  dtype=coords.dtype,
                                                  device=dev),
                            z, config=saddle_config, bias_engine=bias_engine,
                            device=dev)
        h = hosteval.hessian(calc, res.coords[None], z, bias_engine)[0]
        n_imag = int(count_imaginary(
            normal_modes(h, res.coords, z).frequencies_cm1))
        cand = ADDFTransitionState(
            coords=res.coords.cpu().numpy(), energy=float(res.energy),
            n_imaginary=n_imag, converged=bool(res.converged), channel=idx)
        dup = False
        for kept in ts_list:
            aligned = align_to(torch.as_tensor(cand.coords),
                               torch.as_tensor(kept.coords)).numpy()
            rmsd = float(np.sqrt(np.mean(
                np.sum((aligned - kept.coords) ** 2, axis=1))))
            if rmsd < dedupe_rmsd and abs(cand.energy - kept.energy) < 1e-4:
                dup = True
                break
        if not dup:
            ts_list.append(cand)
    ts_list.sort(key=lambda t: t.energy)
    return ts_list, channels
