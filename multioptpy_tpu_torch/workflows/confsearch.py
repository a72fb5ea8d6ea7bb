"""Conformer search: batched AFIR-kick exploration.

Counterpart of `multioptpy_tpu/workflows/confsearch.py`. Every round
draws a batch of candidates (Boltzmann/tabu seeds, random atom pairs,
push/pull signs) with the same numpy draws in the same order as the
reference, kicks the whole batch with a short FIRE relaxation on
E + sign * alpha(gamma) * r_ij (the pair enters as one-hot weights, so one
loop of batched gradient calls serves every member), then relaxes the
batch on the unbiased surface in lockstep with `optimize_batch`.
Deduplication and the Boltzmann bookkeeping stay on the host.

The FIRE state (velocity, power, time step) is carried per member: `dt` is
a (B,) tensor and every select of the reference's `jnp.where` is a per-row
select. Candidates with a non-finite coordinate are dropped, as in the
reference, and counted (`n_nonfinite`). The sharded search (`mesh`)
arrives with ROADMAP Queue 1 item 17.
"""

import dataclasses
import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from multioptpy_tpu_torch.device import calc_device, on_device
from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig, optimize_batch
from multioptpy_tpu_torch.geometry import bond_connectivity
from multioptpy_tpu_torch.potentials.afir import afir_alpha
from multioptpy_tpu_torch.units import KB_HARTREE


@dataclasses.dataclass(frozen=True)
class ConfSearchConfig:
    n_rounds: int = 8
    batch_size: int = 16
    base_gamma: float = 200.0       # kJ/mol AFIR push strength (-bf)
    kick_steps: int = 60            # biased FIRE steps
    relax_steps: int = 80           # unbiased batched opt steps
    opt: OptimizeConfig = dataclasses.field(
        default_factory=lambda: OptimizeConfig(method="rfo_fsb"))
    temperature: float = 300.0      # Boltzmann seed selection
    dedupe_threshold: float = 0.1   # Bohr, sorted-distance-matrix metric
    preserve_bonds: bool = True     # reject connectivity changes
    seed: int = 0
    tabu_weight: float = 1.0        # visit-count penalty
    # AFIR pairs drawn only among these 1-indexed atoms (-tgta)
    target_atoms: Optional[Sequence[int]] = None
    # False = always kick from the initial EQ (-nost)
    stochastic: bool = True
    # stop once the lowest-`number_of_rank` energy list has not changed for
    # `number_of_lowest` consecutive rounds (-nr/-nl; only while more than
    # number_of_rank conformers exist)
    number_of_rank: int = 10
    number_of_lowest: int = 5


class ConfSearchResult(NamedTuple):
    conformers: np.ndarray       # (C,N,3) unique, energy-sorted
    energies: np.ndarray         # (C,)
    n_generated: int
    n_rejected_bonds: int
    n_nonfinite: int             # candidates dropped for a non-finite value


def _sorted_distance_fingerprint(coords):
    n = coords.shape[0]
    d = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)
    return np.sort(d[np.triu_indices(n, 1)])


def _is_duplicate(fp, fps, thresh):
    for other in fps:
        if np.max(np.abs(fp - other)) < thresh:
            return True
    return False


def _pair_gradient(x, w1, w2, scale):
    """Gradient (B,N,3) and value (B,) of scale_b * |w1_b x_b - w2_b x_b|
    (the AFIR pull of one-hot weights), r softened by 1e-12 as in the
    reference."""
    d = (torch.einsum("bn,bnk->bk", w1, x)
         - torch.einsum("bn,bnk->bk", w2, x))
    r = torch.sqrt((d * d).sum(-1) + 1e-12)
    g = (scale / r)[:, None, None] * (w1 - w2)[:, :, None] * d[:, None, :]
    return g, scale * r


def fire_relax(grad_fn, coords, n_steps, record=None):
    """The reference's per-member FIRE loop: n_steps of
    v <- 0.9 v - dt g (power > 0) or -dt g, dt <- min(1.05 dt, 0.8) or
    dt / 2, x <- x + dt v, from v = 0 and dt = 0.1. `record(k, x)` sees x
    after step k (0-based)."""
    b = coords.shape[0]
    x = coords
    v = torch.zeros_like(x)
    dt = torch.full((b,), 0.1, dtype=x.dtype, device=x.device)
    for k in range(n_steps):
        g = grad_fn(x)
        up = (-g * v).sum((1, 2)) > 0
        dt3 = dt[:, None, None]
        v = torch.where(up[:, None, None], 0.9 * v - dt3 * g, -dt3 * g)
        dt = torch.where(up, torch.clamp(dt * 1.05, max=0.8), dt * 0.5)
        x = x + dt[:, None, None] * v
        if record is not None:
            record(k, x)
    return x


def make_kick_relax(calc, z, gamma, n_steps):
    """FIRE relaxation of a batch on E + sign * alpha(gamma) * r_ij, the
    pair encoded as one-hot weights: run(coords_b (B,N,3), w1_b (B,N),
    w2_b (B,N), sign_b (B,), record=None) -> (B,N,3), one batched gradient
    call a step (`record` as in `fire_relax`)."""

    def run(coords_b, w1_b, w2_b, sign_b, record=None):
        alpha = afir_alpha(torch.as_tensor(gamma, dtype=coords_b.dtype))
        scale = sign_b * alpha

        def grad_fn(x):
            g = calc.energy_and_gradient(x, z)[1]
            return g + _pair_gradient(x, w1_b, w2_b, scale)[0]

        return fire_relax(grad_fn, coords_b, n_steps, record)

    return run


def save_search_state(path, found, energies, visits):
    """Restart file: conformers, energies and visit counts in one npz."""
    np.savez(path, conformers=np.stack(found),
             energies=np.asarray(energies), visits=np.asarray(visits))


def load_search_state(path):
    data = np.load(path)
    return (list(data["conformers"]), list(data["energies"].astype(float)),
            list(data["visits"].astype(int)))


def _host_bonds(coords, z):
    """Bond adjacency of host coordinates (..., N, 3), on the host."""
    return bond_connectivity(torch.as_tensor(coords), z).numpy()


def conformer_search(calc, coords, z, config=ConfSearchConfig(),
                     restart_file=None, mesh=None, device=None,
                     stage_hook=None):
    """Explore the conformer ensemble of one molecule. `restart_file`: an
    npz path, loaded if it exists and written after every round.

    `device` (None means the CUDA card) must be where `calc` lives.
    `stage_hook(name, **detail)`, if given, is called as each stage ends,
    for counters and reruns read per stage: "seed" with the seed
    relaxation (`result`, None on a restart), then in each round "kick"
    (`round`, `seeds_idx`, `pairs`, `signs`, the kick's input `batch`, `w1`,
    `w2`, `sign_t`, and `kicked`) and "relax" (`round`, `result`)."""
    if mesh is not None:
        raise NotImplementedError(
            "the sharded conformer search (mesh) arrives with ROADMAP "
            "Queue 1 item 17")
    dev = calc_device(calc, device, "the conformer search")
    hook = stage_hook or (lambda name, **detail: None)
    rng = np.random.default_rng(config.seed)
    coords = on_device(coords, dev)
    z = np.asarray(z)
    n = coords.shape[0]
    dtype = coords.dtype

    if restart_file and os.path.exists(restart_file):
        found, energies, visits = load_search_state(restart_file)
        seed_coords = found[0]
        hook("seed", result=None)
    else:
        # seed conformer: relax the input
        seed_res = optimize_batch(calc, coords[None], z, config=config.opt,
                                  n_steps=config.relax_steps, device=dev)
        seed_coords = seed_res.coords[0].cpu().numpy()
        seed_energy = float(seed_res.energy[0])
        found = [seed_coords]
        energies = [seed_energy]
        visits = [0]
        hook("seed", result=seed_res)

    ref_bonds = _host_bonds(seed_coords, z)
    fps = [_sorted_distance_fingerprint(c) for c in found]
    n_rejected = 0
    n_nonfinite = 0

    kick = make_kick_relax(calc, z, config.base_gamma, config.kick_steps)
    kT = KB_HARTREE * config.temperature

    # AFIR pairs drawn from the target atoms only
    if config.target_atoms:
        pool = np.asarray(sorted({int(a) - 1 for a in config.target_atoms}))
        if len(pool) < 2:
            raise ValueError("target_atoms needs at least 2 atoms")
    else:
        pool = np.arange(n)

    prev_rank = None
    no_update = 0
    n_rounds_run = 0
    bsz = config.batch_size
    for rnd in range(config.n_rounds):
        n_rounds_run += 1
        if config.stochastic:
            # Boltzmann + tabu seed selection
            e_arr = np.asarray(energies)
            w = np.exp(-(e_arr - e_arr.min()) / max(kT, 1e-12)
                       - config.tabu_weight * np.asarray(visits))
            w = w / w.sum()
            seeds_idx = rng.choice(len(found), size=bsz, p=w)
        else:
            # every kick starts from the initial EQ
            seeds_idx = np.zeros(bsz, dtype=int)
        for i in seeds_idx:
            visits[i] += 1

        batch = np.stack([found[i] for i in seeds_idx])
        # random atom pairs + push/pull
        pairs = np.stack([rng.choice(pool, size=2, replace=False)
                          for _ in range(bsz)])
        w1 = np.zeros((bsz, n))
        w2 = np.zeros((bsz, n))
        w1[np.arange(bsz), pairs[:, 0]] = 1.0
        w2[np.arange(bsz), pairs[:, 1]] = 1.0
        signs = rng.choice([-1.0, 1.0], size=bsz)

        kick_in = [torch.as_tensor(a, dtype=dtype, device=dev)
                   for a in (batch, w1, w2, signs)]
        kicked = kick(*kick_in)
        hook("kick", round=rnd, seeds_idx=seeds_idx, pairs=pairs,
             signs=signs, batch=kick_in[0], w1=kick_in[1], w2=kick_in[2],
             sign_t=kick_in[3], kicked=kicked)

        relaxed = optimize_batch(calc, kicked, z, config=config.opt,
                                 n_steps=config.relax_steps, device=dev)
        hook("relax", round=rnd, result=relaxed)
        coords_b = relaxed.coords.cpu().numpy()
        e_b = relaxed.energy.cpu().numpy()

        for cand, e in zip(coords_b, e_b):
            if not np.all(np.isfinite(cand)):
                n_nonfinite += 1
                continue
            if config.preserve_bonds:
                if not np.array_equal(_host_bonds(cand, z), ref_bonds):
                    n_rejected += 1
                    continue
            fp = _sorted_distance_fingerprint(cand)
            if _is_duplicate(fp, fps, config.dedupe_threshold):
                continue
            found.append(cand)
            energies.append(float(e))
            fps.append(fp)
            visits.append(0)
        if restart_file:
            save_search_state(restart_file, found, energies, visits)

        # termination: lowest-`number_of_rank` list stable for
        # `number_of_lowest` rounds
        if len(energies) > config.number_of_rank:
            rank = np.sort(np.asarray(energies))[:config.number_of_rank]
            if prev_rank is not None and len(prev_rank) == len(rank) \
                    and np.allclose(rank, prev_rank, atol=0.0):
                no_update += 1
            else:
                no_update = 0
            prev_rank = rank
            if no_update > config.number_of_lowest:
                break

    order = np.argsort(energies)
    return ConfSearchResult(
        conformers=np.stack(found)[order],
        energies=np.asarray(energies)[order],
        n_generated=n_rounds_run * bsz,
        n_rejected_bonds=n_rejected,
        n_nonfinite=n_nonfinite,
    )
