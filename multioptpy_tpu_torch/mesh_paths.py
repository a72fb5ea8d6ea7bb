"""The device mesh on real systems: each sharded run beside its unsharded
counterpart on the same device. Each runner (`*_pair`, `lj_batch_run`)
runs the sharded run first and calls `between()`, if given, before the
unsharded one.

On a mesh of one device repeated k times (`mesh_of(device, k)`), every
shard makes its own launches, so a sharded run takes about k times the
launches of the unsharded one and is held to it number for number:
(a) the sharded band on the full flagship's 16-image initial band (CI-NEB
with FIRE, qsm2 on the gathered band, NEB with the global L-BFGS clock,
ANEB grown between sharded segments); (b) the flagship AutoTS on a mesh
(`chip_smoke.py` runs it); (c) a conformer-search round on n-octane and
slice A's 256 S8 rings through `sharded_optimize_batch`; (d) GPNEB on
Muller-Brown, the mapper's batched AFIR executor on the Diels-Alder
system and `optimize_batch` on an LJ batch. The `mesh` phase of
`chip_smoke.py` runs these on `cuda:0`; with `device="cpu"` they
rehearse on the CPU at small depths, e.g.

    python3 -c "from multioptpy_tpu_torch import mesh_paths as m; \\
        print(m.lj_batch_run('cpu', 2)['max_rel_e_diff'])"
"""

import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from multioptpy_tpu_torch.calculators.lj import LennardJones
from multioptpy_tpu_torch.calculators.model_surfaces import (MB_MIN_A,
                                                             MB_MIN_C,
                                                             MullerBrown)
from multioptpy_tpu_torch.calculators.sqm import SQM, SQM2
from multioptpy_tpu_torch.drivers.gpneb import GPNEBConfig, gpneb
from multioptpy_tpu_torch.drivers.neb import (aneb_sharded, band_clock_init,
                                              interpolate_linear,
                                              make_neb_step, neb_init,
                                              neb_sharded_step,
                                              shard_neb_state)
from multioptpy_tpu_torch.drivers.optimize import (OptimizeConfig,
                                                   optimize_batch)
from multioptpy_tpu_torch.flagship import flagship_config
from multioptpy_tpu_torch.parallel import ensemble_mesh
from multioptpy_tpu_torch.parallel.mesh import sharded_optimize_batch
from multioptpy_tpu_torch.periodic import UFF_VDW_R
from multioptpy_tpu_torch.workflows import confsearch
from multioptpy_tpu_torch.workflows.mapper import (
    make_afir_task_relax, make_sharded_afir_task_relax)

SHARDS = 4              # (a), (c)
PAIR_SHARDS = 2         # (b), (d)
# (b) the full flagship on a mesh, its saddle refinement cut from 120
# steps to 60: on a mesh the candidates run every step in lockstep, where
# the unsharded refinement stops at convergence
FLAGSHIP_SADDLE_STEPS = 60
# (a) the band: iterations of each run; the climbing image from 10
BAND_ITERATIONS = 20
BAND_CLIMB = 10
GATHER_ITERATIONS = 10
LBFGS_ITERATIONS = 8
ANEB_ITERATIONS = 10    # -aneb 1 5: one growth after 5
ANEB_FREQUENCY = 5
CPU_ITERATIONS = 3      # the band's first iterations on the CPU
# (c) one round of 16 n-octane candidates, kick and relaxation cut from
# the command's 60 and 80 steps (to 20 at first, to 10 to keep the phase
# near 150 s: the sharded round makes 4 times the launches); slice A's
# rings, 10 steps
OCTANE_CARBONS = 8
CONF_BATCH = 16
CONF_KICK_STEPS = 10
CONF_RELAX_STEPS = 10
RINGS = 256
RING_STEPS = 10
SQM_LOOSE = dict(max_force=3e-3, rms_force=2e-3, max_displacement=1e-2,
                 rms_displacement=7e-3)
# (d) the graft entry's Muller-Brown GPNEB, two AFIR tasks on the
# flagship's forming bonds, tests/test_parallel.py's LJ batch
GPNEB = dict(n_outer=2, n_inner=10, lengthscale=0.6, dt0=0.05, dt_max=0.2)
AFIR_PAIRS = ((0, 10), (3, 11))
AFIR_GAMMA = 150.0
AFIR_STEPS = 40
LJ_STEPS = 50
LJ_TIGHT = dict(method="rfo_fsb", max_force=1e-6, rms_force=7e-7,
                max_displacement=1e-4, rms_displacement=7e-5)


def mesh_of(device, k):
    """A mesh of `device` repeated k times."""
    return ensemble_mesh(devices=[device] * k)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _clock(device, t0):
    _sync(device)
    return time.perf_counter() - t0


def _shards_on_their_devices(sharded):
    return all(t.device == dev for sh, dev in zip(sharded.shards,
                                                  sharded.mesh.devices)
               for t in sh if isinstance(t, torch.Tensor))


def _between(fn):
    """A pair function's `between()`: called after the sharded run and
    before the unsharded one (the caller reads the sharded run's counters
    there)."""
    if fn is not None:
        fn()


def _gap(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


# --------------------------------------------------------------------------
# (a) the sharded band
# --------------------------------------------------------------------------

def band_config(variant="cineb", optimizer="fire", n_steps=BAND_ITERATIONS):
    """The full flagship's band settings, the climbing image from
    BAND_CLIMB, no redistribution (the sharded band has none)."""
    return dataclasses.replace(
        flagship_config(full=True).neb, variant=variant, optimizer=optimizer,
        n_steps=n_steps, climbing_start=BAND_CLIMB, redistribute="",
        redistribute_every=0)


def flagship_on_a_mesh_config():
    """The full flagship, its saddle refinement cut to
    FLAGSHIP_SADDLE_STEPS."""
    cfg = flagship_config(full=True)
    return dataclasses.replace(cfg, saddle=dataclasses.replace(
        cfg.saddle, nsteps=FLAGSHIP_SADDLE_STEPS))


def sharded_band(calc, path0, z, config, mesh):
    """config.n_steps iterations of `neb_sharded_step`: the gathered final
    state, the energies of every iteration (T, I), seconds, and whether
    every shard's tensors stayed on its device."""
    device = mesh.devices[0]
    step = neb_sharded_step(calc, z, config, mesh)
    state = shard_neb_state(neb_init(path0, config=config, device=device),
                            mesh)
    e_hist, on_device = [], True
    t0 = time.perf_counter()
    for _ in range(config.n_steps):
        state = step(state)
        e_hist.append(torch.cat([s.energies.to(device)
                                 for s in state.shards]))
        on_device &= _shards_on_their_devices(state)
    seconds = _clock(device, t0)
    return (state.gather(), torch.stack(e_hist).cpu().numpy(), seconds,
            on_device)


def plain_band(calc, path0, z, config, device):
    """The unsharded `make_neb_step` loop over the same iterations: the
    final band, the energies of every iteration, the last fmax, seconds."""
    step = make_neb_step(calc, z, config)
    path = path0.to(device)
    clock = band_clock_init(path, config)
    e_hist = []
    t0 = time.perf_counter()
    for it in range(1, config.n_steps + 1):
        path, clock, e, _, fmax = step(path, clock, it)
        e_hist.append(e)
    seconds = _clock(device, t0)
    return path, torch.stack(e_hist).cpu().numpy(), float(fmax), seconds


def band_pair(calc, path0, z, config, device, k=SHARDS, between=None):
    """One band run on a k-shard mesh of `device` and unsharded: times,
    ms per iteration, and the gaps between the two."""
    full, e_sh, s_sh, on_dev = sharded_band(calc, path0, z, config,
                                            mesh_of(device, k))
    _between(between)
    path, e_one, fmax, s_one = plain_band(calc, path0, z, config, device)
    n = config.n_steps
    return {"variant": config.variant, "optimizer": config.optimizer,
            "shards": k, "images_per_shard": path0.shape[0] // k,
            "iterations": n, "sharded_s": s_sh, "unsharded_s": s_one,
            "ms_per_iteration": s_sh / n * 1e3,
            "unsharded_ms_per_iteration": s_one / n * 1e3,
            "ratio": s_sh / s_one,
            "max_abs_e_diff_vs_unsharded": _gap(e_sh, e_one),
            "max_abs_x_diff_vs_unsharded": _gap(full.coords.cpu(),
                                                path.cpu()),
            "fmax_diff_vs_unsharded": abs(float(full.fmax) - fmax),
            "shards_stayed_on_their_devices": on_dev,
            "energies": e_sh, "iteration": int(full.iteration)}


def band_cpu_check(path0, z, card_energies, n=CPU_ITERATIONS):
    """The CI-NEB's first n iterations on the CPU, unsharded (the kernel's
    algorithm for the band): energies against the card's."""
    calc = SQM2(eigh_impl="kernel", device="cpu")
    t0 = time.perf_counter()
    _, e_cpu, _, _ = plain_band(calc, path0.cpu(), z,
                                band_config(n_steps=n), "cpu")
    return {"cpu_rerun_s": time.perf_counter() - t0,
            f"first{n}_max_abs_e_diff_cpu_vs_card": _gap(card_energies[:n],
                                                         e_cpu)}


def aneb_pair(calc, path0, z, device, k=SHARDS, between=None):
    """-aneb 1 5 over ANEB_ITERATIONS through `aneb_sharded` on a k-shard
    mesh and on a one-shard mesh with the same rounding (round_to=k)."""
    cfg = band_config(n_steps=ANEB_ITERATIONS)
    kw = dict(interpolation_num=1, frequency=ANEB_FREQUENCY, max_images=64)
    t0 = time.perf_counter()
    res = aneb_sharded(calc, path0, z, cfg, mesh=mesh_of(device, k),
                       device=device, **kw)
    s_sh = _clock(device, t0)
    _between(between)
    t0 = time.perf_counter()
    one = aneb_sharded(calc, path0, z, cfg, mesh=mesh_of(device, 1),
                       round_to=k, device=device, **kw)
    s_one = _clock(device, t0)
    same = res.path.shape == one.path.shape
    return {"variant": "cineb -aneb 1 5", "shards": k,
            "images_start": path0.shape[0], "images_end": res.path.shape[0],
            "images_per_shard_end": res.path.shape[0] // k,
            "iterations": ANEB_ITERATIONS, "sharded_s": s_sh,
            "unsharded_s": s_one,
            "ms_per_iteration": s_sh / ANEB_ITERATIONS * 1e3,
            "unsharded_ms_per_iteration": s_one / ANEB_ITERATIONS * 1e3,
            "ratio": s_sh / s_one, "same_shape": same,
            "max_abs_e_diff_vs_unsharded": _gap(
                res.energies.cpu(), one.energies.cpu()) if same else None,
            "max_abs_x_diff_vs_unsharded": _gap(
                res.path.cpu(), one.path.cpu()) if same else None,
            "energies": res.energies.cpu().numpy()}


# --------------------------------------------------------------------------
# (c) ensembles
# --------------------------------------------------------------------------

def conf_config(eigh_impl):
    """`confsearch -sqm2 -bsize 16 -ms 1 -pbc --eigh_impl ...` (the
    command's settings), kick and relaxation cut to CONF_KICK_STEPS and
    CONF_RELAX_STEPS."""
    return confsearch.ConfSearchConfig(
        n_rounds=1, batch_size=CONF_BATCH, base_gamma=100.0,
        kick_steps=CONF_KICK_STEPS, relax_steps=CONF_RELAX_STEPS,
        temperature=298.15, preserve_bonds=True, tabu_weight=0.0,
        opt=OptimizeConfig(method="rfo_fsb", eigh_impl=eigh_impl))


def conf_round(calc, coords, z, device, mesh=None, eigh_impl="pallas"):
    """One round from the unrelaxed seed, read from a restart file so that
    no seed relaxation runs: the result, the kick's and the relaxation's
    seconds, and the kick's input and output."""
    stages, marks = {}, [time.perf_counter()]

    def hook(name, **detail):
        _sync(device)
        marks.append(time.perf_counter())
        stages[name] = (marks[-1] - marks[-2], detail)

    e0 = float(calc.energy(torch.as_tensor(coords, device=device)[None],
                           z)[0])
    with tempfile.TemporaryDirectory() as tmp:
        restart = os.path.join(tmp, "seed.npz")
        confsearch.save_search_state(restart, [np.asarray(coords)], [e0],
                                     [0])
        res = confsearch.conformer_search(
            calc, coords, z, conf_config(eigh_impl), restart_file=restart,
            mesh=mesh, device=device, stage_hook=hook)
    return res, stages["kick"][0], stages["relax"][0], stages["kick"][1]


def conf_pair(coords, z, device, k=SHARDS, between=None):
    """The round on a k-shard mesh and unsharded: ms per kick and relax
    step, the ratio, and the gaps between the two searches."""
    calc = SQM2(eigh_impl="pallas", device=device)
    sh, kick_s, relax_s, kick = conf_round(calc, coords, z, device,
                                           mesh_of(device, k))
    _between(between)
    one, kick1, relax1, _ = conf_round(calc, coords, z, device)
    same = len(sh.energies) == len(one.energies)
    return {"shards": k, "members_per_shard": CONF_BATCH // k,
            "kick_steps": CONF_KICK_STEPS, "relax_steps": CONF_RELAX_STEPS,
            "sharded_s": kick_s + relax_s, "unsharded_s": kick1 + relax1,
            "kick_ms_per_step": kick_s / CONF_KICK_STEPS * 1e3,
            "relax_ms_per_step": relax_s / CONF_RELAX_STEPS * 1e3,
            "unsharded_kick_ms_per_step": kick1 / CONF_KICK_STEPS * 1e3,
            "unsharded_relax_ms_per_step": relax1 / CONF_RELAX_STEPS * 1e3,
            "ratio": (kick_s + relax_s) / (kick1 + relax1),
            "conformers": len(sh.energies),
            "unsharded_conformers": len(one.energies),
            "nonfinite": sh.n_nonfinite + one.n_nonfinite,
            "rejected_bonds": [sh.n_rejected_bonds, one.n_rejected_bonds],
            "max_abs_e_diff_vs_unsharded": _gap(sh.energies, one.energies)
            if same else None,
            "max_abs_x_diff_vs_unsharded": _gap(sh.conformers,
                                                one.conformers)
            if same else None,
            "kicked": kick["kicked"]}


def s8_rings(device, n=RINGS):
    """Slice A's perturbed S8 crowns (f32, Bohr)."""
    k = np.arange(8)
    ang = 2 * np.pi * k / 8
    ring = np.stack([4.3 * np.cos(ang), 4.3 * np.sin(ang),
                     0.9 * (-1.0) ** k], axis=-1)
    rng = np.random.default_rng(11)
    return torch.as_tensor(ring[None] + 0.12 * rng.standard_normal(
        (n, 8, 3)), dtype=torch.float32, device=device)


def rings_pair(device, k=SHARDS, n_steps=RING_STEPS, n=RINGS,
               between=None):
    """Slice A's rings (SQM f32, rfo_fsb, an exact initial Hessian) through
    `sharded_optimize_batch` on a k-shard mesh, then unsharded: each
    shard's block of n/k rings through `optimize_batch` alone, and the
    whole batch. ms per step against the whole batch's, and the largest
    relative energy gap of every step against each (on the card an f32
    step depends on the batch it runs in: ROADMAP Queue 3, F12)."""
    eigh = "pallas" if torch.device(device).type == "cuda" else "kernel"
    calc = SQM(eigh_impl=eigh, device=device)
    cfg = OptimizeConfig(method="rfo_fsb", init_hessian="exact",
                         eigh_impl=eigh, **SQM_LOOSE)
    batch, z = s8_rings(device, n), np.full(8, 16)
    t0 = time.perf_counter()
    sh = sharded_optimize_batch(calc, batch, z, mesh=mesh_of(device, k),
                                config=cfg, n_steps=n_steps)
    s_sh = _clock(device, t0)
    _between(between)
    blocks = np.concatenate([optimize_batch(
        calc, part, z, config=cfg, n_steps=n_steps,
        device=device).energy_history for part in batch.chunk(k)], axis=1)
    t0 = time.perf_counter()
    one = optimize_batch(calc, batch, z, config=cfg, n_steps=n_steps,
                         device=device)
    s_one = _clock(device, t0)
    e_sh = sh.energy_history

    def rel(e):
        return (np.abs(e_sh - e) / np.abs(e)).max(1)

    return {"shards": k, "members_per_shard": n // k, "steps": n_steps,
            "sharded_s": s_sh, "unsharded_s": s_one,
            "ms_per_step": s_sh / n_steps * 1e3,
            "unsharded_ms_per_step": s_one / n_steps * 1e3,
            "ratio": s_sh / s_one,
            "max_rel_e_diff_vs_blocks_alone": float(rel(blocks).max()),
            "max_rel_e_diff_vs_whole_batch_by_step": rel(
                one.energy_history).tolist(),
            "finite": bool(np.isfinite(e_sh).all()),
            "energy_fell": bool(np.median(e_sh[-1]) < float(
                calc.energy(batch, z).median()))}


# --------------------------------------------------------------------------
# (d) GPNEB, the mapper's executor, optimize_batch
# --------------------------------------------------------------------------

def gpneb_pair(device, k=PAIR_SHARDS, between=None):
    """The graft entry's Muller-Brown GPNEB (2k images) on a k-shard mesh
    and unsharded."""
    calc = MullerBrown(device=device)
    start = torch.tensor([[MB_MIN_A[0], MB_MIN_A[1], 0.0]], device=device,
                         dtype=torch.float64)
    end = torch.tensor([[MB_MIN_C[0], MB_MIN_C[1], 0.0]], device=device,
                       dtype=torch.float64)
    path0 = interpolate_linear(start, end, 2 * k)
    cfg = GPNEBConfig(**GPNEB)
    t0 = time.perf_counter()
    sh = gpneb(calc, path0, [1], cfg, mesh=mesh_of(device, k), device=device)
    s_sh = _clock(device, t0)
    _between(between)
    t0 = time.perf_counter()
    one = gpneb(calc, path0, [1], cfg, device=device)
    s_one = _clock(device, t0)
    return {"shards": k, "images_per_shard": 2, "sharded_s": s_sh,
            "unsharded_s": s_one, "ratio": s_sh / s_one,
            "true_evaluations": sh.n_true_evaluations,
            "max_abs_e_diff_vs_unsharded": _gap(sh.energies.cpu(),
                                                one.energies.cpu()),
            "max_abs_x_diff_vs_unsharded": _gap(sh.path.cpu(),
                                                one.path.cpu())}


def afir_pair(coords, z, device, k=PAIR_SHARDS, n_steps=AFIR_STEPS,
              between=None):
    """map_network's batched AFIR executor on the Diels-Alder system, one
    task a shard (the flagship's two forming bonds), against the unsharded
    executor: products and trajectories."""
    calc = SQM2(device=device)
    n = len(z)
    w1 = np.zeros((k, n))
    w2 = np.zeros((k, n))
    for t in range(k):
        i, j = AFIR_PAIRS[t % len(AFIR_PAIRS)]
        w1[t, i] = w2[t, j] = 1.0
    inputs = [torch.as_tensor(a, device=device) for a in (
        np.stack([np.asarray(coords)] * k), w1, w2, np.full(k, AFIR_GAMMA))]
    t0 = time.perf_counter()
    prod, traj = make_sharded_afir_task_relax(calc, z, n_steps,
                                              mesh_of(device, k))(*inputs)
    s_sh = _clock(device, t0)
    _between(between)
    t0 = time.perf_counter()
    prod1, traj1 = make_afir_task_relax(calc, z, n_steps)(*inputs)
    s_one = _clock(device, t0)
    return {"shards": k, "tasks_per_shard": 1, "steps": n_steps,
            "sharded_s": s_sh, "unsharded_s": s_one,
            "ms_per_step": s_sh / n_steps * 1e3,
            "unsharded_ms_per_step": s_one / n_steps * 1e3,
            "ratio": s_sh / s_one,
            "max_abs_x_diff_vs_unsharded": max(
                _gap(prod.cpu(), prod1.cpu()), _gap(traj.cpu(),
                                                    traj1.cpu())),
            "finite": bool(torch.isfinite(traj).all())}


def lj_batch(device):
    """tests/test_parallel.py's 16 perturbed Ar3 triangles."""
    rmin = float(UFF_VDW_R[18])
    rng = np.random.default_rng(11)
    base = np.array([[0.0, 0.0, 0.0], [rmin * 1.1, 0.0, 0.0],
                     [rmin * 0.5, rmin * 0.95, 0.05]])
    return torch.as_tensor(np.stack([
        base + 0.1 * rng.standard_normal(base.shape) for _ in range(16)]),
        device=device)


def lj_batch_run(device, k=PAIR_SHARDS, n_steps=LJ_STEPS, between=None):
    """optimize_batch(mesh=) on the LJ batch against the unsharded run."""
    calc = LennardJones(device=device)
    batch, z = lj_batch(device), np.full(3, 18)
    cfg = OptimizeConfig(**LJ_TIGHT)
    t0 = time.perf_counter()
    sh = optimize_batch(calc, batch, z, config=cfg, n_steps=n_steps,
                        mesh=mesh_of(device, k), device=device)
    s_sh = _clock(device, t0)
    _between(between)
    t0 = time.perf_counter()
    one = optimize_batch(calc, batch, z, config=cfg, n_steps=n_steps,
                         device=device)
    s_one = _clock(device, t0)
    e_sh, e_one = sh.energy.cpu().numpy(), one.energy.cpu().numpy()
    return {"shards": k, "members_per_shard": 16 // k, "steps": n_steps,
            "sharded_s": s_sh, "unsharded_s": s_one,
            "ms_per_step": s_sh / n_steps * 1e3,
            "unsharded_ms_per_step": s_one / n_steps * 1e3,
            "ratio": s_sh / s_one,
            "max_rel_e_diff": float((np.abs(e_sh - e_one)
                                     / np.abs(e_one)).max()),
            "converged": int(sh.converged.sum())}
