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
slice A's 256 S8 rings through `sharded_optimize_batch`, and the F12
probes (`batch_probe`, `ring_step_probe`, `op_probe`: does a member's
result depend on its batch?); (d) GPNEB on Muller-Brown, the mapper's
batched AFIR executor on the Diels-Alder system and `optimize_batch` on
an LJ batch; (e) the tensor-parallel SQM2 gradient (`tp_*`): one large
molecule's pair builds split in row blocks over the shards. The `mesh` phase of
`chip_smoke.py` runs these on `cuda:0`; with `device="cpu"` they
rehearse on the CPU at small depths, e.g.

    python3 -c "from multioptpy_tpu_torch import mesh_paths as m; \\
        print(m.lj_batch_run('cpu', 2)['max_rel_e_diff'])"
"""

import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch

from multioptpy_tpu_torch.calculators.lj import LennardJones
from multioptpy_tpu_torch.calculators.model_surfaces import (MB_MIN_A,
                                                             MB_MIN_C,
                                                             MullerBrown)
from multioptpy_tpu_torch.calculators.sqm import SQM, SQM2
from multioptpy_tpu_torch.device import bmv
from multioptpy_tpu_torch.drivers.gpneb import GPNEBConfig, gpneb
from multioptpy_tpu_torch.drivers.neb import (aneb_sharded, band_clock_init,
                                              interpolate_linear,
                                              make_neb_step, neb_init,
                                              neb_sharded_step,
                                              shard_neb_state)
from multioptpy_tpu_torch.drivers.optimize import (OptimizeConfig, optimize,
                                                   optimize_batch)
from multioptpy_tpu_torch.flagship import flagship_config
from multioptpy_tpu_torch.io.fixtures import alkane_chain
from multioptpy_tpu_torch.parallel import ensemble_mesh
from multioptpy_tpu_torch.parallel.mesh import (sharded_optimize_batch,
                                                tp_energy_and_gradient)
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
# (e) the tensor-parallel SQM2 gradient (f64): the 98-atom C32H66 on 1, 2
# and 4 shards, the median of TP_REPS gradients each; TP_STEPS rfo_fsb steps
# of it on 2 shards from the default model Hessian; n-octane, whose
# 104-wide band is the Jacobi kernel's, on 2 shards
TP_CARBONS = 32
TP_SHARDS = (1, 2, 4)
TP_REPS = 10
TP_STEPS = 5


def mesh_of(device, k, axis="batch"):
    """A mesh of `device` repeated k times."""
    return ensemble_mesh(devices=[device] * k, axis=axis)


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


def rings_setup(device):
    """Slice A's calculator and configuration: SQM f32, rfo_fsb, an exact
    initial Hessian, the Jacobi kernel (its plain version on the CPU)."""
    eigh = "pallas" if torch.device(device).type == "cuda" else "kernel"
    return (SQM(eigh_impl=eigh, device=device),
            OptimizeConfig(method="rfo_fsb", init_hessian="exact",
                           eigh_impl=eigh, **SQM_LOOSE))


def rings_pair(device, k=SHARDS, n_steps=RING_STEPS, n=RINGS,
               between=None):
    """Slice A's rings (SQM f32, rfo_fsb, an exact initial Hessian) through
    `sharded_optimize_batch` on a k-shard mesh, then unsharded: each
    shard's block of n/k rings through `optimize_batch` alone, and the
    whole batch. ms per step against the whole batch's, and the largest
    relative energy gap of every step against each (ROADMAP Queue 3,
    F12: before the step paths took `device.bmv`, an f32 step on the card
    depended on the batch it ran in)."""
    calc, cfg = rings_setup(device)
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
# (c) F12: does a member's result depend on the batch it runs in?
# --------------------------------------------------------------------------

# the step paths' widths: the S8 RFO step and band (f32), the Diels-Alder
# RFO step and band and the n-octane band (f64); the batches compared
PROBE_WIDTHS = ((24, torch.float32), (32, torch.float32),
                (54, torch.float64), (72, torch.float64),
                (104, torch.float64))
PROBE_BATCHES = (1, 64, 256)


def _matmul_mv(a, x):
    return (a @ x[..., None])[..., 0]


# the matrix-vector forms: the step paths' before F12 was repaired, and
# the helper that replaced it
MATVEC_FORMS = {"matmul": _matmul_mv, "bmv": bmv}


def _batch_gaps(fn, *args, batches=PROBE_BATCHES):
    """fn on the whole batch and on its first b members for each smaller b
    in `batches`: {b: max |part - whole[:b]|} (0.0: equal to the bit)."""
    whole = fn(*args)
    out = {}
    for b in batches[:-1]:
        part = fn(*(x[:b].clone() for x in args))
        out[b] = float((part - whole[:b]).abs().max())
    return out


def batch_probe(device, forms=MATVEC_FORMS):
    """Each matrix-vector form, as is and on a transposed view (a.mT @ x,
    as the RFO step's v.mT @ g), and the dot product (x * y).sum(-1), at
    every width of PROBE_WIDTHS on a batch of PROBE_BATCHES[-1] random
    members: the largest gap of the first b members computed alone to the
    same members inside the batch, for each smaller batch b."""
    gen = torch.Generator().manual_seed(12)
    n = PROBE_BATCHES[-1]
    rows = []
    for d, dtype in PROBE_WIDTHS:
        a, x, y = (torch.randn(n, *shape, generator=gen, dtype=torch.float64)
                   .to(dtype).to(device) for shape in ((d, d), (d,), (d,)))
        row = {"d": d, "dtype": str(dtype).split(".")[-1]}
        for name, fn in forms.items():
            row[name] = _batch_gaps(fn, a, x)
            row[name + "_transposed"] = _batch_gaps(
                lambda m, v, fn=fn: fn(m.mT, v), a, x)
        row["dot"] = _batch_gaps(lambda u, v: (u * v).sum(-1), x, y)
        rows.append(row)
    _sync(device)
    return rows


def ring_step_probe(device, n=RINGS, sub=64, n_steps=2):
    """Slice A's step path (SQM f32, rfo_fsb, an exact initial Hessian,
    the Jacobi kernel) on n rings, on their first `sub` and on the first
    ring alone: after init_state and after each of `n_steps` steps, every
    tensor of the OptState, {field: [gap of the sub-batch, gap of the
    ring alone]} against the same members of the whole batch."""
    from multioptpy_tpu_torch.drivers.optimize import init_state, make_step_fn

    calc, cfg = rings_setup(device)
    batch, z = s8_rings(device, n), np.full(8, 16)
    step = make_step_fn(calc, z, None, cfg)
    states = [init_state(batch[:k].clone(), z, calc, None, cfg)
              for k in (n, sub, 1)]
    out = []
    for it in range(n_steps + 1):
        row = {"step": it}
        leaves = [_tensor_leaves(s) for s in states]
        for name, whole in leaves[0].items():
            row[name] = [_gap(leaves[j][name].float().cpu(),
                              whole[:k].float().cpu())
                         for j, k in ((1, sub), (2, 1))]
        out.append(row)
        if it < n_steps:
            states = [step(s) for s in states]
    _sync(device)
    return out


def op_probe(device, n=RINGS, subs=(64, 16, 1), limit=12):
    """Slice A's step, op by op: one rfo_fsb step of the n rings' initial
    state and of its first k members for each k in `subs` (sliced from the
    same state, so every run starts from equal tensors), each aten op's
    inputs and outputs recorded (torch's dispatch mode sees no ctypes
    launch; the Jacobi kernel's outputs show as the next op's inputs). For
    each k, the first `limit` ops whose outputs differ from the whole
    batch's on the same members: {"i", "op", "out_gap", "in_gap",
    "shapes", "site"} (the port's file:line that made the op; an op
    whose outputs lose the batch axis, a sum over the members, is not
    compared); an op with in_gap 0.0 and out_gap > 0 depends on its
    batch."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from multioptpy_tpu_torch.drivers.optimize import (init_state,
                                                       make_step_fn,
                                                       tree_map)

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ins = [t.detach().clone() for t in _flat(args)]
            out = func(*args, **(kwargs or {}))
            if "empty" not in str(func):
                self.ops.append((str(func), ins, [t.detach().clone()
                                                  for t in _flat(out)],
                                 _call_site()))
            return out

    calc, cfg = rings_setup(device)
    z = np.full(8, 16)
    state = init_state(s8_rings(device, n), z, calc, None, cfg)
    step = make_step_fn(calc, z, None, cfg)
    runs = {}
    for k in (n, *subs):
        part = tree_map(lambda t, k=k: t[:k].clone(), state)
        with Recorder() as rec:
            step(part)
        _sync(device)
        runs[k] = rec.ops
    out = {}
    for k in subs:
        found = []
        for i, (whole, mine) in enumerate(zip(runs[n], runs[k])):
            if whole[0] != mine[0]:
                found.append({"i": i, "op": f"{whole[0]} / {mine[0]}",
                              "diverged": True})
                break
            mixes = (any(a.shape != b.shape for a, b in zip(whole[1],
                                                             mine[1]))
                     and all(a.shape == b.shape for a, b in zip(whole[2],
                                                                mine[2])))
            g_out = None if mixes else _aligned_gap(whole[2], mine[2], n, k)
            if g_out:
                found.append({"i": i, "op": whole[0], "out_gap": g_out,
                              "in_gap": _aligned_gap(whole[1], mine[1], n,
                                                     k),
                              "shapes": [list(t.shape) for t in mine[1]],
                              "site": mine[3]})
                if len(found) >= limit:
                    break
        out[k] = {"ops": len(runs[k]), "whole_ops": len(runs[n]),
                  "first_differing": found}
    return out


def _call_site():
    """file:line of the innermost frame of the port (outside this file)
    on the stack."""
    frame = sys._getframe(1)
    while frame is not None:
        name = frame.f_code.co_filename
        if "multioptpy_tpu_torch" in name and not name.endswith(
                "mesh_paths.py"):
            return f"{name[name.rindex('multioptpy_tpu_torch'):]}:" \
                   f"{frame.f_lineno}"
        frame = frame.f_back
    return None


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _flat(x)]
    return []


def _aligned_gap(whole, mine, n, k):
    """The largest |whole - mine| over the members of `mine` (each tensor
    of `whole` sliced to k along the first axis where it holds n and
    `mine` holds k; None where the shapes do not align)."""
    gap = 0.0
    for a, b in zip(whole, mine):
        if a.shape != b.shape:
            axes = [d for d in range(a.ndim) if b.ndim == a.ndim
                    and a.shape[d] == n and b.shape[d] == k]
            if not axes:
                return None
            a = a.narrow(axes[0], 0, k)
            if a.shape != b.shape:
                return None
        if a.numel() and a.dtype.is_floating_point:
            d = (a.double() - b.double()).abs()
            gap = max(gap, float(torch.nan_to_num(d, nan=0.0).max()))
        elif a.numel() and not torch.equal(a, b):
            gap = max(gap, 1.0)
    return gap


def _tensor_leaves(state):
    """{name: tensor} of an OptState, fo_state's tensors as fo_state_i."""
    out = {}
    for name, val in state._asdict().items():
        if name == "fo_state":
            for i, t in enumerate(val):
                if isinstance(t, torch.Tensor):
                    out[f"fo_state_{i}"] = t
        elif isinstance(val, torch.Tensor) and val.ndim > 0:
            out[name] = val
    return out


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


# --------------------------------------------------------------------------
# (e) the tensor-parallel SQM2 gradient
# --------------------------------------------------------------------------

def tp_rows(n, k):
    """The atom rows of each of k shards (torch.tensor_split)."""
    return [len(r) for r in torch.arange(n).tensor_split(k)]


def _timed(device, fn, reps):
    """fn() once to warm, then `reps` calls, each to the card's end: the
    last result and the median ms a call (the host shares its cores)."""
    out = fn()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ms.append(_clock(device, t0) * 1e3)
    return out, float(np.median(ms))


def tp_gradient_runs(device, carbons=TP_CARBONS, shards=TP_SHARDS,
                     reps=TP_REPS, between=None):
    """tp_energy_and_gradient of alkane_chain(carbons) (SQM2 f64, the
    default band eigensolver) on a k-shard "tp" mesh of `device` for each
    k in `shards`, then unsharded: ms per gradient and the gaps to the
    unsharded result. `between()` runs after the sharded runs."""
    coords, z = alkane_chain(carbons)
    calc = SQM2(device=device)
    x = torch.as_tensor(coords, device=device)
    runs = []
    for k in shards:
        mesh = mesh_of(device, k, "tp")
        (e, g), ms = _timed(device, lambda: tp_energy_and_gradient(
            calc, x, z, mesh=mesh), reps)
        runs.append({"shards": k, "rows_per_shard": tp_rows(len(z), k),
                     "ms_per_gradient": ms, "energy": float(e),
                     "gradient": g, "unsharded_after": calc.tp_mesh is None})
    _between(between)
    (e1, g1), ms1 = _timed(device, lambda: calc.energy_and_gradient(
        x[None], z), reps)
    for run in runs:
        g = run.pop("gradient")
        run.update(unsharded_ms_per_gradient=ms1,
                   ratio=run["ms_per_gradient"] / ms1,
                   abs_e_diff_vs_unsharded=abs(run["energy"] - float(e1[0])),
                   max_abs_g_diff_vs_unsharded=_gap(g.cpu(), g1[0].cpu()))
    return {"atoms": len(z), "band": 4 * len(z), "reps": reps,
            "energy": float(e1[0]), "gradient": g1[0].cpu(), "runs": runs}


def tp_cpu_check(card_energy, card_gradient, carbons=TP_CARBONS):
    """The port's unsharded SQM2 gradient of alkane_chain(carbons) on the
    CPU against the card's."""
    coords, z = alkane_chain(carbons)
    t0 = time.perf_counter()
    e, g = SQM2(device="cpu").energy_and_gradient(
        torch.as_tensor(coords)[None], z)
    return {"cpu_s": time.perf_counter() - t0,
            "abs_e_diff_cpu_vs_card": abs(float(e[0]) - card_energy),
            "max_abs_g_diff_cpu_vs_card": _gap(g[0], card_gradient)}


def tp_optimize_pair(device, k=PAIR_SHARDS, n_steps=TP_STEPS,
                     carbons=TP_CARBONS, between=None):
    """n_steps rfo_fsb steps of alkane_chain(carbons) through `optimize`
    from the default model Hessian (Lindh) with SQM2(tp_mesh=k shards),
    then unsharded: ms per step and the gaps. Both runs stop early only
    where `optimize` does (convergence)."""
    coords, z = alkane_chain(carbons)
    cfg = OptimizeConfig(method="rfo_fsb", nsteps=n_steps,
                         init_hessian="model:lindh")
    tp_calc = SQM2(device=device, tp_mesh=mesh_of(device, k, "tp"),
                   tp_axis="tp")
    # one step first, untimed: the first model Hessian pays torch's lazy
    # imports (~3 s)
    optimize(tp_calc, coords, z, device=device,
             config=dataclasses.replace(cfg, nsteps=1))
    t0 = time.perf_counter()
    tp = optimize(tp_calc, coords, z, config=cfg, device=device)
    s_tp = _clock(device, t0)
    _between(between)
    t0 = time.perf_counter()
    one = optimize(SQM2(device=device), coords, z, config=cfg, device=device)
    s_one = _clock(device, t0)
    same = len(tp.energy_history) == len(one.energy_history)
    return {"shards": k, "rows_per_shard": tp_rows(len(z), k),
            "steps": tp.n_iterations, "unsharded_steps": one.n_iterations,
            "sharded_s": s_tp, "unsharded_s": s_one,
            "ms_per_step": s_tp / max(tp.n_iterations, 1) * 1e3,
            "unsharded_ms_per_step": s_one / max(one.n_iterations, 1) * 1e3,
            "ratio": s_tp / s_one,
            "max_abs_e_diff_vs_unsharded": _gap(tp.energy_history,
                                                one.energy_history)
            if same else None,
            "max_abs_x_diff_vs_unsharded": _gap(tp.coords.cpu(),
                                                one.coords.cpu()),
            "energies": np.asarray(tp.energy_history).tolist()}


def tp_octane_pair(device, k=PAIR_SHARDS, reps=TP_REPS, between=None):
    """tp_energy_and_gradient of n-octane (26 atoms, band 104 f64: the
    Jacobi kernel's on the card) on k shards, then unsharded."""
    coords, z = alkane_chain(OCTANE_CARBONS)
    calc = SQM2(device=device)
    x = torch.as_tensor(coords, device=device)
    (e, g), ms = _timed(device, lambda: tp_energy_and_gradient(
        calc, x, z, mesh=mesh_of(device, k, "tp")), reps)
    _between(between)
    (e1, g1), ms1 = _timed(device, lambda: calc.energy_and_gradient(
        x[None], z), reps)
    return {"atoms": len(z), "band": 4 * len(z), "shards": k,
            "rows_per_shard": tp_rows(len(z), k), "reps": reps,
            "ms_per_gradient": ms, "unsharded_ms_per_gradient": ms1,
            "ratio": ms / ms1,
            "abs_e_diff_vs_unsharded": abs(float(e) - float(e1[0])),
            "max_abs_g_diff_vs_unsharded": _gap(g.cpu(), g1[0].cpu())}
