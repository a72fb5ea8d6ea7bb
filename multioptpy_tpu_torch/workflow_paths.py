"""The workflow commands on real systems, with their CPU reruns.

`confsearch` on n-octane (`alkane_chain(8)`, 26 atoms: the SQM2 band at
D = 104, the RS-RFO Hessian at D = 78, a batch of 16), `relaxedscan`,
`orientsearch` and `run_mapper` on the Diels-Alder system of the
flagship, `run_metadynamics` (a library call: the reference has no
command for it) and `run_autots` with a v2 workflow, through the
commands a user calls wherever one exists, each held to a rerun on the
CPU through the kernel's algorithm (`eigh_impl="kernel"`, the Jacobi
kernel's plain version; the band through LAPACK where a relaxation starts
from an exact Hessian, `reaction_paths.CPU_RERUN_BAND`). The `workflows`
phase of `chip_smoke.py` runs
these on the card; with `device="cpu"` and small depths they rehearse on
the CPU, e.g.

    python3 -c "from multioptpy_tpu_torch import workflow_paths as w; \\
        from multioptpy_tpu_torch.io.fixtures import diels_alder_reactant \\
        as r; x, z = r(); print(w.orientsearch_cpu_check(x, z, 'cpu', 1))"
"""

import contextlib
import dataclasses
import io
import json
import os
import time

import numpy as np
import torch

from multioptpy_tpu_torch import cli
from multioptpy_tpu_torch.calculators.sqm import SQM2
from multioptpy_tpu_torch.drivers.md import MDConfig, run_md
from multioptpy_tpu_torch.drivers.optimize import (OptimizeConfig,
                                                   init_state, make_step_fn,
                                                   optimize, optimize_batch)
from multioptpy_tpu_torch.dynamics_paths import (draws_of_seed,
                                                 timed_and_profiled,
                                                 write_structure)
from multioptpy_tpu_torch.io.xyz import read_trajectory
from multioptpy_tpu_torch.potentials import BiasEngine, get_potential
from multioptpy_tpu_torch.reaction_paths import CPU_RERUN_BAND
from multioptpy_tpu_torch.units import BOHR2ANGSTROM
from multioptpy_tpu_torch.workflows import confsearch, mapper, metadynamics
from multioptpy_tpu_torch.workflows.orientsearch import orientation_samples
from multioptpy_tpu_torch.workflows.relaxed_scan import _constraint_for

OCTANE_CARBONS = 8
CONF_FLAGS = ("-sqm2", "-bsize", "16", "-ms", "2", "-pbc")
# the forming C1-C1' bond of the Diels-Alder reactant, 3.2 -> 1.6 Angstrom
SCAN_FLAGS = ("-sqm2", "-scan", "bond", "1,11", "3.2,1.6", "-nsample", "6",
              "-ns", "10")
ORIENT_FLAGS = ("-sqm2", "-part", "11-18", "-nsample", "16", "-dist", "3.5")
ORIENT_STEPS = 100      # orientation_search's n_opt_steps
METAD_CV = (1, 11)
METAD_HILLS = 4
METAD_EVERY = 10
METAD_CMP_STEPS = 5
# the v2 workflow between the full flagship's IRC endpoints, cut. A band
# of 12 images, climbing from iteration 15, gives a guess from which the
# saddle step refines the flagship's TS (8 images of 30 iterations, the
# v2 NEB's FIRE steps being the reference's larger defaults, slide off
# the barrier's ridge and the refinement falls to the reactant)
V2_WORKFLOW = {
    "workflow": [{"step": "neb", "settings_key": "neb_settings"},
                 {"step": "saddle", "param_override": {"nsteps": 100}},
                 {"step": "freq"},
                 {"step": "irc", "settings_key": "irc_settings"}],
    "neb_settings": {"n_images": 12, "nsteps": 40, "k_spring": 0.01,
                     "climbing_start": 15, "from_path": False},
    "irc_settings": {"irc_method": "lqa", "step_size": 0.12, "nsteps": 15},
}
V2_CMP_ITERATIONS = 2
MAPPER_EXPLORATIONS = 2
MAPPER_AFIR_STEPS = 40


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _relax_calc(device, eigh_impl):
    """SQM2 for a relaxation that starts from an exact Hessian: the band
    through the step's eigensolver on the card, through LAPACK on the CPU
    (`CPU_RERUN_BAND`)."""
    cuda = torch.device(device).type == "cuda"
    return SQM2(eigh_impl=eigh_impl if cuda else CPU_RERUN_BAND,
                device=device)


def _quiet(fn, argv, **kw):
    """fn(argv, **kw) with stdout captured: its lines; raises unless it
    returns 0."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv, **kw)
    if rc != 0:
        raise RuntimeError(f"{argv} exited {rc}")
    return buf.getvalue().strip().splitlines()


def _frames(path):
    _, frames, comments = read_trajectory(path)
    return np.asarray(frames) / BOHR2ANGSTROM, comments


# --------------------------------------------------------------------------
# (a) confsearch on n-octane
# --------------------------------------------------------------------------

def confsearch_run(xyz, device, out, flags=CONF_FLAGS, eigh_impl="pallas"):
    """`confsearch xyz flags --eigh_impl pallas` (the command's function,
    with a stage hook that times each stage and keeps the first round's
    kick inputs and relaxation): seconds, counts, and per-stage times."""
    marks, stages, first = [], [], {}

    def hook(name, **detail):
        _sync(device)
        marks.append(time.perf_counter())
        stages.append(name)
        if detail.get("round") == 0:
            first.update({name: detail})

    argv = [xyz, *flags, "-out", out, "--device", device, "--eigh_impl",
            eigh_impl]
    t0 = time.perf_counter()
    lines = _quiet(cli.run_confsearch, argv, stage_hook=hook)
    seconds = time.perf_counter() - t0
    head, counts = lines[-2], lines[-1]
    n_conf, n_cand = int(head.split()[0]), int(head.split("(")[1].split()[0])
    rej = counts.split()
    times = np.diff([t0] + marks)
    cfg = confsearch.ConfSearchConfig()
    bsz = int(flags[list(flags).index("-bsize") + 1])
    kick_s = [t for s, t in zip(stages, times) if s == "kick"]
    relax_s = [t for s, t in zip(stages, times) if s == "relax"]
    energies = np.loadtxt(os.path.join(out, "EQ_energy.csv"), ndmin=1)
    frames, _ = _frames(os.path.join(out, "conformers.xyz"))
    return {
        "seconds": seconds, "rounds": len(kick_s),
        "unique_conformers": n_conf, "candidates": n_cand,
        "rejected_bonds": int(rej[1]), "nonfinite": int(rej[5]),
        "seed_relax_s": float(times[0]),
        "kick_ms_per_step": float(np.mean(kick_s)) / cfg.kick_steps * 1e3,
        "relax_ms_per_step": float(np.mean(relax_s)) / cfg.relax_steps * 1e3,
        "kick_ms_per_structure_step": float(np.mean(kick_s))
        / (cfg.kick_steps * bsz) * 1e3,
        "relax_ms_per_structure_step": float(np.mean(relax_s))
        / (cfg.relax_steps * bsz) * 1e3,
        "s_per_round": float(np.mean(np.add(kick_s, relax_s))),
        "energies": energies.tolist(),
        "finite": bool(np.isfinite(energies).all()
                       and np.isfinite(frames).all()),
        "first_round": first}


def relax_step_profile(calc, coords_b, z, eigh_impl="pallas"):
    """A warm `optimize_batch` step of the conformer relaxation on the card
    (rfo_fsb on the batch `coords_b`): host ms, device ms, launches, K1
    launches and idle share per step."""
    cfg = OptimizeConfig(method="rfo_fsb", eigh_impl=eigh_impl)
    state = init_state(coords_b, z, calc, None, cfg)
    step = make_step_fn(calc, z, None, cfg)
    state = step(state)
    _, prof = timed_and_profiled(lambda: step(state))
    return prof


def band_check(coords_b, z, device):
    """SQM2 energies of the batch (B,N,3) with the band through K1 against
    the same through torch.linalg.eigh: max |difference| (Ha); with the
    largest off-diagonal K1's sweeps leave on the bands (relative to
    max|a|)."""
    from multioptpy_tpu_torch.flagship import offdiagonal_by_sweeps
    from multioptpy_tpu_torch.ops.eigh64 import jacobi_sweeps_for

    kept = []

    def record(h, sweeps):
        kept.append(h.clone())
        return torch.linalg.eigh(h)

    x = torch.as_tensor(coords_b, device=device)
    e_k1 = SQM2(eigh_impl="pallas", device=device).energy(x, z)
    e_lib = SQM2(eigh_impl="xla", device=device).energy(x, z)
    SQM2(eigh_impl=record, device=device).energy(x, z)
    d = kept[0].shape[-1]
    sweeps = jacobi_sweeps_for(d) + 1
    rows = offdiagonal_by_sweeps(kept, (sweeps - 1, sweeps, sweeps + 2))
    return {"band_d": d, "band_sweeps": sweeps,
            "max_abs_e_diff_k1_vs_eigh": float((e_k1 - e_lib).abs().max()),
            "band_max_rel_offdiagonal": rows[sweeps],
            "band_offdiagonal_by_sweeps": rows}


def rfo_sweep_check(coords_b, z, device, n_steps=5):
    """The RS-RFO Hessians of `n_steps` conformer-relaxation steps of the
    batch, kept by a pass that answers the step's eigensolves with
    torch.linalg.eigh: {sweeps: largest off-diagonal / max|a|} the kernel's
    algorithm leaves, at the step's sweep count and around it."""
    from multioptpy_tpu_torch.flagship import offdiagonal_by_sweeps
    from multioptpy_tpu_torch.ops.eigh64 import (jacobi_sweeps_for,
                                                 rfo_extra_sweeps)

    kept = []

    def record(h, sweeps):
        kept.append(h.clone())
        return torch.linalg.eigh(h)

    x = torch.as_tensor(coords_b, device=device)
    calc = SQM2(device=device)
    optimize_batch(calc, x, z, config=OptimizeConfig(
        method="rfo_fsb", eigh_impl=record), n_steps=n_steps, device=device)
    d = kept[0].shape[-1]
    sweeps = jacobi_sweeps_for(d) + rfo_extra_sweeps(torch.float64)
    rows = offdiagonal_by_sweeps(kept, (8, 12, sweeps - 1, sweeps))
    return {"rfo_d": d, "rfo_batch": int(kept[0].shape[0]),
            "rfo_sweeps": sweeps, "rfo_max_rel_offdiagonal": rows[sweeps],
            "rfo_offdiagonal_by_sweeps": rows}


def kick_and_relax(first, z, device, n_members=2, kick_steps=5,
                   relax_steps=2, gamma=100.0, eigh_impl="pallas"):
    """The first round's first `kick_steps` kick steps (SQM2 energies of
    each step's geometry) and first `relax_steps` + 1 relaxation energies
    of `n_members` members, from that round's inputs `first` (the
    confsearch_run hook's), on `device`: the RS-RFO step through
    `eigh_impl`, the band as `_relax_calc` takes it."""
    calc = _relax_calc(device, eigh_impl)
    kick = first["kick"]
    inputs = [torch.as_tensor(kick[k][:n_members].cpu().numpy(),
                              device=device)
              for k in ("batch", "w1", "w2", "sign_t")]
    frames = []
    confsearch.make_kick_relax(calc, z, gamma, kick_steps)(
        *inputs, record=lambda k, x: frames.append(x))
    kick_e = torch.stack([calc.energy(x, z) for x in frames]).cpu().numpy()
    start = torch.as_tensor(kick["kicked"][:n_members].cpu().numpy(),
                            device=device)
    res = optimize_batch(calc, start, z, config=OptimizeConfig(
        method="rfo_fsb", eigh_impl=eigh_impl), n_steps=relax_steps,
        device=device)
    relax_e = np.concatenate([calc.energy(start, z).cpu().numpy()[None],
                              res.energy_history])
    return {"kick_energies": kick_e,
            "kick_coords": torch.stack(frames).cpu().numpy(),
            "relax_energies": relax_e}


def card_relax_energies(first, z, device, n_members=2, n_steps=2):
    """The confsearch run's own first relaxation energies of `n_members`
    members (the hook's): E(kicked), then its first `n_steps` steps."""
    calc = SQM2(device=device)
    kicked = first["kick"]["kicked"][:n_members]
    hist = first["relax"]["result"].energy_history[:n_steps, :n_members]
    return np.concatenate([calc.energy(kicked, z).cpu().numpy()[None], hist])


# --------------------------------------------------------------------------
# (b) relaxedscan on the Diels-Alder reactant
# --------------------------------------------------------------------------

def relaxedscan_run(xyz, device, out, flags=SCAN_FLAGS, eigh_impl="pallas"):
    """`relaxedscan xyz flags` through cli.main: seconds, the scan's
    energies, and how far each point's constrained bond is from its
    target (Angstrom)."""
    flags = list(flags)
    i = flags.index("-scan")
    _, atoms, span = flags[i + 1:i + 4]
    a, b = (int(k) - 1 for k in atoms.split(","))
    start, stop = (float(v) for v in span.split(","))
    n = int(flags[flags.index("-nsample") + 1])
    argv = ["relaxedscan", xyz, *flags, "-out", out, "--device", device,
            "--eigh_impl", eigh_impl]
    t0 = time.perf_counter()
    _quiet(cli.main, argv)
    _sync(device)
    seconds = time.perf_counter() - t0
    frames, _ = _frames(os.path.join(out, "scan.xyz"))
    prof = np.loadtxt(os.path.join(out, "energy_profile.csv"), delimiter=",",
                      ndmin=2)
    d = np.linalg.norm(frames[:, a] - frames[:, b], axis=-1) * BOHR2ANGSTROM
    return {"seconds": seconds, "points": len(frames),
            "s_per_point": seconds / len(frames),
            "energies": prof[:, -1].tolist(),
            "finite": bool(np.isfinite(prof).all()
                           and np.isfinite(frames).all()),
            "max_constraint_dev_ang": float(np.abs(
                d - np.linspace(start, stop, n)).max())}


def scan_first_point(coords, z, device, flags=SCAN_FLAGS, n_steps=2,
                     eigh_impl="pallas"):
    """The first scan point's constrained optimization, cut to `n_steps`
    steps: its energies (eigensolvers as in `kick_and_relax`)."""
    flags = list(flags)
    i = flags.index("-scan")
    kind, atoms, span = flags[i + 1:i + 4]
    value = float(span.split(",")[0])
    from multioptpy_tpu_torch.constraints import Constraints
    cons = Constraints(**_constraint_for(kind, cli.num_parse(atoms), value))
    res = optimize(_relax_calc(device, eigh_impl),
                   torch.as_tensor(np.asarray(coords)), z,
                   config=OptimizeConfig(nsteps=n_steps, eigh_impl=eigh_impl),
                   constraints=cons, device=device)
    return res.energy_history


# --------------------------------------------------------------------------
# (c) orientsearch on the Diels-Alder reactant
# --------------------------------------------------------------------------

def orientsearch_run(xyz, device, out, flags=ORIENT_FLAGS,
                     eigh_impl="pallas"):
    """`orientsearch xyz flags` through cli.main: seconds and the sorted
    energies."""
    argv = ["orientsearch", xyz, *flags, "-out", out, "--device", device,
            "--eigh_impl", eigh_impl]
    t0 = time.perf_counter()
    _quiet(cli.main, argv)
    _sync(device)
    seconds = time.perf_counter() - t0
    frames, comments = _frames(os.path.join(out, "orientations.xyz"))
    e = np.array([float(c.split("=")[1]) for c in comments])
    return {"seconds": seconds, "samples": len(e),
            "ms_per_step": seconds / ORIENT_STEPS * 1e3,
            "energies": e.tolist(),
            "finite": bool(np.isfinite(e).all() and np.isfinite(frames).all()),
            "sorted": bool(np.all(np.diff(e) >= 0))}


def orientsearch_first_steps(coords, z, device, flags=ORIENT_FLAGS,
                             n_members=2, n_steps=2, eigh_impl="pallas"):
    """The first `n_members` placements of the search (the same numpy
    draws) relaxed `n_steps` steps: E(start) and each step's energies
    (eigensolvers as in `kick_and_relax`)."""
    flags = list(flags)
    frag = cli.num_parse(flags[flags.index("-part") + 1])
    n = int(flags[flags.index("-nsample") + 1])
    dist = float(flags[flags.index("-dist") + 1])
    starts = orientation_samples(np.asarray(coords), frag, n, 2.0, 0,
                                 dist)[:n_members]
    calc = _relax_calc(device, eigh_impl)
    x = torch.as_tensor(starts, device=device)
    res = optimize_batch(calc, x, z, config=OptimizeConfig(
        eigh_impl=eigh_impl), n_steps=n_steps, device=device)
    return np.concatenate([calc.energy(x, z).cpu().numpy()[None],
                           res.energy_history])


def orientsearch_cpu_check(coords, z, device, n_cmp=2):
    """orientsearch_first_steps on `device` against the CPU (the RS-RFO
    step through the kernel's algorithm, the band through LAPACK):
    max |difference| (Ha)."""
    a = orientsearch_first_steps(coords, z, device, n_members=n_cmp)
    b = orientsearch_first_steps(coords, z, "cpu", n_members=n_cmp,
                                 eigh_impl="kernel")
    return float(np.abs(a - b).max())


# --------------------------------------------------------------------------
# (d) metadynamics (library)
# --------------------------------------------------------------------------

def metadynamics_config(n_hills=METAD_HILLS, every=METAD_EVERY):
    return metadynamics.MetadynamicsConfig(
        md=MDConfig(thermostat="langevin", temperature=300.0,
                    timestep_fs=0.5, seed=0),
        height_kjmol=2.0, width_ang=0.2, deposit_every=every,
        n_hills=n_hills, cv_atom_pair=METAD_CV)


def metadynamics_run(coords, z, device, cfg=None):
    """run_metadynamics on SQM2 (band eigh through K1 on the card): seconds,
    the CV history and the free-energy grid."""
    cfg = cfg or metadynamics_config()
    t0 = time.perf_counter()
    res = metadynamics.run_metadynamics(
        SQM2(device=device), torch.as_tensor(np.asarray(coords)), z, cfg,
        device=device)
    _sync(device)
    seconds = time.perf_counter() - t0
    steps = cfg.n_hills * cfg.deposit_every
    return {"seconds": seconds, "steps": steps,
            "ms_per_step": seconds / steps * 1e3,
            "cv_history_bohr": res.cv_history.tolist(),
            "finite": bool(np.isfinite(res.trajectory).all()
                           and np.isfinite(res.cv_history).all()
                           and np.isfinite(res.free_energy).all()),
            "free_energy_min_kjmol": float(res.free_energy.min())}


def metadynamics_first_steps(coords, z, device, velocities, noise,
                             n_steps=METAD_CMP_STEPS, eigh_impl="auto"):
    """The first chunk's first `n_steps` MD steps (no hill deposited yet)
    from `velocities` and Langevin `noise`: (energies, trajectory)."""
    cfg = metadynamics_config()
    pot = get_potential("gaussian_metadyn", height_kjmol=cfg.height_kjmol,
                        width_ang=cfg.width_ang,
                        atom_pair=list(cfg.cv_atom_pair),
                        max_hills=cfg.n_hills + 1)
    calc = SQM2(eigh_impl=eigh_impl, device=device)
    res = run_md(calc, torch.as_tensor(np.asarray(coords)), z,
                 dataclasses.replace(cfg.md, n_steps=n_steps),
                 bias_engine=BiasEngine([pot]),
                 velocities=torch.as_tensor(velocities.cpu().numpy()),
                 noise=noise.cpu(), device=device)
    return res.energies, res.trajectory


def metadynamics_cpu_check(coords, z, device, n_steps=METAD_CMP_STEPS):
    """The first steps on `device` from the initial velocities and draws a
    run on `device` takes (its generator), against the CPU from the same:
    (max |dE| Ha, max |dx| Bohr)."""
    v0, noise = draws_of_seed(z, len(z), n_steps, device, seed=0)
    e_a, x_a = metadynamics_first_steps(coords, z, device, v0, noise,
                                        n_steps)
    e_b, x_b = metadynamics_first_steps(coords, z, "cpu", v0, noise, n_steps,
                                        eigh_impl="kernel")
    return float(np.abs(e_a - e_b).max()), float(np.abs(x_a - x_b).max())


# --------------------------------------------------------------------------
# (e) run_autots with a v2 workflow
# --------------------------------------------------------------------------

def autots_v2_run(r_xyz, p_xyz, device, out, workflow=None,
                  eigh_impl=None):
    """`run_autots r_xyz -prod p_xyz -sqm2 -cfg v2.json` (the command's
    function, with a stage hook that keeps each step's seconds and the
    NEB's band energies): seconds, the step reports, whether ts.xyz was
    written, and the band energies of every NEB iteration."""
    os.makedirs(out, exist_ok=True)
    cfg_path = os.path.join(out, "v2.json")
    with open(cfg_path, "w") as f:
        json.dump(workflow or V2_WORKFLOW, f)
    marks, neb_e = [], []

    def hook(name, report, result):
        _sync(device)
        marks.append((name, time.perf_counter()))
        if name == "neb":
            neb_e.append(np.asarray(result.energy_history))

    argv = [r_xyz, "-prod", p_xyz, "-sqm2", "-cfg", cfg_path, "-out", out,
            "--device", device]
    if eigh_impl:
        argv += ["--eigh_impl", eigh_impl]
    t0 = time.perf_counter()
    _quiet(cli.run_autots_cli, argv, stage_hook=hook)
    seconds = time.perf_counter() - t0
    with open(os.path.join(out, "workflow_report.json")) as f:
        reports = json.load(f)
    times = np.diff([t0] + [t for _, t in marks])
    return {"seconds": seconds, "reports": reports,
            "steps": [r["step"] for r in reports],
            "step_seconds": [float(t) for t in times],
            "ts_written": os.path.isfile(os.path.join(out, "ts.xyz")),
            "neb_energies": neb_e[0] if neb_e else None}


def v2_neb_cpu_rerun(r_xyz, p_xyz, out, n_steps=V2_CMP_ITERATIONS,
                     workflow=None):
    """The workflow's NEB step alone, cut to `n_steps` iterations, through
    the same command on the CPU (the band through the kernel's
    algorithm): its band energies, one row an iteration."""
    wf = dict(workflow or V2_WORKFLOW)
    neb_entry = next(e for e in wf["workflow"] if e["step"] == "neb")
    wf["workflow"] = [{**neb_entry, "param_override": {"nsteps": n_steps}}]
    return autots_v2_run(r_xyz, p_xyz, "cpu", out, wf,
                         eigh_impl="kernel")["neb_energies"]


# --------------------------------------------------------------------------
# (f) run_mapper on the Diels-Alder reactant
# --------------------------------------------------------------------------

def mapper_cfg(explorations=MAPPER_EXPLORATIONS,
               afir_steps=MAPPER_AFIR_STEPS):
    """The run's config in the command's {"mapper": {...}} form: the
    batched executor (batch_size 2, `afir_steps` FIRE steps) and
    `explorations` tasks; each task's AutoTS at MapperConfig's defaults
    (the form sets scalar fields only)."""
    return {"mapper": {"batch_size": 2, "afir_steps": afir_steps,
                       "max_explorations": explorations,
                       "afir_gamma": 150.0, "seed": 0}}


def mapper_run(xyz, device, out, eigh_impl="pallas", **kw):
    """`run_mapper xyz -sqm2 -cfg mapper.json` (the command's function, with
    a stage hook that keeps the executor's inputs and each task's
    imaginary-mode count), then `run_mapper --resume --max_iter 0` through
    cli.main to read the network back: seconds, nodes, edges, the tasks
    skipped for an error and those whose TS had another count than one,
    the resumed count, and kinetic_priorities on the network."""
    from multioptpy_tpu_torch.workflows.kinetics import kinetic_priorities

    batches, tasks = [], []

    def hook(name, **detail):
        (batches if name == "afir_batch" else tasks).append(detail)

    os.makedirs(out, exist_ok=True)
    cfg = mapper_cfg(**kw)
    cfg_path = os.path.join(out, "mapper.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    argv = [xyz, "-sqm2", "-cfg", cfg_path, "-out", out, "--device", device,
            "--eigh_impl", eigh_impl]
    t0 = time.perf_counter()
    lines = _quiet(cli.run_mapper_cli, argv, stage_hook=hook)
    _sync(device)
    seconds = time.perf_counter() - t0
    net_path = os.path.join(out, "network.json")
    net = mapper.Network.load(net_path)
    resumed = _quiet(cli.main, ["run_mapper", xyz, "-sqm2", "-cfg", cfg_path,
                                "--resume", net_path, "--max_iter", "0",
                                "-out", os.path.join(out, "resumed"),
                                "--device", device])
    pri = kinetic_priorities(net)
    n_tasks = cfg["mapper"]["max_explorations"]
    return {"seconds": seconds, "tasks": n_tasks,
            "s_per_task": seconds / n_tasks,
            "nodes": len(net.nodes), "edges": len(net.edges),
            "node_energies": [n.energy for n in net.nodes],
            "skipped_for_error": int(lines[-1].split()[2]),
            "skipped_line": lines[-1],
            "task_n_imaginary": [t["n_imaginary"] for t in tasks],
            "dropped_for_n_imaginary": sum(t["n_imaginary"] != 1
                                           for t in tasks),
            "network_json": os.path.isfile(net_path),
            "resumed": resumed[-2],
            "resumed_nodes": int(resumed[-2].split()[1]),
            "kinetic_priorities": pri.tolist(),
            "priorities_finite": bool(np.isfinite(pri).all()),
            "afir_batches": batches}


def afir_executor_first_steps(batch, z, device, n_steps=3,
                              eigh_impl="auto"):
    """The batched AFIR executor cut to `n_steps` steps from the inputs of
    the run's first batch (its hook's): SQM2 energies after each step."""
    calc = SQM2(eigh_impl=eigh_impl, device=device)
    inputs = [torch.as_tensor(batch[k].cpu().numpy(), device=device)
              for k in ("coords", "w1", "w2", "gamma")]
    _, traj = mapper.make_afir_task_relax(calc, z, n_steps, 1)(*inputs)
    return torch.stack([calc.energy(traj[:, k], z)
                        for k in range(n_steps)]).cpu().numpy()


def write_pair(work, reactant, product, z):
    """The flagship's IRC endpoints as xyz files."""
    return (write_structure(os.path.join(work, "irc_reactant.xyz"), reactant,
                            z),
            write_structure(os.path.join(work, "irc_product.xyz"), product, z))
