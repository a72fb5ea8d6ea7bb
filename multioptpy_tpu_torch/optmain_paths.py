"""optmain's analyses and outputs and the other calculators on real
systems, with their CPU reruns.

The Diels-Alder system of the flagship (18 atoms, SQM2 f64): `optmain
-freq` and `-force_freq` (normal modes, RRHO, the mode files, the point
group, -cmds/-pca/-km, -gi), the SQM orbitals and natural reaction
orbitals, ONIOM (`-oniom`, `-mi`), a two-state seam (`-mf`), fragment-
averaged gradients under a bias (`-of` with `-kp`), EDEEL's fragments;
EMT on a Cu13 cluster and Tersoff on an Si8 cluster; the five Jobs. Each
runs through the command a user calls wherever one exists and is held to
the same work on the CPU. The `optmain_surface` phase of `chip_smoke.py`
runs these on the card; with `device="cpu"` and small depths they
rehearse on the CPU, e.g.

    python3 -c "from multioptpy_tpu_torch import optmain_paths as o; \\
        print(o.toy_runs('cpu', '/tmp/toy', n_steps=3))"
"""

import contextlib
import io
import os
import re
import time

import numpy as np
import torch

from multioptpy_tpu_torch import cli
from multioptpy_tpu_torch.analysis.mo import (natural_reaction_orbitals,
                                              sqm_orbitals)
from multioptpy_tpu_torch.analysis.vibrations import (normal_modes,
                                                      rrho_thermochemistry)
from multioptpy_tpu_torch.calculators.edeel import EDEELCalculator
from multioptpy_tpu_torch.calculators.sqm import SQM2
from multioptpy_tpu_torch.dynamics_paths import write_structure
from multioptpy_tpu_torch.io.xyz import read_xyz
from multioptpy_tpu_torch.units import ANGSTROM2BOHR

# (a) the saddle refinement and analyses from the flagship's TS
TS_FLAGS = ("-sqm2", "-opt", "rfo_bofill", "-order", "1", "-fc", "5",
            "-freq", "-temp", "298.15", "-press", "101325", "-cmds", "-pca",
            "-km", "-gi", "bond", "1,11", "bond", "4,12", "-ns", "50")
FORCE_FREQ_FLAGS = ("-sqm2", "-force_freq", "-ns", "5")
WRAPPER_STEPS = 20      # (c)-(f): optmain steps of each run
CMP_STEPS = 3           # steps of each run repeated on the CPU
# (c) the dienophile (atoms 11-18, acrolein) as ONIOM's SQM2 layer;
# (d) a seam with the cation doublet as the second state (SQM2 smears its
# occupations and takes no multiplicity, so a neutral triplet would be
# the first state again); (e) diene and dienophile as rigid fragments
# under a keep restraint on the forming C1-C1' bond
WRAPPER_RUNS = (
    ("c_oniom", ("-sqm2", "-oniom", "11-18", "lj")),
    ("c_oniom_mi", ("-sqm2", "-oniom", "11-18", "lj", "-mi", "3")),
    ("d_two_state", ("-sqm2", "-mf", "seam", "1", "2")),
    ("e_fragments", ("-sqm2", "-of", "1-10", "11-18", "-kp", "0.1", "3.0",
                     "1,11")),
)
EDEEL_DONOR, EDEEL_ACCEPTOR = list(range(1, 11)), list(range(11, 19))
EDEEL_CHARGES = dict(d_init=0, a_init=0, d_final=1, a_final=-1)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def optmain(xyz, flags, device, out, eigh_impl=None):
    """`optmain xyz flags` into `out` through `cli.main` (exit status 0
    or 1, converged or not): seconds, steps, ms per step, the energy
    history, stdout and the exit status."""
    argv = ["optmain", xyz, *flags, "-out", out, "--device", device]
    if eigh_impl:
        argv += ["--eigh_impl", eigh_impl]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    _sync(device)
    seconds = time.perf_counter() - t0
    if rc not in (0, 1):
        raise RuntimeError(f"optmain exited {rc}: {argv}")
    energies = np.loadtxt(os.path.join(out, "energies.csv"), ndmin=1)
    steps = len(energies) - 1
    return {"seconds": seconds, "steps": steps,
            "ms_per_step": 1e3 * seconds / max(steps, 1),
            "converged": rc == 0, "energies": energies,
            "stdout": buf.getvalue()}


def final_geometry(out):
    """optimized.xyz of a run: (coords Bohr (N, 3), z)."""
    from multioptpy_tpu_torch.periodic import symbols_to_z

    symbols, ang = read_xyz(os.path.join(out, "optimized.xyz"))
    return ang * ANGSTROM2BOHR, np.asarray(symbols_to_z(symbols))


def thermochemistry(out):
    """thermochemistry.txt as a dict of floats."""
    with open(os.path.join(out, "thermochemistry.txt")) as f:
        return {k: float(v) for k, v in
                (ln.split(": ") for ln in f.read().splitlines() if ln)}


def freq_run(ts_xyz, device, out, eigh_impl=None, flags=TS_FLAGS):
    """(a) optmain from the TS with -freq and the analyses: the run, its
    frequencies, imaginary-mode count, thermochemistry, animation count,
    point-group line and the files every run writes."""
    run = optmain(ts_xyz, flags, device, out, eigh_impl)
    if not os.path.exists(os.path.join(out, "frequencies_cm1.csv")):
        raise RuntimeError(f"no frequency analysis (converged: "
                           f"{run['converged']} after {run['steps']} steps)")
    freqs = np.loadtxt(os.path.join(out, "frequencies_cm1.csv"))
    anim = os.path.join(out, "vibration_animation")
    pg = [ln for ln in run["stdout"].splitlines()
          if ln.startswith("point group: ")]
    n_imag = re.findall(r"imaginary modes: (\d+)", run["stdout"])
    thermo = thermochemistry(out)
    return {**{k: v for k, v in run.items() if k not in ("stdout",
                                                          "energies")},
            "final_energy": float(run["energies"][-1]),
            "n_imaginary": int(n_imag[0]) if n_imag else -1,
            "lowest_frequencies_cm1": np.sort(freqs)[:8].tolist(),
            "thermochemistry": thermo,
            "thermo_finite": bool(np.isfinite(list(thermo.values())).all()),
            "animations": len(os.listdir(anim)) if os.path.isdir(anim) else 0,
            "modes_above_10": int((np.abs(freqs) > 10.0).sum()),
            "point_group_line": pg[0] if pg else None,
            "files": sorted(f for f in ("input.json", "run_log.csv",
                                        "geometry_params.csv",
                                        "normal_modes.txt", "cmds_path.csv",
                                        "pca_path.csv", "koopman.txt")
                            if os.path.exists(os.path.join(out, f)))}


def freq_check(coords, z, device):
    """(a)'s analysis at one geometry, card against CPU: SQM2's exact
    Hessian on `device` (its default band eigh) and on the CPU through
    the kernel's algorithm (`eigh_impl="kernel"`), their frequencies
    (|freq| > 10 cm^-1) and RRHO quantities."""
    got = []
    for dev, impl in ((device, "auto"), ("cpu", "kernel")):
        x = torch.as_tensor(coords, dtype=torch.float64, device=dev)
        h = SQM2(device=dev, eigh_impl=impl).hessian(x[None], z)[0]
        got.append((h.cpu().numpy(),
                    normal_modes(h, x, z).frequencies_cm1.cpu().numpy(),
                    rrho_thermochemistry(h, x, z)))
    (h_a, f_a, t_a), (h_b, f_b, t_b) = got
    vib = np.abs(f_b) > 10.0
    return {"hessian_max_abs_diff": float(np.abs(h_a - h_b).max()),
            "freq_max_abs_diff_cm1": float(np.abs(f_a[vib]
                                                  - f_b[vib]).max()),
            "n_imaginary_card_cpu": [int((f_a < -5.0).sum()),
                                     int((f_b < -5.0).sum())],
            "rrho_max_abs_diff_ha": max(abs(getattr(t_a, k)
                                            - getattr(t_b, k))
                                        for k in ("zpe", "e_thermal",
                                                  "enthalpy", "gibbs")),
            "entropy_abs_diff_ha_per_k": abs(t_a.entropy - t_b.entropy)}


def orbitals_check(ts, reactant, z, device):
    """(b) SQM2 orbitals at the TS and the natural reaction orbitals from
    the reactant to the TS, card against CPU: seconds on the card and the
    largest gaps (energies, occupations, the sign-free density matrix,
    NRO eigenvalues)."""
    got = []
    for dev in (device, "cpu"):
        calc = SQM2(device=dev)
        t0 = time.perf_counter()
        orb = sqm_orbitals(calc, ts, z)
        w, _ = natural_reaction_orbitals(calc, reactant, ts, z)
        got.append((orb, w, time.perf_counter() - t0))
    (oa, wa, secs), (ob, wb, _) = got
    dens = lambda o: (o.coefficients * o.occupations) @ o.coefficients.T  # noqa
    return {"seconds": secs,
            "orbital_energy_max_abs_diff": float(np.abs(oa.energies
                                                        - ob.energies).max()),
            "occupation_max_abs_diff": float(np.abs(oa.occupations
                                                    - ob.occupations).max()),
            "density_max_abs_diff": float(np.abs(dens(oa) - dens(ob)).max()),
            "nro_eigenvalue_max_abs_diff": float(np.abs(wa - wb).max()),
            "nro_largest": float(np.abs(wa[0])),
            "electrons": float(ob.occupations.sum())}


def wrapper_cpu_check(xyz, flags, card_energies, out):
    """The first CMP_STEPS steps of a wrapper run again on the CPU (band
    and step through LAPACK): the largest energy gap to the card's."""
    cpu = optmain(xyz, (*flags, "-ns", str(CMP_STEPS), "-nosymm"), "cpu",
                  out)
    n = min(len(cpu["energies"]), len(card_energies))
    return float(np.abs(cpu["energies"][:n] - card_energies[:n]).max())


def edeel_check(coords, z, device):
    """(e) EDEEL's seam target with the diene as donor and the dienophile
    as acceptor: energy, gradient and diabatic energies on the card and
    on the CPU; seconds of the card's call and the gaps."""
    got = []
    for dev in (device, "cpu"):
        calc = EDEELCalculator(lambda **k: SQM2(device=dev, **k),
                               EDEEL_DONOR, EDEEL_ACCEPTOR, EDEEL_CHARGES)
        x = torch.as_tensor(coords, dtype=torch.float64, device=dev)[None]
        t0 = time.perf_counter()
        e, g = calc.energy_and_gradient(x, z)
        v11, v22 = calc.diabatic_energies(x, z)
        _sync(dev)
        got.append((float(e[0]), g[0].cpu().numpy(), float(v11[0]),
                    float(v22[0]), time.perf_counter() - t0))
    a, b = got
    return {"seconds": a[4], "energy": a[0], "v11": a[2], "v22": a[3],
            "energy_abs_diff": abs(a[0] - b[0]),
            "gradient_max_abs_diff": float(np.abs(a[1] - b[1]).max()),
            "diabatic_max_abs_diff": max(abs(a[2] - b[2]), abs(a[3] - b[3]))}


def cu13():
    """A cuboctahedral Cu13 (center and 12 vertices, nearest neighbours
    2.55 Angstrom), slightly perturbed from a seed; Bohr."""
    v = [(0.0, 0.0, 0.0)]
    for s1 in (1, -1):
        for s2 in (1, -1):
            v += [(s1, s2, 0.0), (s1, 0.0, s2), (0.0, s1, s2)]
    x = np.asarray(v) * 2.55 * ANGSTROM2BOHR / np.sqrt(2.0)
    x += 0.05 * np.random.default_rng(13).standard_normal(x.shape)
    return x, np.full(13, 29)


def si8():
    """An Si8 cluster: a cube of edge 2.35 Angstrom, perturbed from a
    seed; Bohr."""
    x = np.array([[i, j, k] for i in (0, 1) for j in (0, 1)
                  for k in (0, 1)], float) * 2.35 * ANGSTROM2BOHR
    x += 0.1 * np.random.default_rng(8).standard_normal(x.shape)
    return x, np.full(8, 14)


def toy_runs(device, workdir, n_steps=WRAPPER_STEPS):
    """(f) optmain -calc emt on Cu13 and -calc tersoff on Si8, each
    `n_steps` steps on `device` and on the CPU: per backend the run and
    the largest energy gap over every step."""
    out = {}
    for name, (x, z) in (("emt", cu13()), ("tersoff", si8())):
        xyz = write_structure(os.path.join(workdir, f"{name}.xyz"), x, z)
        flags = ("-calc", name, "-ns", str(n_steps), "-nosymm")
        card = optmain(xyz, flags, device, os.path.join(workdir,
                                                         f"{name}_card"))
        cpu = optmain(xyz, flags, "cpu", os.path.join(workdir,
                                                      f"{name}_cpu"))
        card.pop("stdout")
        e = card.pop("energies")
        out[name] = {**card, "final_energy": float(e[-1]),
                     "max_abs_e_diff_cpu_vs_card": float(np.abs(
                         e - cpu["energies"]).max())}
    return out


def jobs_run(reactant, product, z, device, n_steps=5):
    """(g) the five Jobs once each on `device`: an SQM2 optimization and
    an SQM2 MD of the Diels-Alder reactant, an 8-image SQM2 band and an
    EIP search between the flagship's IRC endpoints, `n_steps` each, and
    an AutoTS on Muller-Brown; seconds and a finite result each."""
    from multioptpy_tpu_torch import jobs
    from multioptpy_tpu_torch.calculators.model_surfaces import (MB_MIN_A,
                                                                 MB_MIN_C)

    da = dict(coords=reactant, z=z, calculator="sqm2", device=device)
    mb = dict(coords=np.array([[MB_MIN_A[0], MB_MIN_A[1], 0.0]]),
              z=np.array([1]), calculator="muller_brown", device=device)
    runs = (
        ("OptimizationJob", lambda: jobs.OptimizationJob(
            **da, method="rfo_fsb", nsteps=n_steps),
         lambda r: r.energy_history),
        ("MDJob", lambda: jobs.MDJob(**da, n_steps=n_steps, temperature=300.0,
                                     thermostat="nosehoover"),
         lambda r: r.energies),
        ("NEBJob", lambda: jobs.NEBJob(**da, end_coords=product, n_images=8,
                                       n_steps=n_steps),
         lambda r: r.energies.cpu().numpy()),
        ("IEIPJob", lambda: jobs.IEIPJob(**da, end_coords=product,
                                         n_steps=n_steps),
         lambda r: np.array([r.ts_energy])),
        ("AutoTSJob", lambda: jobs.AutoTSJob(
            **mb, product_coords=np.array([[MB_MIN_C[0], MB_MIN_C[1], 0.0]]),
            n_images=8, top_n_candidates=1),
         lambda r: np.array([r.ts_energy])),
    )
    out = {}
    for name, make, values in runs:
        t0 = time.perf_counter()
        res = make().run()
        _sync(device)
        v = np.asarray(values(res), dtype=np.float64)
        out[name] = {"seconds": time.perf_counter() - t0,
                     "finite": bool(np.isfinite(v).all()),
                     "last": float(v.reshape(-1)[-1])}
    return out


def logger_cost(coords, z, device, out, n_steps=10):
    """The cost of optmain's per-step logging: `optimize` on SQM2 for
    `n_steps` steps under a `StageTimer`, with an empty callback (a warm
    run, discarded), with RunLogger's callback (five host reads of the
    state and two tracked bonds a step), and with the empty one again:
    ms per step of the "step" and "host" stages of the last two."""
    from multioptpy_tpu_torch.drivers.optimize import (OptimizeConfig,
                                                       optimize)
    from multioptpy_tpu_torch.logging_utils import RunLogger, StageTimer

    cfg = OptimizeConfig(method="rfo_fsb", nsteps=n_steps, max_force=1e-9,
                         rms_force=1e-9, max_displacement=1e-9,
                         rms_displacement=1e-9)
    logger = RunLogger(out, tracked_params=[("bond", [1, 11]),
                                            ("bond", [4, 12])])
    got = {}
    empty = lambda it, st: None  # noqa: E731
    for name, cb in (("empty", empty), ("run_logger",
                                        logger.make_callback()),
                     ("empty", empty)):
        timer = StageTimer()
        optimize(SQM2(device=device), coords, z, config=cfg, callback=cb,
                 timer=timer, device=device)
        rep = timer.report()
        got[name] = {"step_ms": rep["step"]["mean_ms"],
                     "host_ms": rep["host"]["mean_ms"],
                     "steps": rep["step"]["count"]}
    got["logger_ms_per_step"] = (got["run_logger"]["host_ms"]
                                 - got["empty"]["host_ms"])
    return got
