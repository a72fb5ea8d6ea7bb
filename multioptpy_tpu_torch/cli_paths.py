"""The command-line flags that act, on real systems, with their CPU reruns.

On the Diels-Alder system of the flagship (18 atoms): `optmain -irc`
from the flagship's TS on SQM2 (the chained IRC), `run_autots` with a v1
config that sets `skip_to_step4` (the input is the TS guess), `optmain
-calc sqm -srb` from the reactant (SQM's short-range bond term), and
`relaxedscan` under `-diis gdiis -d 0.5` and `-opt sd -d 0.5`. Each runs
through `cli.main` and is held to the CPU; the runs of `optmain` and
`relaxedscan` go through `optmain_paths.optmain` and
`workflow_paths.relaxedscan_run`. The `cli_surface` phase of
`chip_smoke.py` runs these on the card; with `device="cpu"` they
rehearse on the CPU, e.g.

    python3 -c "from multioptpy_tpu_torch import cli_paths as c; \\
        from multioptpy_tpu_torch.io.fixtures import diels_alder_reactant \\
        as r; x, z = r(); print(c.srb_term(x, z, 'cpu'))"
"""

import contextlib
import io
import json
import os
import time

import numpy as np
import torch

from multioptpy_tpu_torch import cli
from multioptpy_tpu_torch.analysis.vibrations import (count_imaginary,
                                                      normal_modes)
from multioptpy_tpu_torch.calculators.sqm import SQM, SQM2
from multioptpy_tpu_torch.drivers.irc import IRCConfig, irc
from multioptpy_tpu_torch.io.xyz import read_trajectory
from multioptpy_tpu_torch.ops import hosteval
from multioptpy_tpu_torch.optmain_paths import final_geometry, optmain
from multioptpy_tpu_torch.reaction_paths import CPU_RERUN_BAND
from multioptpy_tpu_torch.units import BOHR2ANGSTROM

# (a) the saddle refinement from the flagship's TS and its chained IRC
IRC_STEP, IRC_STEPS = 0.1, 10
IRC_FLAGS = ("-calc", "sqm2", "-order", "1", "-o", "rfo_bofill", "-ns", "5",
             "-irc", str(IRC_STEP), str(IRC_STEPS), "lqa")
IRC_CMP = 3             # first energies of each branch held to the CPU
# (b) the v1 flow from the TS guess: saddle refinement with an exact
# Hessian every 5 steps, a 10-step LQA IRC, 20 steps at each end
SKIP_TO_STEP4 = {
    "skip_to_step4": True,
    "step3_settings": {"opt_method": ["rfo_bofill"], "calc_exact_hess": 5,
                       "NSTEP": 20},
    "step4_settings": {"intrinsic_reaction_coordinates":
                       [str(IRC_STEP), str(IRC_STEPS), "lqa"],
                       "opt_method": ["rfo_fsb"], "NSTEP": 20}}
# (c) SQM (not SQM2) with its SRB term, from the reactant
SRB_FLAGS = ("-calc", "sqm", "-srb", "-nosymm")
SRB_STEPS = 10
SRB_CMP = 3             # first energies held to the CPU
# (d) three constrained points on the forming C1-C1' bond, 5 steps each:
# RS-RFO with GDIIS (its step takes no scale: -d reaches the config and
# moves nothing), and steepest descent, whose every step -d scales
SCAN_FLAGS = ("-sqm2", "-scan", "bond", "1,11", "3.2,2.6", "-nsample", "3",
              "-ns", "5")
SCAN_RUNS = {"gdiis": ("-diis", "gdiis", "-d", "0.5"),
             "sd": ("-opt", "sd", "-d", "0.5")}


def _imaginary(calc, coords, z):
    """Imaginary modes of `calc`'s exact Hessian at coords (N, 3)."""
    h = hosteval.hessian(calc, coords[None], z)[0]
    return count_imaginary(normal_modes(h, coords, z).frequencies_cm1)


def irc_chain_run(ts_xyz, device, out, eigh_impl="pallas"):
    """(a) `optmain ts.xyz IRC_FLAGS` into `out`: seconds, steps, whether
    the chain took the IRC (not the meta-IRC), the IRC's point count and
    energies per branch, and the optimized geometry (Bohr)."""
    run = optmain(ts_xyz, IRC_FLAGS, device, out, eigh_impl)
    e = np.loadtxt(os.path.join(out, "irc_energies.csv"))
    half = len(e) // 2          # the backward branch reversed, then forward
    line = [ln for ln in run["stdout"].splitlines() if ln.startswith("IRC: ")]
    return {"seconds": run["seconds"], "converged": run["converged"],
            "steps": run["steps"],
            "took_irc": "meta-IRC" not in run["stdout"] and os.path.exists(
                os.path.join(out, "irc_curvature_properties_forward.csv")),
            "irc_points": int(line[0].split()[1]) if line else 0,
            "forward": e[half:], "backward": e[:half][::-1],
            "coords": final_geometry(out)[0]}


def irc_chain_cpu_check(run, z, device, n_cmp=IRC_CMP):
    """(a) held to the CPU: the imaginary modes at the optimized geometry
    on `device` (its default band eigh) and on the CPU, and the chained
    IRC's first `n_cmp` energies of each branch from the same geometry on
    the CPU (n_cmp - 1 LQA steps and the energy at the next point; the
    band through LAPACK), the branches matched (the imaginary mode's sign
    is each eigensolver's)."""
    x_card = torch.as_tensor(run["coords"], device=device)
    x = torch.as_tensor(run["coords"])
    cpu = SQM2(eigh_impl=CPU_RERUN_BAND, device="cpu")
    t0 = time.perf_counter()
    res = irc(cpu, x, z, config=IRCConfig(step_size=IRC_STEP,
                                          n_steps=n_cmp - 1, method="lqa"),
              device="cpu")
    nxt = hosteval.energy(cpu, torch.as_tensor(np.stack(
        [res.forward_path[-1], res.backward_path[-1]])), z).numpy()
    e_cpu = [np.append(res.forward_energies, nxt[0]),
             np.append(res.backward_energies, nxt[1])]
    e_card = [run["forward"][:n_cmp], run["backward"][:n_cmp]]
    if abs(e_cpu[0][0] - e_card[0][0]) > abs(e_cpu[1][0] - e_card[0][0]):
        e_cpu = e_cpu[::-1]
    return {"n_imaginary_card_cpu": [_imaginary(SQM2(device=device),
                                                x_card, z),
                                     _imaginary(cpu, x, z)],
            "cpu_rerun_s": time.perf_counter() - t0,
            f"first{n_cmp}_max_abs_e_diff_cpu_vs_card": float(max(
                np.abs(a - b).max() for a, b in zip(e_card, e_cpu)))}


def skip_to_step4_run(ts_xyz, device, out):
    """(b) `run_autots ts.xyz -calc sqm2 -cfg v1.json` with SKIP_TO_STEP4
    into `out`: seconds, the refined TS (Bohr) and the energy and
    imaginary-mode count on ts.xyz's comment line, the files written."""
    os.makedirs(out, exist_ok=True)
    cfg = os.path.join(out, "v1.json")
    with open(cfg, "w") as f:
        json.dump(SKIP_TO_STEP4, f)
    argv = ["run_autots", ts_xyz, "-calc", "sqm2", "-cfg", cfg, "-out", out,
            "--device", device]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"run_autots exited {rc}: {argv}")
    _, frames, comments = read_trajectory(os.path.join(out, "ts.xyz"))
    e, ni = comments[0].split(", ")
    return {"seconds": seconds,
            "ts": np.asarray(frames[0]) / BOHR2ANGSTROM,
            "ts_energy": float(e.split("=")[1]),
            "n_imaginary": int(ni.split("=")[1]),
            "files": sorted(f for f in ("ts.xyz", "irc_end_1.xyz",
                                        "irc_end_2.xyz")
                            if os.path.exists(os.path.join(out, f))),
            "last_line": buf.getvalue().strip().splitlines()[-1]}


def srb_term(coords, z, device):
    """SQM's SRB energy at coords (N, 3) Bohr, and SQM's energy without it
    (the -calc sqm -srb run's first energy is their sum)."""
    x = torch.as_tensor(coords, dtype=torch.float64, device=device)[None]
    srb = float(SQM(srb=True, device=device).energy_terms(x, z)["srb"][0])
    bare = float(SQM(device=device).energy(x, z)[0])
    return {"srb_energy": srb, "energy_without_srb": bare}
