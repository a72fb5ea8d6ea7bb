#!/usr/bin/env python3
"""Drive the PyTorch port (multioptpy_tpu_torch) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing one JSON line:
  1. kernel_check: build the Jacobi kernel (its warp variant for D <= 32
     at batches that fill the card, its block variant otherwise) from
     csrc/ with nvcc, hold it against its
     plain PyTorch version at every main-path shape (plus odd D, a
     near-degenerate batch, and the variants' boundaries: D = 2, 30, 34,
     120 in f64, 168 in f32, B = 1, 7 and 12289), and time the
     kernel, the plain version and torch.linalg.eigh (the yardstick; the
     port never calls it below the kernel's size gate) at the main-path
     shapes; then seeded_eigh, whose f32 seed is the kernel, against
     torch.linalg.eigvalsh.
  2. slice_a: 256 perturbed S8 rings relaxed together on SQM in f32 with
     rfo_fsb, an exact initial Hessian and eigh_impl="pallas", 100 steps
     (the throughput configuration of examples/04_scale_demo.py, cut from
     150: SLICE_A_STEPS).
  3. slice_b: the 18-atom Diels-Alder reactant on SQM2 in f64 with rfo_fsb,
     an exact initial Hessian and eigh_impl="pallas" on the stepper and the
     calculator, up to 60 steps; its first 3 steps also run on the CPU and
     must agree to 1e-8 Ha.
  4. autots: the reduced flagship AutoTS (tests/test_tpu_flagship_smoke.py:
     two AFIRs, 150 AFIR steps, an 8-image CI-NEB of 80 iterations, one
     saddle candidate with exact Hessians every 5 steps, a 30-step LQA IRC,
     endpoint optimizations) on the Diels-Alder reactant, SQM2 f64,
     eigh_impl="pallas" everywhere, the default scan_chunk. It must launch
     the block variant in the NEB and in the IRC, give finite barriers
     and a positive forward one, and agree with a CPU run of the kernel's
     algorithm to 1e-8 Ha over the AFIR stage's first 3 energies and the
     band energies of the first 2 NEB iterations. Its band has no interior
     maximum (as in the JAX package's own CPU run), so it must find no
     imaginary mode, the reference's own count; and the whole pipeline,
     run again on the CPU through torch.linalg.eigh, must give the same
     count, the TS energy within 1e-6 Ha and the barriers within 1e-5 Ha.
  5. full_flagship: the configuration of tests/test_flagship_autots.py
     (300 AFIR steps, 16 images, 250 NEB iterations with a linear
     redistribution every 25, two candidates, a 70-step IRC). It must find
     one imaginary mode and a finite positive forward barrier, and launch
     the block variant in the NEB and in the IRC.
  6. methods: the optimizer method surface on the card, through `optimize`
     and `optimize_batch`, eigh_impl="pallas" on stepper and calculator.
     (a) Diels-Alder on SQM2 f64, 10 steps each: RS-P-RFO and mode-
     following RS-I-RFO (Bofill, saddle_order 1, an exact Hessian every 5
     steps) from the full flagship's saddle-stage start; block updates,
     TRIM, mass weighting, DIC, crsirfo with a C2-C3 bond constraint,
     GEDIIS, KDIIS, `-opt fire rfo_fsb`, FIRE, L-BFGS, CG and GPmin from
     the reactant. Each must give finite energies whose first 3 agree with
     the same run on the CPU (the kernel's algorithm for the step, LAPACK
     for the band: reaction_paths.CPU_RERUN_BAND) to 1e-8 Ha; each
     RS-P-RFO run must launch the block variant. Then the RS-P-RFO
     Hessians of those runs, kept by a second pass, must be converged by
     the step's 14 f64 sweeps (largest off-diagonal <= 1e-12 of max|a|).
     (b) The ensemble of slice A (256 S8 rings, SQM f32) through
     `optimize_batch` with FIRE, L-BFGS and Adam, 50 steps each; 8
     members' first 3 energies must agree with a CPU run of those 8 to
     3e-5 of |E| (f32; the relative tolerance of tests/test_jacobi_pallas.py).
     Each run prints its steps, ms per step (per structure and step in
     (b)) and K1 launches by shape.
  7. reaction_paths: the reaction-path entry points through cli.main on
     SQM2 f64, the band eigh through the kernel (multioptpy_tpu_torch/
     reaction_paths.py). (a) nebmain -nimg 16 -aconv -ns 100 (CI-NEB, FIRE)
     between the full flagship's IRC endpoints: finite energies, an
     interior maximum, block launches at 16x72x72, and its first 2
     iterations' band energies within 1e-8 Ha of the same NEBConfig run
     through `neb` on the CPU. (b) On the aldol pair, relaxed on the card,
     12 images and 10 iterations each: the 15 force laws with FIRE, the 10
     other band clocks with CI-NEB, -idpp, -ci 5 5, -aneb 1 5, -pitr and
     the 11 redistribution schemes every 5 iterations, each finite and
     within 1e-8 Ha of its CPU rerun over the first 2 iterations (-aneb:
     its band after 7, past the first growth to 14 images); then `gpneb` with 2 outer rounds, within the
     bound its docstring states (1e-10 Ha, 1e-9 Bohr). (c) ircmain from
     the full flagship's TS with lqa, euler, rk4, dvv and hpc, 10 steps
     each: both branches below the TS energy and descending, the first 3
     energies within 1e-8 Ha of a CPU rerun (its band through LAPACK,
     reaction_paths.CPU_RERUN_BAND), and the TS Hessian's launch
     at 108x72x72. (d) On the Diels-Alder reactant: every model-Hessian
     kind and suffix against the CPU to 1e-10 relative, o1numhess and
     o1numhess_full to 1e-8, and one optmain -sqm2 -modelhess run of 5
     steps with finite energies. Every run prints ms per iteration (or
     step) and its K1 launches by shape; kernel_check rows follow for every
     other f64 batch the phase launched.
  8. dynamics: mdmain and ieipmain through cli.main on the Diels-Alder
     system, SQM2 f64, the band eigh through the kernel
     (multioptpy_tpu_torch/dynamics_paths.py). (a) mdmain from the full
     flagship's reactant: nosehoover for 100 steps; none for 50;
     nosehooverchain, berendsen and langevin for 30 (cut from 200 and 50:
     dynamics_paths.MD_STEPS); a -cc SHAKE bond, a -ct schedule,
     -ntraj 2 and a run under six kinds of bias flags. Each prints ms per
     step, K1 launches per step (at least one 1x72x72 a step) and a
     profiled step's idle share; the SHAKE bond must hold to 1e-6
     Angstrom; each thermostat's first 5 steps must agree with a CPU rerun
     from the card's initial velocities (Langevin: and the card's draws)
     to 1e-10 Ha and 1e-9 Bohr. The NVE run's total-energy drift must stay
     under 1e-3 Ha and fall at least threefold at half the time step over
     the same 25 fs (velocity Verlet is second order), and central
     differences of the energy must match its gradient to 1e-8 Ha/Bohr.
     (b) The 36 bias potentials one by one: energy, gradient and Hessian
     on the card against the CPU to 1e-12 relative; then 8 steps of
     optimize under all 36 at once, the first 3 energies within 1e-8 Ha
     of the CPU's. (c) ieipmain with eip, spring_pair (-ns 30), dimer
     (-dimer_maxiter 15) and gnt (-gnt_mi 4) between the full flagship's
     IRC endpoints; 2pshs (3 spheres) from the
     product's relaxed minimum toward the reactant's; -addf -addf_nadd 2
     -addf_num 10 from the reactant's relaxed minimum and from the
     product's, where a channel turns over and addf_explore refines the
     crossing (more than one 108x72x72 launch). Each prints the TS-guess
     energy beside the flagship's TS, ms per calculator call, K1 launches
     by shape (2pshs and addf launch at 108x72x72) and the idle share of
     its first iterations, which are run through the driver in ieipmain's
     configuration, cut short, and held to the CPU's to 1e-8 Ha; ADDF's,
     whose first sphere lies tens of Bohr out along the softest modes, to
     ten times what the CPU's two eigensolvers (the kernel's algorithm,
     LAPACK) differ by, if that is looser. From the product's minimum,
     whose softest curvatures are below 1e-5 Ha/Bohr^2, those two differ
     by an O(1) Ha, so that run is held instead at its refined point: its
     energy against the CPU's there to 1e-8 Ha, its imaginary modes
     printed. (d) meta_irc (LQA) from a displaced minimum, 8 steps, the
     first 2 within 1e-8 Ha of the CPU's; modekill (keep_order 1) on the
     flagship's TS made a second-order saddle by a keep restraint of
     negative spring constant on C2-C3 at its length: two imaginary modes
     before, at most one after, its first round within 1e-8 Ha and 1e-7
     Bohr of the CPU's.
  9. workflows: confsearch, relaxedscan, orientsearch and run_mapper, the
     v2 workflow engine and metadynamics on SQM2 f64, the band eigh
     through the kernel (multioptpy_tpu_torch/workflow_paths.py). (a)
     confsearch -sqm2 -bsize 16 -ms 2 -pbc --eigh_impl pallas on n-octane
     (alkane_chain(8), 26 atoms) through the command's function: 0
     non-finite candidates, K1 launches at 16x104x104 (the band) and
     16x78x78 (the RS-RFO step, 15 sweeps), a traced relax step; the band
     through K1 within 1e-10 Ha of torch.linalg.eigh on the 16 kicked
     conformers, their RS-RFO Hessians converged to 1e-12 of max|a| by the
     step's sweeps, and the first round's first 5 kick steps and first 3
     relaxation energies of 2 members within 1e-8 Ha of the CPU from the
     card's seeds, pairs and signs. (b) relaxedscan -scan bond 1,11
     3.2,1.6 -nsample 6 -ns 10 on the Diels-Alder reactant: every point
     finite, the bond held to 1e-4 Angstrom, the first point's first 3
     energies within 1e-8 Ha of the CPU. (c) orientsearch -part 11-18
     -nsample 16 -dist 3.5: 16 finite sorted energies, launches at 16x72
     and 16x54, 2 placements' first 3 energies within 1e-8 Ha of the CPU.
     (d) run_metadynamics on the C1-C1' distance (Langevin, 4 hills every
     10 steps): finite CV history and free energy, the first 5 steps
     within 1e-10 Ha and 1e-9 Bohr of the CPU from the card's velocities
     and draws. (e) run_autots -cfg v2.json (neb, saddle, freq, irc) between
     the full flagship's IRC endpoints through the command's function: a
     report for every step, ts.xyz, the saddle step converged on the
     flagship's TS (one imaginary mode, its energy within 1e-6 Ha), the
     run's own first 2 NEB iterations within 1e-8 Ha of the same command
     on the CPU. (f) run_mapper -sqm2 -cfg mapper.json ({"mapper": ...}:
     the batched AFIR executor at batch_size 2, 2 explorations, each
     task's AutoTS at the mapper's defaults) from the Diels-Alder
     reactant through the command's function, then run_mapper --resume
     reading network.json back: no task skipped for an error, each task's
     TS count reported (a count other than one adds no edge), the
     executor's first 3 steps within 1e-8 Ha of the CPU, finite kinetic
     priorities. The CPU reruns of (a)-(c), which start from exact
     Hessians, take the band through LAPACK. kernel_check rows follow at
     1x104, 16x104 (9 sweeps), 1x78, 16x78 (15) and 16x54 (14), timed, and
     at every other f64 batch the phase's main runs launched. In this
     phase and the dynamics phase, the launches of a check or rerun on
     the card are discarded: the kernels line counts the main runs'.
Slice A must launch the warp variant and slice B the block variant. The
kernel_check rows time the wrapper and the kernel launch alone (padded
input, no sort or gather) as the median of 3 groups of CUDA-event timings
each, the plain version as one call after a warm one. Then
the kernels line (one entry per variant), the card's name and power
limit, and last the fixed
{"ok": true, "device": ...} line. Any failed check raises: exit code != 0.
Without a CUDA card the script raises before printing any result.
"""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
# peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s, and dense
# f32 (outside the tensor cores) / f64 (tensor-core peak) operations/s
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.float64: 67e12}
# the methods phase's depths (steps of each Diels-Alder run, steps of each
# ensemble run), cut from 20 and 150 so that the whole script stays inside
# its 1200 s limit on the slowest host measured: there the full flagship
# alone takes 90 s against 55-69 s elsewhere, and the uncut script took
# 1003 s on a 69 s host
METHOD_STEPS = 10
ENSEMBLE_STEPS = 50
# cut for the same reason when the workflows phase came (its ~170 s on a
# 52 s flagship host): slice A's steps (from 150), the aldol bands'
# iterations (reaction_paths.ALDOL_STEPS, from 20; each band still
# redistributes twice and -aneb grows past its compared prefix), the IRC
# steps of each integrator (from 15) and the optimization under all 36
# potentials (from 20); every gate is unchanged
SLICE_A_STEPS = 100
IRC_STEPS = 10
BIAS_OPT_STEPS = 8
META_IRC_STEPS = 8      # from 15
# (the dynamics phase's MD and ieipmain depths: dynamics_paths.MD_STEPS
# and the constants beside it)
SQM_LOOSE = dict(max_force=3e-3, rms_force=2e-3, max_displacement=1e-2,
                 rms_displacement=7e-3)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(b, d0, sweeps, dtype):
    """Least time for one call: the larger of the bytes it must move (input
    read once, w and V written once) over HBM bandwidth and its operations
    over peak: 6 D^3 per sweep per matrix. A round rotates D/2 pairs of
    rows and of columns at 6 flops per pair of entries: 6 D^2 on the whole
    of A, of which one triangle of the symmetric A needs half, and 3 D^2
    on V; a sweep is D - 1 rounds."""
    itemsize = torch.finfo(dtype).bits // 8
    d = d0 + d0 % 2
    t_bytes = b * (2 * d0 * d0 + d0) * itemsize / PEAK_BYTES * 1e3
    t_ops = 6.0 * d ** 3 * sweeps * b / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def random_sym(gen, b, d, dtype, degenerate=False):
    m = torch.randn(b, d, d, generator=gen, dtype=torch.float64)
    if not degenerate:
        return (0.5 * (m + m.mT)).to(dtype).cuda()
    q, _ = torch.linalg.qr(m)
    w = torch.repeat_interleave(torch.arange(1, d // 4 + 2,
                                             dtype=torch.float64), 4)[:d]
    w = w + 1e-7 * (torch.arange(d, dtype=torch.float64) % 2)
    return ((q * w[None, None, :]) @ q.mT).to(dtype).cuda()


def median_ms(fn, groups=3):
    """The median of `groups` CUDA-event timings of fn (`cuda_ms` each)."""
    from multioptpy_tpu_torch.device import cuda_ms

    return float(np.median([cuda_ms(fn) for _ in range(groups)]))


def check_row(jc, gen, b, d, dtype, where, card, timed=True, sweeps=None):
    """One kernel_check row: the kernel against its plain version on a
    random (b, d, d) batch at `sweeps`, else at the sweeps of `where` (a
    main-path shape: its `_eigh` count; the near-degenerate and boundary
    rows 12), timed with the plain version, torch.linalg.eigh and the bound
    when `timed`. Emits the row and raises when the kernel disagrees."""
    from multioptpy_tpu_torch.device import cuda_ms
    from multioptpy_tpu_torch.steppers.rfo import (jacobi_sweeps_for,
                                                   rfo_extra_sweeps)

    # clustered spectra converge slowly: the near-degenerate batch and
    # the boundary rows (B = 12289 random matrices hold close pairs)
    # get 12 sweeps; every main-path shape the main path's (`_eigh`:
    # one more than its CPU count, an RS-RFO step more in f64)
    sw = sweeps or (12 if where in ("near-degenerate", "variant boundary")
                    else jacobi_sweeps_for(d) + (rfo_extra_sweeps(dtype)
                                                 if "RFO" in where else 1))
    a = random_sym(gen, b, d, dtype, degenerate=(where == "near-degenerate"))
    w, v = jc.jacobi_eigh_cuda(a, sw)
    w_p, v_p = jc.jacobi_eigh_plain(a, sw)
    torch.cuda.synchronize()
    scale = max(1.0, a.abs().max().item())
    tol_w, tol_r = ((2e-5, 3e-5) if dtype == torch.float32
                    else (1e-11, 1e-11))
    err_w = (w - w_p).abs().max().item()
    rec = torch.einsum("bij,bj,bkj->bik", v, w, v)
    err_r = (rec - a).abs().max().item()
    eye = torch.eye(d, dtype=dtype, device="cuda")
    err_o = (v.mT @ v - eye).abs().max().item()
    row = {"batch": b, "d": d, "dtype": str(dtype).split(".")[-1],
           "sweeps": sw, "where": where,
           "variant": jc.launch_plan(b, d + d % 2, dtype).variant,
           "eig_err_vs_plain": err_w,
           "reconstruction_err": err_r, "orthonormality_err": err_o,
           "scale": scale}
    if dtype == torch.float32 and d > 72:
        # f32 rounding of the algorithm itself passes 2e-5 / 3e-5 of
        # max|a| at this D (the plain version's own reconstruction
        # error is ~6e-5 of it at D = 168): the kernel is held to twice
        # the plain version's own errors against f64 eigvalsh instead
        w_ex = torch.linalg.eigvalsh(a.double())
        rec_p = torch.einsum("bij,bj,bkj->bik", v_p, w_p, v_p)
        row["eig_err_vs_f64"] = (w.double() - w_ex).abs().max().item()
        row["plain_eig_err_vs_f64"] = (w_p.double()
                                       - w_ex).abs().max().item()
        row["plain_reconstruction_err"] = (rec_p - a).abs().max().item()
        ok = (row["eig_err_vs_f64"] <= 2 * row["plain_eig_err_vs_f64"]
              and err_r <= 2 * row["plain_reconstruction_err"]
              and err_o <= tol_r * d)
    else:
        ok_r = err_r <= tol_r * scale
        if not ok_r:
            # a random batch of thousands holds matrices that the main
            # path's sweeps leave short of convergence (at 2496x104 and 9
            # sweeps, one whose smallest gap is 0.5 % of max|a| keeps
            # 3.8e-11 of max|a| in the plain version as in the kernel;
            # 200 random 104s converge to 6.3e-14 and the n-octane bands
            # to 1.6e-15 of max|a|): the kernel must then give the plain
            # version's own decomposition
            rec_p = torch.einsum("bij,bj,bkj->bik", v_p, w_p, v_p)
            row["plain_reconstruction_err"] = (rec_p - a).abs().max().item()
            row["reconstruction_err_vs_plain"] = (rec
                                                  - rec_p).abs().max().item()
            ok_r = row["reconstruction_err_vs_plain"] <= tol_r * scale
        ok = err_w <= tol_w * scale and ok_r and err_o <= tol_r * d
    row["ok"] = ok
    if timed:
        row["ms"] = median_ms(lambda: jc.jacobi_eigh_cuda(a, sw))
        a3 = jc.pad_to_even(a)[0].contiguous()
        plan = jc.launch_plan(b, a3.shape[-1], dtype, jc._prepare(0, dtype))
        row["kernel_only_ms"] = median_ms(lambda: jc.launch(a3, sw, plan))
        # one timed call after a warm one: the plain version takes 0.3-1.3 s
        row["plain_ms"] = cuda_ms(lambda: jc.jacobi_eigh_plain(a, sw),
                                  reps=1)
        row["library_ms"] = median_ms(lambda: torch.linalg.eigh(a))
        row["bound_ms"], row["bound_by"] = bound_ms(b, d, sw, dtype)
    emit({"phase": "kernel_check", **row, "card": card})
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{row}")
    return row


def phase_kernel_check(jc, card):
    t0 = time.perf_counter()
    lib_path, log = jc.build()
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "library": str(lib_path.relative_to(REPO)),
          "seconds": build_s,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})
    gen = torch.Generator().manual_seed(0)
    cases = [  # (batch, D, dtype, where on the main path)
        (256, 24, torch.float32, "S8 RFO step"),
        (256, 32, torch.float32, "S8 SQM band per gradient"),
        (256 * 48, 32, torch.float32, "S8 band inside the exact Hessian"),
        (1, 54, torch.float64, "Diels-Alder RFO step"),
        (1, 72, torch.float64, "Diels-Alder SQM2 band per gradient"),
        (108, 72, torch.float64, "Diels-Alder band inside the exact Hessian"),
        (8, 72, torch.float64, "Diels-Alder NEB band of 8 images"),
        (16, 72, torch.float64, "Diels-Alder NEB band of 16 images"),
        (2, 72, torch.float64, "Diels-Alder IRC branch-pair band"),
        (216, 72, torch.float64, "Diels-Alder IRC branch-pair Hessian"),
        (12, 44, torch.float64, "aldol NEB band of 12 images"),
        (18, 44, torch.float64, "aldol -aneb 1 5 band grown to 18 images"),
    ]
    extra = [(20, 9, dt, "odd D") for dt in (torch.float32, torch.float64)]
    extra += [(4, 27, dt, "odd D") for dt in (torch.float32, torch.float64)]
    extra += [(16, 24, dt, "near-degenerate")
              for dt in (torch.float32, torch.float64)]
    extra += [(b, d, dt, "variant boundary")
              for d, dt in ((2, torch.float64), (30, torch.float64),
                            (34, torch.float64), (120, torch.float64),
                            (168, torch.float32))
              for b in (1, 7)]
    extra += [(12289, d, dt, "variant boundary")
              for d, dt in ((2, torch.float64), (30, torch.float64),
                            (32, torch.float32), (34, torch.float64))]
    rows = [check_row(jc, gen, b, d, dtype, where, card,
                      timed=(b, d, dtype, where) in cases)
            for b, d, dtype, where in cases + extra]

    # seeded_eigh (ops/eigh64): f32 seed through the kernel, f64 polish
    from multioptpy_tpu_torch.ops.eigh64 import seeded_eigh
    a = random_sym(gen, 108, 72, torch.float64)
    before = jc.jacobi_eigh_cuda.launches
    w, v = seeded_eigh(a)
    w_lib = torch.linalg.eigvalsh(a)
    torch.cuda.synchronize()
    scale = max(1.0, a.abs().max().item())
    err_w = (w - w_lib).abs().max().item()
    err_r = (torch.einsum("bij,bj,bkj->bik", v, w, v) - a).abs().max().item()
    seeded = {"phase": "seeded_eigh", "batch": 108, "d": 72,
              "eig_err_vs_library": err_w, "reconstruction_err": err_r,
              "kernel_launches": jc.jacobi_eigh_cuda.launches - before,
              "card": card}
    emit(seeded)
    # two f64 polish sweeps from an 8-sweep f32 Jacobi seed (the reference's
    # TPU route) leave ~1e-9 on random 72x72 matrices with close pairs
    if not (err_w <= 1e-8 * scale and err_r <= 1e-8 * scale
            and seeded["kernel_launches"] == 1):
        raise AssertionError(f"seeded_eigh failed on the card: {seeded}")
    return rows


def s8_ring(radius=4.3, pucker=0.9):
    """S8 crown: alternating-z octagon, Bohr (examples/04_scale_demo.py)."""
    k = np.arange(8)
    ang = 2 * np.pi * k / 8
    return np.stack([radius * np.cos(ang), radius * np.sin(ang),
                     pucker * (-1.0) ** k], axis=-1)


def phase_slice_a(jc, card):
    from multioptpy_tpu_torch.calculators.sqm import SQM
    from multioptpy_tpu_torch.drivers.optimize import (OptimizeConfig,
                                                       optimize_batch)

    batch_n, n_steps = 256, SLICE_A_STEPS
    rng = np.random.default_rng(11)
    batch = torch.as_tensor(s8_ring()[None] + 0.12 * rng.standard_normal(
        (batch_n, 8, 3)), dtype=torch.float32, device="cuda")
    z = np.full(8, 16)
    calc = SQM(eigh_impl="pallas", device="cuda")
    cfg = OptimizeConfig(method="rfo_fsb", init_hessian="exact",
                         eigh_impl="pallas", **SQM_LOOSE)
    e0 = calc.energy(batch, z)
    t0 = time.perf_counter()
    optimize_batch(calc, batch, z, config=cfg, n_steps=n_steps,
                   device="cuda")
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0

    jc.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = optimize_batch(calc, batch, z, config=cfg, n_steps=n_steps,
                         device="cuda")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = dict(jc.jacobi_eigh_cuda.variant_launches)

    e_hist = res.energy_history
    g = res.gradient.reshape(batch_n, -1)
    out = {
        "phase": "slice_a", "config": "256xS8 SQM f32 rfo_fsb exact pallas",
        "n_steps": n_steps, "n_converged": int(res.converged.sum()),
        "median_maxg_final": float(g.abs().amax(-1).median()),
        "median_e_initial": float(e0.median()),
        "median_e_final": float(np.median(e_hist[-1])),
        "ms_per_structure_step_warm": warm_s / (batch_n * n_steps) * 1e3,
        "run_s_warm": warm_s, "run_s_first": cold_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "kernel_launches": launches, "card": card}
    emit(out)
    if launches["warp"] <= 0:
        raise AssertionError("slice A never launched the warp variant")
    finite = (np.isfinite(e_hist).all() and bool(torch.isfinite(
        res.coords).all()) and bool(torch.isfinite(res.gradient).all()))
    if not finite:
        raise AssertionError("slice A produced non-finite values")
    if not out["median_e_final"] < out["median_e_initial"]:
        raise AssertionError("slice A: the median energy did not fall")
    return launches


def phase_slice_b(jc, card):
    from multioptpy_tpu_torch.calculators.sqm import SQM2
    from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig, optimize
    from multioptpy_tpu_torch.io.fixtures import diels_alder_reactant

    coords, z = diels_alder_reactant()
    cfg = dict(method="rfo_fsb", init_hessian="exact", eigh_impl="pallas")
    gpu_calc = SQM2(eigh_impl="pallas", device="cuda")

    jc.reset_launches()
    t0 = time.perf_counter()
    res = optimize(gpu_calc, coords, z,
                   config=OptimizeConfig(nsteps=60, **cfg), device="cuda")
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launches = dict(jc.jacobi_eigh_cuda.variant_launches)

    torch.set_num_threads(8)
    t0 = time.perf_counter()
    # the CPU run takes the kernel's algorithm at the card's sweep counts
    # (its plain version): the reference's CPU Jacobi is one sweep short of
    # convergence on this RFO Hessian (steppers/rfo._eigh)
    cfg["eigh_impl"] = "kernel"
    cpu = optimize(SQM2(eigh_impl="kernel", device="cpu"), coords, z,
                   config=OptimizeConfig(nsteps=3, **cfg), device="cpu")
    cpu_s = time.perf_counter() - t0
    n_cmp = len(cpu.energy_history)
    diff = np.abs(res.energy_history[:n_cmp] - cpu.energy_history).max()
    out = {
        "phase": "slice_b", "config": "Diels-Alder SQM2 f64 rfo_fsb exact "
                                      "pallas",
        "n_iterations": res.n_iterations, "converged": bool(res.converged),
        "energies": res.energy_history.tolist(),
        "max_grad_final": float(res.gradient.abs().max()),
        "ms_per_step": gpu_s / max(res.n_iterations, 1) * 1e3,
        "run_s": gpu_s, "cpu_3_steps_s": cpu_s,
        "cpu_energies": cpu.energy_history.tolist(),
        "max_abs_e_diff_cpu_vs_card": float(diff),
        "kernel_launches": launches, "card": card}
    emit(out)
    if launches["block"] <= 0:
        raise AssertionError("slice B never launched the block variant")
    if not diff <= 1e-8:
        raise AssertionError(f"slice B: card and CPU energies differ by "
                             f"{diff:.3e} Ha (> 1e-8)")
    if not (np.isfinite(res.energy_history).all()
            and res.energy_history[-1] < res.energy_history[0]):
        raise AssertionError("slice B: the energy did not fall")
    return launches


def phase_autots(jc, card, full=False):
    """The flagship AutoTS on the card, K1 launches counted per stage."""
    from multioptpy_tpu_torch.calculators.sqm import SQM2
    from multioptpy_tpu_torch.device import cuda_ms
    from multioptpy_tpu_torch.flagship import flagship_config
    from multioptpy_tpu_torch.io.fixtures import diels_alder_reactant
    from multioptpy_tpu_torch.workflows.autots import autots

    coords, z = diels_alder_reactant()
    cfg = flagship_config(full)
    calc = SQM2(eigh_impl="pallas", device="cuda")
    seen, per_stage, detail = {}, {}, {}
    seen_shapes, stage_shapes, stage_s = {}, {}, {}
    clock = [0.0]

    def hook(name, **info):
        torch.cuda.synchronize()
        now_s = time.perf_counter()
        stage_s[name] = now_s - clock[0]
        clock[0] = now_s
        now = dict(jc.jacobi_eigh_cuda.variant_launches)
        per_stage[name] = {v: now[v] - seen.get(v, 0) for v in now}
        seen.update(now)
        shapes = dict(jc.jacobi_eigh_cuda.shape_launches)
        stage_shapes[name] = {k: n - seen_shapes.get(k, 0)
                              for k, n in shapes.items()
                              if n > seen_shapes.get(k, 0)}
        seen_shapes.update(shapes)
        detail.update(info)

    jc.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = clock[0] = time.perf_counter()
    res = autots(calc, coords, z, cfg, device="cuda", stage_hook=hook)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(jc.jacobi_eigh_cuda.variant_launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # K1's device time per stage, estimated as its launches at each shape
    # times that shape's kernel time, timed here on random matrices
    gen = torch.Generator().manual_seed(1)
    shape_ms = {}
    for b, d, tag, sweeps in sorted(set(seen_shapes)):
        a = random_sym(gen, b, d, {"f32": torch.float32,
                                   "f64": torch.float64}[tag])
        shape_ms[(b, d, tag, sweeps)] = cuda_ms(
            lambda: jc.jacobi_eigh_cuda(a, sweeps))
    k1_s = {name: sum(n * shape_ms[k] for k, n in shapes.items()) / 1e3
            for name, shapes in stage_shapes.items()}
    neb_res, irc_res = detail["neb"], res.irc_result
    out = {
        "phase": "full_flagship" if full else "autots",
        "config": ("tests/test_flagship_autots.py" if full else
                   "tests/test_tpu_flagship_smoke.py") + " on SQM2 f64, "
                  "eigh_impl=pallas, scan_chunk 16",
        "run_s": run_s, "stage_seconds": res.stage_seconds,
        "stage_s": stage_s, "k1_s_est": k1_s,
        "k1_share_est": {k: k1_s[k] / stage_s[k] for k in stage_s},
        "k1_shape_ms": {f"{b}x{d}x{d} {tag} sweeps={sw}": ms
                        for (b, d, tag, sw), ms in shape_ms.items()},
        "k1_launches_by_shape": {
            f"{b}x{d}x{d} {tag} sweeps={sw}": n
            for (b, d, tag, sw), n in sorted(seen_shapes.items())},
        "ts_energy": res.ts_energy, "barrier_forward": res.barrier_forward,
        "barrier_backward": res.barrier_backward,
        "n_imaginary": res.n_imaginary,
        "afir_steps": int(detail["afir"].n_iterations),
        "neb_n_iterations": neb_res.n_iterations,
        "neb_converged": bool(neb_res.converged),
        "irc_branch_lengths": [len(irc_res.forward_path),
                               len(irc_res.backward_path)],
        "candidates": [{k: c[k] for k in ("index", "energy", "n_imaginary",
                                          "converged")}
                       for c in res.candidates],
        "kernel_launches_by_stage": per_stage, "kernel_launches": launches,
        "peak_mem_gib": peak_gib, "card": card}
    if not full:
        out.update(reduced_on_cpu(res, detail, coords, z))
    emit(out)
    for stage in ("step2_neb", "step4_irc"):
        if per_stage[stage]["block"] <= 0:
            raise AssertionError(f"{out['phase']}: no block-variant launch "
                                 f"in {stage}")
    # the reference's own count: one imaginary mode in the full
    # configuration, none in the reduced one (its band has no interior
    # maximum; tests/test_torch_flagship_reduced.py)
    if not (res.n_imaginary == int(full) and np.isfinite(res.barrier_forward)
            and np.isfinite(res.barrier_backward)
            and res.barrier_forward > 0):
        raise AssertionError(f"{out['phase']}: n_imaginary "
                             f"{res.n_imaginary}, barriers "
                             f"{res.barrier_forward}, {res.barrier_backward}")
    if not full:
        for key, tol in (("afir", 1e-8), ("neb", 1e-8), ("ts", 1e-6),
                         ("barriers", 1e-5)):
            diff = out[f"max_abs_e_diff_cpu_vs_card_{key}"]
            if not diff <= tol:
                raise AssertionError(f"autots: card and CPU {key} energies "
                                     f"differ by {diff:.3e} Ha (> {tol})")
        if out["cpu_n_imaginary"] != res.n_imaginary:
            raise AssertionError(f"autots: {out['cpu_n_imaginary']} "
                                 f"imaginary modes on the CPU, "
                                 f"{res.n_imaginary} on the card")
    return launches, res


def reduced_on_cpu(res, detail, coords, z):
    """The reduced flagship's card run `res` against the port on the CPU:
    the AFIR stage's first 3 energies and the first 2 NEB band
    evaluations from the card's initial path through the kernel's
    algorithm (its plain version, at the card's sweep counts), and the
    whole pipeline through torch.linalg.eigh (the plain version would take
    minutes of the host's CPU at the IRC's 216-matrix batches): TS energy,
    barriers and imaginary modes."""
    import dataclasses

    from multioptpy_tpu_torch.calculators.sqm import SQM2
    from multioptpy_tpu_torch.drivers.neb import neb
    from multioptpy_tpu_torch.drivers.optimize import optimize
    from multioptpy_tpu_torch.flagship import flagship_config
    from multioptpy_tpu_torch.potentials import BiasEngine, get_potential
    from multioptpy_tpu_torch.workflows.autots import autots

    torch.set_num_threads(8)
    cfg = flagship_config(eigh_impl="kernel")
    calc = SQM2(eigh_impl="kernel", device="cpu")
    afir = BiasEngine([get_potential("afir", gamma=g, fragm_1=f1,
                                     fragm_2=f2, element_z=z)
                       for g, f1, f2 in cfg.afir_list])
    t0 = time.perf_counter()
    cpu_afir = optimize(calc, coords, z, bias_engine=afir,
                        config=dataclasses.replace(cfg.afir_opt, nsteps=2),
                        device="cpu")
    cpu_neb = neb(calc, detail["path0"].cpu(), z,
                  dataclasses.replace(cfg.neb, n_steps=2), device="cpu")
    prefix_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole = autots(SQM2(device="cpu"), coords, z,
                   flagship_config(eigh_impl="xla"), device="cpu")
    card_afir = detail["afir"].energy_history[:3]
    card_neb = detail["neb"].energy_history[:2]
    return {
        "cpu_prefix_s": prefix_s, "cpu_run_s": time.perf_counter() - t0,
        "afir_prefix_energies": card_afir.tolist(),
        "max_abs_e_diff_cpu_vs_card_afir": float(
            np.abs(card_afir - cpu_afir.energy_history).max()),
        "max_abs_e_diff_cpu_vs_card_neb": float(
            np.abs(card_neb - cpu_neb.energy_history).max()),
        "cpu_ts_energy": whole.ts_energy,
        "cpu_barrier_forward": whole.barrier_forward,
        "cpu_barrier_backward": whole.barrier_backward,
        "cpu_n_imaginary": whole.n_imaginary,
        "max_abs_e_diff_cpu_vs_card_ts": abs(whole.ts_energy
                                             - res.ts_energy),
        # the IRC's direction follows the sign K1 and LAPACK give the
        # imaginary mode, so the two barriers are compared as a set
        "max_abs_e_diff_cpu_vs_card_barriers": float(np.abs(
            np.sort([whole.barrier_forward, whole.barrier_backward])
            - np.sort([res.barrier_forward, res.barrier_backward])).max())}


def shape_counts(jc):
    return {f"{b}x{d}x{d} {tag} sweeps={sw}": n for (b, d, tag, sw), n
            in sorted(jc.jacobi_eigh_cuda.shape_launches.items())}


def phase_methods(jc, card, saddle_start, n_steps=METHOD_STEPS):
    """(a) the Diels-Alder method runs on SQM2 f64 and the RS-P-RFO sweep
    check; (b) the S8 ensemble through optimize_batch."""
    import dataclasses

    from multioptpy_tpu_torch.calculators.sqm import SQM, SQM2
    from multioptpy_tpu_torch.drivers.optimize import (OptimizeConfig,
                                                       optimize_batch)
    from multioptpy_tpu_torch.flagship import (method_runs, run_method,
                                               saddle_sweep_residuals)
    from multioptpy_tpu_torch.io.fixtures import diels_alder_reactant
    from multioptpy_tpu_torch.reaction_paths import CPU_RERUN_BAND
    from multioptpy_tpu_torch.steppers.rfo import (jacobi_sweeps_for,
                                                   rfo_extra_sweeps)

    torch.set_num_threads(8)
    reactant, z = diels_alder_reactant()
    starts = {"reactant": reactant, "saddle": saddle_start.cpu().numpy()}
    gpu_calc = SQM2(eigh_impl="pallas", device="cuda")
    cpu_calc = SQM2(eigh_impl=CPU_RERUN_BAND, device="cpu")
    totals = dict.fromkeys(jc.VARIANTS, 0)
    for label, kw, start in method_runs():
        jc.reset_launches()
        t0 = time.perf_counter()
        res = run_method(gpu_calc, starts[start], z, kw, n_steps, "pallas",
                         "cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(jc.jacobi_eigh_cuda.variant_launches)
        by_shape = shape_counts(jc)
        for v in totals:
            totals[v] += launches[v]
        t0 = time.perf_counter()
        cpu = run_method(cpu_calc, starts[start], z, kw, 2, "kernel", "cpu")
        cpu_s = time.perf_counter() - t0
        n = min(3, len(cpu.energy_history), len(res.energy_history))
        diff = float(np.abs(res.energy_history[:n]
                            - cpu.energy_history[:n]).max())
        out = {"phase": "methods", "run": label, "start": start,
               "steps": res.n_iterations, "converged": bool(res.converged),
               "ms_per_step": run_s / max(res.n_iterations, 1) * 1e3,
               "run_s": run_s, "cpu_2_steps_s": cpu_s,
               "energies_first3": res.energy_history[:3].tolist(),
               "energy_final": float(res.energy),
               "max_abs_e_diff_cpu_vs_card": diff,
               "kernel_launches": launches,
               "k1_launches_by_shape": by_shape, "card": card}
        emit(out)
        if not np.isfinite(res.energy_history).all():
            raise AssertionError(f"methods {label}: non-finite energies")
        if not diff <= 1e-8:
            raise AssertionError(f"methods {label}: card and CPU energies "
                                 f"differ by {diff:.3e} Ha (> 1e-8)")
        if "prfo" in kw["method"] or "mf_" in kw["method"]:
            if launches["block"] <= 0:
                raise AssertionError(f"methods {label}: no block-variant "
                                     "launch")

    # the RS-P-RFO Hessians of the saddle runs, kept by a second pass that
    # answers the step's eigensolves with torch.linalg.eigh
    sweeps = jacobi_sweeps_for(54) + rfo_extra_sweeps(torch.float64)
    t0 = time.perf_counter()
    check = saddle_sweep_residuals(saddle_start, "cuda", nsteps=n_steps)
    emit({"phase": "methods_sweep_check", "rs_prfo_sweeps": sweeps,
          "max_rel_offdiagonal_by_sweeps": check,
          "seconds": time.perf_counter() - t0, "card": card})
    for name, rows in check.items():
        if not rows[sweeps] <= 1e-12:
            raise AssertionError(f"methods sweep check {name}: "
                                 f"{rows[sweeps]:.3e} left after {sweeps}")

    # (b) the ensemble with first-order engines
    batch_n = 256
    rng = np.random.default_rng(11)
    batch = torch.as_tensor(s8_ring()[None] + 0.12 * rng.standard_normal(
        (batch_n, 8, 3)), dtype=torch.float32, device="cuda")
    zs = np.full(8, 16)
    calc = SQM(eigh_impl="pallas", device="cuda")
    cpu_calc = SQM(eigh_impl="kernel", device="cpu")
    e0 = calc.energy(batch[:8], zs).cpu().numpy()
    e0_cpu = cpu_calc.energy(batch[:8].cpu(), zs).numpy()
    for method in ("fire", "lbfgs", "adam"):
        cfg = OptimizeConfig(method=method, eigh_impl="pallas", **SQM_LOOSE)
        jc.reset_launches()
        t0 = time.perf_counter()
        res = optimize_batch(calc, batch, zs, config=cfg,
                             n_steps=ENSEMBLE_STEPS, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(jc.jacobi_eigh_cuda.variant_launches)
        by_shape = shape_counts(jc)
        for v in totals:
            totals[v] += launches[v]
        cpu = optimize_batch(cpu_calc, batch[:8].cpu(), zs,
                             config=dataclasses.replace(cfg,
                                                        eigh_impl="kernel"),
                             n_steps=2, device="cpu")
        card3 = np.concatenate([e0[None], res.energy_history[:2, :8]])
        cpu3 = np.concatenate([e0_cpu[None], cpu.energy_history])
        rel = float((np.abs(card3 - cpu3) / np.maximum(np.abs(cpu3), 1.0)
                     ).max())
        e_hist = res.energy_history
        out = {"phase": "methods_ensemble", "run": method,
               "config": "256xS8 SQM f32 pallas, optimize_batch",
               "steps": ENSEMBLE_STEPS,
               "n_converged": int(res.converged.sum()),
               "ms_per_structure_step": (run_s / (batch_n * ENSEMBLE_STEPS)
                                         * 1e3),
               "run_s": run_s,
               "median_e_initial": float(np.median(e0)),
               "median_e_final": float(np.median(e_hist[-1])),
               "max_rel_e_diff_cpu_vs_card_8": rel,
               "kernel_launches": launches, "k1_launches_by_shape": by_shape,
               "card": card}
        emit(out)
        if not (np.isfinite(e_hist).all() and rel <= 3e-5):
            raise AssertionError(f"methods ensemble {method}: {out}")
    return totals


def phase_reaction_paths(jc, card, full_res, rows):
    """nebmain and ircmain on the card through cli.main (SQM2 f64, the
    band eigh through K1), GPNEB and the Hessian tools, each against a CPU
    rerun through the kernel's algorithm (multioptpy_tpu_torch/
    reaction_paths.py). Appends kernel_check rows for any aldol band shape
    the runs launched that kernel_check did not hold."""
    from multioptpy_tpu_torch import reaction_paths as rp
    from multioptpy_tpu_torch.io.fixtures import diels_alder_reactant

    torch.set_num_threads(8)
    t_phase = time.perf_counter()
    totals = dict.fromkeys(jc.VARIANTS, 0)
    seen_shapes = set()

    def take():
        """Launches since the last reset (by variant, by shape); resets."""
        v = dict(jc.jacobi_eigh_cuda.variant_launches)
        shapes = dict(jc.jacobi_eigh_cuda.shape_launches)
        for k in totals:
            totals[k] += v[k]
        seen_shapes.update(shapes)
        by_shape = shape_counts(jc)
        jc.reset_launches()
        return v, by_shape

    def gate(ok, what, out):
        if not ok:
            raise AssertionError(f"reaction_paths {what}: {out}")

    reactant, z_da = diels_alder_reactant()
    # (a) full width: the flagship's IRC endpoints, 16 images, 100 steps
    jc.reset_launches()
    a = rp.full_width_neb(full_res.reactant_coords, full_res.product_coords,
                          z_da, "cuda")
    v, by_shape = take()
    out = {"phase": "reaction_paths", "part": "a_full_width",
           "run": "nebmain -sqm2 -nimg 16 -aconv -ns 100", **a,
           "kernel_launches": v, "k1_launches_by_shape": by_shape,
           "card": card}
    emit(out)
    gate(a["finite"] and a["interior_maximum"], "(a) band", out)
    gate(a["max_abs_e_diff_cpu_vs_card"] <= 1e-8, "(a) card vs CPU", out)
    gate(by_shape.get("16x72x72 f64 sweeps=9", 0) > 0 and v["block"] > 0,
         "(a) no block launch at 16x72x72", out)

    # (b) breadth on the relaxed aldol pair, 12 images, ALDOL_STEPS each
    t0 = time.perf_counter()
    pair = rp.relaxed_aldol_pair("cuda")
    v, by_shape = take()
    emit({"phase": "reaction_paths", "part": "b_relax_aldol_pair",
          "seconds": time.perf_counter() - t0, "kernel_launches": v,
          "k1_launches_by_shape": by_shape, "card": card})
    for run in rp.aldol_runs():
        b = rp.aldol_neb(run, pair, "cuda")
        v, by_shape = take()
        out = {"phase": "reaction_paths", "part": "b_aldol", **b,
               "kernel_launches": v, "k1_launches_by_shape": by_shape,
               "card": card}
        emit(out)
        gate(b["finite"] and b["max_abs_e_diff_cpu_vs_card"] <= 1e-8,
             f"(b) {run[0]}", out)
    g = rp.gpneb_run(pair, "cuda")
    v, by_shape = take()
    out = {"phase": "reaction_paths", "part": "b_aldol", **g,
           "kernel_launches": v, "k1_launches_by_shape": by_shape,
           "card": card}
    emit(out)
    # the bound of drivers/gpneb.py's docstring (the GP solve's
    # conditioning)
    gate(g["finite"] and g["max_abs_e_diff_cpu_vs_card"] <= 1e-10
         and g["max_abs_path_diff_cpu_vs_card"] <= 1e-9, "(b) gpneb", out)

    # (c) ircmain from the flagship's TS, IRC_STEPS of each integrator
    for row in rp.irc_runs(full_res.ts_coords, z_da, "cuda",
                           n_steps=IRC_STEPS, launch_counter=take):
        v, by_shape = row.pop("k1_launches_by_shape")
        out = {"phase": "reaction_paths", "part": "c_irc",
               "run": f"ircmain -sqm2 -im {row['method']} -ns {IRC_STEPS}",
               **row,
               "kernel_launches": v, "k1_launches_by_shape": by_shape,
               "card": card}
        emit(out)
        gate(row["finite"] and row["descends"], f"(c) {row['method']}", out)
        gate(row["max_abs_e_diff_cpu_vs_card"] <= 1e-8,
             f"(c) {row['method']} card vs CPU", out)
        gate(by_shape.get("108x72x72 f64 sweeps=9", 0) > 0,
             f"(c) {row['method']}: no K1 launch at 108x72x72", out)

    # (d) Hessian tools on the Diels-Alder reactant
    d = rp.hessian_tools(reactant, z_da, "cuda")
    v, by_shape = take()
    out = {"phase": "reaction_paths", "part": "d_hessian_tools", **d,
           "kernel_launches": v, "k1_launches_by_shape": by_shape,
           "card": card}
    emit(out)
    worst = max(d["model_kinds"].values())
    gate(worst <= 1e-10, "(d) model kinds card vs CPU", out)
    # o1numhess: a few hundred gradients' rounding through the secant
    # updates and the least-squares reconstruction
    gate(d["o1numhess_rel_diff"] <= 1e-8
         and d["o1numhess_full_rel_diff"] <= 1e-8, "(d) o1numhess", out)
    gate(d["optmain_modelhess_finite"] and d["optmain_modelhess_rc"] in (0, 1),
         "(d) optmain -modelhess", out)

    # f64 batches the runs launched beyond the kernel_check rows (the aldol
    # relaxation's gradient and Hessian, the -aneb band as it grows,
    # O1NumHess's displaced gradients)
    held = {(r["batch"], r["d"]) for r in rows}
    gen = torch.Generator().manual_seed(2)
    for b, dd in sorted({(b, dd) for b, dd, tag, _ in seen_shapes
                         if tag == "f64" and (b, dd) not in held}):
        rows.append(check_row(jc, gen, b, dd, torch.float64,
                              f"batch of {b} in reaction_paths", card))
    emit({"phase": "reaction_paths_done",
          "seconds": time.perf_counter() - t_phase,
          "kernel_launches": totals, "card": card})
    return totals


def phase_dynamics_and_double_ended(jc, card, full_res):
    """mdmain and ieipmain through cli.main on the flagship's Diels-Alder
    system (SQM2 f64, the band eigh through K1), every bias potential, an
    optimization under all of them, meta-IRC and ModeKill, each against a
    CPU rerun through the kernel's algorithm
    (multioptpy_tpu_torch/dynamics_paths.py)."""
    import tempfile

    from multioptpy_tpu_torch import dynamics_paths as dp
    from multioptpy_tpu_torch.io.fixtures import diels_alder_reactant

    torch.set_num_threads(8)
    t_phase = time.perf_counter()
    totals = dict.fromkeys(jc.VARIANTS, 0)

    def take():
        """A main-path run's launches since the last reset (by variant, by
        shape), added to the phase's totals; resets. A check or rerun on
        the card discards its own with jc.reset_launches()."""
        v = dict(jc.jacobi_eigh_cuda.variant_launches)
        for k in totals:
            totals[k] += v[k]
        by_shape = shape_counts(jc)
        jc.reset_launches()
        return v, by_shape

    def gate(ok, what, out):
        if not ok:
            raise AssertionError(f"dynamics_and_double_ended {what}: {out}")

    def put(out):
        out["phase_elapsed_s"] = time.perf_counter() - t_phase
        emit(out)

    def calls(by_shape, *shapes):
        return sum(n for k, n in by_shape.items()
                   if any(k.startswith(s) for s in shapes))

    _, z = diels_alder_reactant()
    n_atoms = len(z)
    reactant = full_res.reactant_coords.cpu().numpy()
    product = full_res.product_coords.cpu().numpy()
    ts = full_res.ts_coords.cpu().numpy()
    tmp = tempfile.TemporaryDirectory()
    work = tmp.name
    r_xyz = dp.write_structure(f"{work}/reactant.xyz", reactant, z)

    # (a) mdmain on the flagship's reactant
    profiles = {}
    for k, (label, flags, thermo) in enumerate(dp.md_runs()):
        jc.reset_launches()
        run = dp.mdmain_run(r_xyz, flags, "cuda", f"{work}/md{k}")
        v, by_shape = take()
        n_traj = 2 if "-ntraj" in flags else 1
        steps = int(flags[flags.index("-time") + 1]) * n_traj
        e = run["energies"]
        out = {"phase": "dynamics", "part": "a_mdmain",
               "run": f"mdmain -sqm2 {' '.join(flags)}", "steps": steps,
               "seconds": run["seconds"],
               "ms_per_step": run["seconds"] / steps * 1e3,
               "k1_launches_per_step": sum(v.values()) / steps,
               "finite": bool(np.isfinite(e).all()),
               "mean_temperature_K": float(e[:, 1].mean()),
               "kernel_launches": v, "k1_launches_by_shape": by_shape,
               "card": card}
        thermostat = flags[flags.index("-thermo") + 1]
        bias = tuple(dp._BIAS_FLAGS) if "-metad" in flags else ()
        cc = tuple(flags[flags.index("-cc") + 1:]) if "-cc" in flags else ()
        if (thermostat, bias, cc) not in profiles:
            profiles[(thermostat, bias, cc)] = dp.md_step_profile(
                reactant, z, thermostat, "cuda", bias, cc)
            jc.reset_launches()
        out["step_profile"] = profiles[(thermostat, bias, cc)]
        if thermostat == "none":
            v0, _ = dp.draws_of_seed(z, n_atoms, 0, "cuda")
            out["nve"] = dp.nve_check(reactant, z, v0, e, "cuda")
            out["total_energy_drift_Ha"] = out["nve"]["drift_Ha"]
            jc.reset_launches()
        if "-cc" in flags:
            d = np.linalg.norm(run["frames"][:, 1] - run["frames"][:, 2],
                               axis=1) * 0.52917721067
            out["shake_bond_max_dev_ang"] = float(np.abs(d - 1.47).max())
        if thermo is not None:
            n_noise = dp.MD_CMP_STEPS if thermo == "langevin" else 0
            v0, noise = dp.draws_of_seed(z, n_atoms, n_noise, "cuda")
            t0 = time.perf_counter()
            e_cpu, traj_cpu = dp.md_cpu_rerun(
                reactant, z, thermo, v0,
                noise if thermo == "langevin" else None)
            out["cpu_rerun_s"] = time.perf_counter() - t0
            m = dp.MD_CMP_STEPS
            out["max_abs_e_diff_cpu_vs_card"] = float(
                np.abs(e[:m, 0] - e_cpu).max())
            out["max_abs_x_diff_cpu_vs_card_bohr"] = float(
                np.abs(run["frames"][:m] - traj_cpu).max())
        put(out)
        gate(out["finite"], f"(a) {label} energies", out)
        gate(by_shape.get("1x72x72 f64 sweeps=9", 0) >= steps,
             f"(a) {label}: K1 not launched each step at 1x72x72", out)
        if thermo is not None:
            gate(out["max_abs_e_diff_cpu_vs_card"] <= 1e-10
                 and out["max_abs_x_diff_cpu_vs_card_bohr"] <= 1e-9,
                 f"(a) {label} card vs CPU", out)
        if "-cc" in flags:
            gate(out["shake_bond_max_dev_ang"] <= 1e-6, "(a) SHAKE", out)
        if thermostat == "none":
            # velocity Verlet: the drift is second order in the time step
            # when the forces are the energy's gradient
            nve = out["nve"]
            gate(nve["drift_Ha"] <= 1e-3 and nve["drift_ratio"] >= 3.0
                 and nve["max_abs_fd_minus_gradient"] <= 1e-8,
                 "(a) NVE energy conservation", out)

    # (b) every registered potential, then an optimization under all
    t0 = time.perf_counter()
    pc = dp.potentials_check(reactant, z, "cuda")
    v, by_shape = take()
    worst = {k: max(p[k] for p in pc.values())
             for k in ("rel_e", "rel_g", "rel_h")}
    out = {"phase": "dynamics", "part": "b_potentials", "count": len(pc),
           "seconds": time.perf_counter() - t0,
           "worst_rel_card_vs_cpu": worst,
           "worst_by": {k: max(pc, key=lambda n: pc[n][k]) for k in worst},
           "per_potential": pc, "card": card}
    put(out)
    gate(len(pc) == 36 and all(np.isfinite(p["energy"]) and p["energy"] != 0
                               for p in pc.values()), "(b) potentials", out)
    gate(max(worst.values()) <= 1e-12, "(b) card vs CPU", out)
    jc.reset_launches()
    card_opt = dp.biased_optimization(reactant, z, "cuda",
                                      n_steps=BIAS_OPT_STEPS)
    v, by_shape = take()
    _, bias_prof = dp.timed_and_profiled(
        lambda: dp.all_potentials_gradient(reactant, z, "cuda"))
    jc.reset_launches()
    t0 = time.perf_counter()
    cpu_opt = dp.biased_optimization(reactant, z, "cpu", n_steps=2)
    n = min(len(card_opt["energies"]), len(cpu_opt["energies"]))
    diff = np.abs(card_opt["energies"][:n] - cpu_opt["energies"][:n])
    out = {"phase": "dynamics", "part": "b_optimize_all_potentials",
           "steps": card_opt["steps"], "seconds": card_opt["seconds"],
           "ms_per_step": card_opt["seconds"] / card_opt["steps"] * 1e3,
           "cpu_s": time.perf_counter() - t0,
           "energies": card_opt["energies"].tolist(),
           "max_abs_e_diff_cpu_vs_card_first3": float(diff.max()),
           "bias_gradient_profile": bias_prof,
           "kernel_launches": v, "k1_launches_by_shape": by_shape,
           "card": card}
    put(out)
    gate(np.isfinite(card_opt["energies"]).all()
         and out["max_abs_e_diff_cpu_vs_card_first3"] <= 1e-8,
         "(b) optimization under all potentials", out)

    # (c) ieipmain between the flagship's IRC endpoints and from their
    # relaxed minima
    t0 = time.perf_counter()
    mins = dp.relaxed_minima(reactant, product, z, "cuda")
    take()  # the ieipmain runs' starts
    put({"phase": "dynamics", "part": "c_relaxed_minima",
         "seconds": time.perf_counter() - t0, "energies": mins["energies"],
         "steps": mins["steps"], "card": card})
    geoms = {"reactant": reactant, "product": product,
             "reactant_min": mins["reactant"],
             "product_min": mins["product"]}
    xyz = {k: dp.write_structure(f"{work}/{k}.xyz", x, z)
           for k, x in geoms.items()}
    for k, (label, engine, flags, start, end, check) in enumerate(
            dp.ieip_runs()):
        jc.reset_launches()
        run = dp.ieipmain_run(xyz[start], xyz.get(end), flags, "cuda",
                              f"{work}/ieip{k}")
        v, by_shape = take()
        n_calls = calls(by_shape, "1x72x72", "2x72x72")
        out = {"phase": "dynamics", "part": "c_ieipmain", "engine": label,
               "run": f"ieipmain {start}.xyz"
                      + (f" -i2 {end}.xyz" if end else "")
                      + f" -sqm2 {' '.join(flags)}",
               "seconds": run["seconds"], "ts_energy": run["ts_energy"],
               "ts_energy_minus_flagship_ts": run["ts_energy"]
               - full_res.ts_energy,
               "calculator_calls": n_calls,
               "ms_per_call": run["seconds"] / max(n_calls, 1) * 1e3,
               "kernel_launches": v, "k1_launches_by_shape": by_shape,
               "card": card}
        t0 = time.perf_counter()
        if check == "saddle":
            # a channel turned over and refine_saddle took its Hessians;
            # the refined point's imaginary modes are reported
            sc = dp.saddle_check(run["ts_guess"], run["ts_energy"], z,
                                 "cuda")
            jc.reset_launches()
            out.update({"ts_guess_imaginary_modes": sc["n_imaginary"],
                        "abs_e_diff_cpu_vs_card":
                        sc["abs_e_diff_cpu_vs_card"]})
            bound = 1e-8
        else:
            args = (engine, geoms[start],
                    None if end is None else geoms[end], z)
            e_card, prof = dp.timed_and_profiled(
                lambda: dp.ieip_first_iterations(*args, "cuda"))
            jc.reset_launches()
            t0 = time.perf_counter()
            e_cpu = dp.ieip_first_iterations(*args, "cpu")
            out.update({"first_iterations_energies": e_card.tolist(),
                        "first_iterations_profile": prof,
                        "abs_e_diff_cpu_vs_card": dp.first_iterations_diff(
                            engine, e_card, e_cpu)})
            bound = 1e-8
            if engine in ("2pshs", "addf"):
                # a second CPU witness, LAPACK's eigh in place of the
                # kernel's algorithm: how far the scaled spheres amplify
                # the rounding of two correct eigensolvers
                e_lapack = dp.ieip_first_iterations(*args, "cpu", "xla")
                out["abs_e_diff_cpu_lapack_vs_cpu_kernel"] = \
                    dp.first_iterations_diff(engine, e_lapack, e_cpu)
            if engine == "addf":
                # ADDF's first sphere lies tens of Bohr out along the
                # softest modes: the card is held to ten times what the
                # two CPU eigensolvers differ by, never looser than 1e-8
                bound = max(bound, 10 * out[
                    "abs_e_diff_cpu_lapack_vs_cpu_kernel"])
        out["cpu_rerun_s"] = time.perf_counter() - t0
        out["card_vs_cpu_bound"] = bound
        put(out)
        gate(np.isfinite(run["ts_energy"]) and n_calls > 0,
             f"(c) {label}", out)
        gate(out["abs_e_diff_cpu_vs_card"] <= bound,
             f"(c) {label} card vs CPU", out)
        if engine in ("2pshs", "addf"):
            gate(by_shape.get("108x72x72 f64 sweeps=9", 0) > 0,
                 f"(c) {label}: no K1 launch at 108x72x72", out)
        if check == "saddle":
            gate(by_shape.get("108x72x72 f64 sweeps=9", 0) > 1,
                 f"(c) {label}: no saddle refinement", out)

    # (d) meta-IRC from a displaced minimum; ModeKill on a second-order
    # saddle made from the flagship's TS
    rng = np.random.default_rng(5)
    start = reactant + 0.05 * rng.standard_normal(reactant.shape)
    jc.reset_launches()
    run = dp.meta_irc_run(start, z, "cuda", META_IRC_STEPS)
    v, by_shape = take()
    _, irc_prof = dp.timed_and_profiled(
        lambda: dp.meta_irc_run(start, z, "cuda", 1))
    jc.reset_launches()
    cpu = dp.meta_irc_run(start, z, "cpu", 2)
    diff = float(np.abs(run["energies"][:2] - cpu["energies"]).max())
    out = {"phase": "dynamics", "part": "d_meta_irc", "steps":
           len(run["energies"]), "seconds": run["seconds"],
           "ms_per_step": run["seconds"] / len(run["energies"]) * 1e3,
           "start_energy": run["start_energy"],
           "final_energy": float(run["energies"][-1]),
           "max_abs_e_diff_cpu_vs_card": diff,
           "one_step_profile": irc_prof, "kernel_launches": v,
           "k1_launches_by_shape": by_shape, "card": card}
    put(out)
    gate(np.isfinite(run["energies"]).all()
         and run["energies"][-1] < run["start_energy"] and diff <= 1e-8,
         "(d) meta_irc", out)
    bias, n_imag = dp.second_order_saddle_bias(ts, z)
    jc.reset_launches()
    full = dp.modekill_run(ts, z, "cuda", keep_order=1, max_rounds=3,
                           opt_steps=30, bias_engine=bias)
    v, by_shape = take()
    short = dp.modekill_run(ts, z, "cuda", keep_order=1, max_rounds=1,
                            opt_steps=2, bias_engine=bias)
    jc.reset_launches()
    cpu = dp.modekill_run(ts, z, "cpu", keep_order=1, max_rounds=1,
                          opt_steps=2, bias_engine=bias)
    out = {"phase": "dynamics", "part": "d_modekill",
           "start": "flagship TS under keep -1.0 a.u. on C2-C3 at its length",
           "imaginary_modes_before": n_imag,
           "seconds": full["seconds"],
           "imaginary_modes_after": full["n_imaginary"],
           "energy_after": full["energy"],
           "first_round_abs_e_diff_cpu_vs_card": abs(short["energy"]
                                                     - cpu["energy"]),
           "first_round_max_abs_x_diff_bohr": float(
               np.abs(short["coords"] - cpu["coords"]).max()),
           "kernel_launches": v, "k1_launches_by_shape": by_shape,
           "card": card}
    put(out)
    gate(n_imag == 2 and full["n_imaginary"] <= 1
         and np.isfinite(full["energy"])
         and out["first_round_abs_e_diff_cpu_vs_card"] <= 1e-8
         and out["first_round_max_abs_x_diff_bohr"] <= 1e-7,
         "(d) modekill", out)
    tmp.cleanup()
    emit({"phase": "dynamics_done",
          "seconds": time.perf_counter() - t_phase,
          "kernel_launches": totals, "card": card})
    return totals


def phase_workflows(jc, card, full_res, rows):
    """confsearch, relaxedscan, orientsearch and run_mapper, the v2
    workflow engine and metadynamics on the card (SQM2 f64, the band eigh
    through K1; multioptpy_tpu_torch/workflow_paths.py), each against a
    CPU rerun through the kernel's algorithm. Appends kernel_check rows
    for the new shapes: n-octane's band (104) and RS-RFO Hessian (78) at
    batches of 1 and 16, and orientsearch's 16x54 RS-RFO Hessian, timed;
    every other f64 batch the phase launched, held to the plain version."""
    import tempfile

    from multioptpy_tpu_torch import workflow_paths as wp
    from multioptpy_tpu_torch.dynamics_paths import write_structure
    from multioptpy_tpu_torch.io.fixtures import (alkane_chain,
                                                  diels_alder_reactant)

    torch.set_num_threads(8)
    t_phase = time.perf_counter()
    totals = dict.fromkeys(jc.VARIANTS, 0)
    seen_shapes = set()

    def take():
        """A main-path run's launches since the last reset (by variant, by
        shape), added to the phase's totals; resets. A check or rerun on
        the card discards its own with jc.reset_launches()."""
        v = dict(jc.jacobi_eigh_cuda.variant_launches)
        for k in totals:
            totals[k] += v[k]
        seen_shapes.update(jc.jacobi_eigh_cuda.shape_launches)
        by_shape = shape_counts(jc)
        jc.reset_launches()
        return v, by_shape

    def gate(ok, what, out):
        if not ok:
            raise AssertionError(f"workflows {what}: {out}")

    def put(out):
        out["phase_elapsed_s"] = time.perf_counter() - t_phase
        emit(out)

    tmp = tempfile.TemporaryDirectory()
    work = tmp.name
    da, z_da = diels_alder_reactant()
    oc, z_oc = alkane_chain(wp.OCTANE_CARBONS)
    da_xyz = write_structure(f"{work}/diels_alder.xyz", da, z_da)
    oc_xyz = write_structure(f"{work}/n_octane.xyz", oc, z_oc)

    # (a) confsearch on n-octane, 16 candidates a round, 2 rounds
    jc.reset_launches()
    run = wp.confsearch_run(oc_xyz, "cuda", f"{work}/conf")
    v, by_shape = take()
    first = run.pop("first_round")
    kicked = first["kick"]["kicked"]
    calc = wp.SQM2(eigh_impl="pallas", device="cuda")
    prof = wp.relax_step_profile(calc, kicked, z_oc)
    band = wp.band_check(kicked, z_oc, "cuda")
    sweep = wp.rfo_sweep_check(kicked, z_oc, "cuda")
    jc.reset_launches()
    t0 = time.perf_counter()
    card_kr = wp.kick_and_relax(first, z_oc, "cuda")
    jc.reset_launches()
    cpu_kr = wp.kick_and_relax(first, z_oc, "cpu", eigh_impl="kernel")
    card_relax = wp.card_relax_energies(first, z_oc, "cuda")
    jc.reset_launches()
    out = {"phase": "workflows", "part": "a_confsearch",
           "run": "confsearch n_octane.xyz " + " ".join(wp.CONF_FLAGS)
                  + " --eigh_impl pallas", **run,
           "relax_step_profile": prof, **band, **sweep,
           "cpu_rerun_s": time.perf_counter() - t0,
           "kick_first5_max_abs_e_diff_cpu_vs_card": float(np.abs(
               card_kr["kick_energies"] - cpu_kr["kick_energies"]).max()),
           "kick_first5_max_abs_x_diff_bohr": float(np.abs(
               card_kr["kick_coords"] - cpu_kr["kick_coords"]).max()),
           "relax_first3_max_abs_e_diff_cpu_vs_card": float(np.abs(
               card_relax - cpu_kr["relax_energies"]).max()),
           "relax_first3_card_rerun_vs_run": float(np.abs(
               card_relax - card_kr["relax_energies"]).max()),
           "kernel_launches": v, "k1_launches_by_shape": by_shape,
           "card": card}
    put(out)
    gate(run["finite"] and run["nonfinite"] == 0 and run["rounds"] == 2,
         "(a) confsearch", out)
    gate(by_shape.get("16x104x104 f64 sweeps=9", 0) > 0
         and by_shape.get("16x78x78 f64 sweeps=15", 0) > 0,
         "(a) no K1 launch at 16x104 or 16x78", out)
    gate(band["max_abs_e_diff_k1_vs_eigh"] <= 1e-10, "(a) band check", out)
    gate(sweep["rfo_max_rel_offdiagonal"] <= 1e-12, "(a) RS-RFO sweeps", out)
    gate(max(out["kick_first5_max_abs_e_diff_cpu_vs_card"],
             out["relax_first3_max_abs_e_diff_cpu_vs_card"]) <= 1e-8,
         "(a) card vs CPU", out)

    # (b) relaxedscan along the forming C1-C1' bond
    jc.reset_launches()
    run = wp.relaxedscan_run(da_xyz, "cuda", f"{work}/scan")
    v, by_shape = take()
    t0 = time.perf_counter()
    e_card = wp.scan_first_point(da, z_da, "cuda")
    jc.reset_launches()
    e_cpu = wp.scan_first_point(da, z_da, "cpu", eigh_impl="kernel")
    out = {"phase": "workflows", "part": "b_relaxedscan",
           "run": "relaxedscan diels_alder.xyz " + " ".join(wp.SCAN_FLAGS)
                  + " --eigh_impl pallas", **run,
           "cpu_rerun_s": time.perf_counter() - t0,
           "first_point_first3_max_abs_e_diff_cpu_vs_card": float(np.abs(
               e_card - e_cpu).max()),
           "kernel_launches": v, "k1_launches_by_shape": by_shape,
           "card": card}
    put(out)
    gate(run["finite"] and run["points"] == 6
         and run["max_constraint_dev_ang"] <= 1e-4, "(b) relaxedscan", out)
    gate(out["first_point_first3_max_abs_e_diff_cpu_vs_card"] <= 1e-8,
         "(b) card vs CPU", out)

    # (c) orientsearch: the dienophile placed 3.5 Angstrom off, 16 samples
    jc.reset_launches()
    run = wp.orientsearch_run(da_xyz, "cuda", f"{work}/orient")
    v, by_shape = take()
    t0 = time.perf_counter()
    diff = wp.orientsearch_cpu_check(da, z_da, "cuda")
    jc.reset_launches()
    out = {"phase": "workflows", "part": "c_orientsearch",
           "run": "orientsearch diels_alder.xyz " + " ".join(wp.ORIENT_FLAGS)
                  + " --eigh_impl pallas", **run,
           "cpu_rerun_s": time.perf_counter() - t0,
           "first3_max_abs_e_diff_cpu_vs_card": diff,
           "kernel_launches": v, "k1_launches_by_shape": by_shape,
           "card": card}
    put(out)
    gate(run["finite"] and run["sorted"] and run["samples"] == 16,
         "(c) orientsearch", out)
    gate(by_shape.get("16x72x72 f64 sweeps=9", 0) > 0
         and by_shape.get("16x54x54 f64 sweeps=14", 0) > 0,
         "(c) no K1 launch at 16x72 or 16x54", out)
    gate(diff <= 1e-8, "(c) card vs CPU", out)

    # (d) metadynamics on the C1-C1' distance, Langevin
    jc.reset_launches()
    run = wp.metadynamics_run(da, z_da, "cuda")
    v, by_shape = take()
    t0 = time.perf_counter()
    de, dx = wp.metadynamics_cpu_check(da, z_da, "cuda")
    jc.reset_launches()
    out = {"phase": "workflows", "part": "d_metadynamics",
           "run": f"run_metadynamics cv {wp.METAD_CV} langevin, "
                  f"{wp.METAD_HILLS} hills every {wp.METAD_EVERY} steps",
           **run, "cpu_rerun_s": time.perf_counter() - t0,
           "first5_max_abs_e_diff_cpu_vs_card": de,
           "first5_max_abs_x_diff_bohr": dx,
           "kernel_launches": v, "k1_launches_by_shape": by_shape,
           "card": card}
    put(out)
    gate(run["finite"], "(d) metadynamics", out)
    gate(de <= 1e-10 and dx <= 1e-9, "(d) card vs CPU", out)

    # (e) run_autots with a v2 workflow between the flagship's IRC ends
    reactant = full_res.reactant_coords.cpu().numpy()
    product = full_res.product_coords.cpu().numpy()
    r_xyz, p_xyz = wp.write_pair(work, reactant, product, z_da)
    jc.reset_launches()
    run = wp.autots_v2_run(r_xyz, p_xyz, "cuda", f"{work}/v2")
    v, by_shape = take()
    t0 = time.perf_counter()
    e_card = run.pop("neb_energies")[:wp.V2_CMP_ITERATIONS]
    e_cpu = wp.v2_neb_cpu_rerun(r_xyz, p_xyz, f"{work}/v2_cpu")
    saddle = next(r for r in run["reports"] if r["step"] == "saddle")
    freq = next(r for r in run["reports"] if r["step"] == "freq")
    out = {"phase": "workflows", "part": "e_autots_v2",
           "run": "run_autots irc_reactant.xyz -prod irc_product.xyz -sqm2 "
                  "-cfg v2.json (neb -> saddle -> freq -> irc)", **run,
           "saddle_converged": saddle["converged"],
           "freq_n_imaginary": freq["n_imaginary"],
           "flagship_n_imaginary": full_res.n_imaginary,
           "ts_energy_minus_flagship_ts": saddle["energy"]
           - full_res.ts_energy,
           "cpu_rerun_s": time.perf_counter() - t0,
           "neb_first2_max_abs_e_diff_cpu_vs_card": float(np.abs(
               e_card - e_cpu).max()),
           "kernel_launches": v, "k1_launches_by_shape": by_shape,
           "card": card}
    put(out)
    gate(run["steps"] == ["neb", "saddle", "freq", "irc"]
         and run["ts_written"], "(e) v2 workflow", out)
    # the saddle step refines the flagship's own TS: one imaginary mode,
    # its energy that of the flagship's saddle
    gate(saddle["converged"] and freq["n_imaginary"] == 1
         and abs(out["ts_energy_minus_flagship_ts"]) <= 1e-6,
         "(e) v2 saddle", out)
    gate(out["neb_first2_max_abs_e_diff_cpu_vs_card"] <= 1e-8,
         "(e) card vs CPU", out)

    # (f) run_mapper from the Diels-Alder reactant: the batched AFIR
    # executor (batch_size 2), 2 explorations, each task's AutoTS at the
    # mapper's defaults
    jc.reset_launches()
    run = wp.mapper_run(da_xyz, "cuda", f"{work}/mapper")
    v, by_shape = take()
    batches = run.pop("afir_batches")
    t0 = time.perf_counter()
    e_card = wp.afir_executor_first_steps(batches[0], z_da, "cuda")
    jc.reset_launches()
    e_cpu = wp.afir_executor_first_steps(batches[0], z_da, "cpu",
                                         eigh_impl="kernel")
    out = {"phase": "workflows", "part": "f_run_mapper",
           "run": "run_mapper diels_alder.xyz -sqm2 -cfg mapper.json "
                  f"{json.dumps(wp.mapper_cfg())} --eigh_impl pallas, then "
                  "run_mapper --resume --max_iter 0", **run,
           "afir_batches": len(batches),
           "cpu_rerun_s": time.perf_counter() - t0,
           "executor_first3_max_abs_e_diff_cpu_vs_card": float(np.abs(
               e_card - e_cpu).max()),
           "kernel_launches": v, "k1_launches_by_shape": by_shape,
           "card": card}
    put(out)
    gate(run["network_json"] and run["resumed_nodes"] == run["nodes"]
         and run["priorities_finite"] and len(batches) > 0,
         "(f) run_mapper", out)
    # every task ran its AutoTS to the end: none skipped for an error, and
    # each one's TS count is reported (a count other than one adds no edge)
    gate(run["skipped_for_error"] == 0
         and len(run["task_n_imaginary"]) == run["tasks"],
         "(f) tasks skipped", out)
    gate(out["executor_first3_max_abs_e_diff_cpu_vs_card"] <= 1e-8,
         "(f) card vs CPU", out)
    tmp.cleanup()

    # the new shapes, timed; then every other f64 batch the phase launched
    phase_s = time.perf_counter() - t_phase
    gen = torch.Generator().manual_seed(3)
    for b, d, where in ((1, 104, "n-octane SQM2 band per gradient"),
                        (16, 104, "n-octane band of 16 conformers"),
                        (1, 78, "n-octane RFO step"),
                        (16, 78, "n-octane RFO step of 16 conformers"),
                        (16, 54, "Diels-Alder RFO step of 16 orientations")):
        rows.append(check_row(jc, gen, b, d, torch.float64, where, card))
    held = {(r["batch"], r["d"], r["sweeps"]) for r in rows}
    for b, dd, sw in sorted({(b, dd, sw) for b, dd, tag, sw in seen_shapes
                             if tag == "f64" and (b, dd, sw) not in held}):
        rows.append(check_row(jc, gen, b, dd, torch.float64,
                              f"batch of {b} in workflows", card,
                              timed=False, sweeps=sw))
    emit({"phase": "workflows_done", "seconds": phase_s,
          "with_kernel_rows_s": time.perf_counter() - t_phase,
          "kernel_launches": totals, "card": card})
    return totals


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, str(REPO))
    from multioptpy_tpu_torch.device import resolve_device
    from multioptpy_tpu_torch.ops import jacobi_cuda as jc

    resolve_device("cuda")
    card = card_line()
    emit({"phase": "start", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    t_start = time.perf_counter()
    rows = phase_kernel_check(jc, card)
    main_path = [phase_slice_a(jc, card), phase_slice_b(jc, card),
                 phase_autots(jc, card)[0]]
    full_launches, full_res = phase_autots(jc, card, full=True)
    from multioptpy_tpu_torch.flagship import saddle_start
    main_path += [full_launches,
                  phase_methods(jc, card, saddle_start(full_res)),
                  phase_reaction_paths(jc, card, full_res, rows),
                  phase_dynamics_and_double_ended(jc, card, full_res),
                  phase_workflows(jc, card, full_res, rows)]

    kernels = []
    for variant in jc.VARIANTS:
        checked = [r for r in rows if r["variant"] == variant]
        timed = [r for r in checked if "ms" in r]
        sum_of = lambda k: sum(r[k] for r in timed)  # noqa: E731
        kernels.append({
            "name": f"jacobi_eigh_{variant}",
            "route": "cuda",
            "source": "multioptpy_tpu_torch/csrc/jacobi_eigh.cu",
            "replaces": "multioptpy_tpu/ops/jacobi_pallas.py:39",
            "launches": sum(run[variant] for run in main_path),
            "max_abs_err": max(r["eig_err_vs_plain"] for r in checked),
            "ms": sum_of("ms"),
            "plain_ms": sum_of("plain_ms"),
            "bound_ms": sum_of("bound_ms"),
            "bound_by": ("operations" if all(r["bound_by"] == "operations"
                                             for r in timed) else "bytes"),
            "library_ms": sum_of("library_ms"),
            "shapes": [f"{r['batch']}x{r['d']}x{r['d']} {r['dtype']} "
                       f"sweeps={r['sweeps']}" for r in timed],
            "kernel_only_ms": sum_of("kernel_only_ms"),
            "note": "ms (wrapper), kernel_only_ms (launch alone), plain_ms, "
                    "bound_ms, library_ms: one call at each main-path shape "
                    "of this variant, summed"})
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
