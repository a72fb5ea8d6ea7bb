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
     torch.linalg.eigvalsh; then K3, the batched tridiagonal eigensolver
     past K1's gate (csrc/tridiag_eigh.cu), against its plain version at
     588 x 392, 1 x 392, 1 x 294 and 16 x 392 f64 (phase_k3_check).
 1b. c32h66_start: the main path's K3. The start of a C32H66 job as the
     benchmark's c32h66.opt1 runs it (98 atoms, SQM2 f64, rfo_fsb from the
     exact Hessian: 588 displaced gradients in one batch, whose band and
     Loewdin solves take the "k3" route at 588 x 392), 2 steps through
     `optimize`, held to the same job with K3's table emptied (those
     solves on torch.linalg.eigh): energies 1e-10 Ha, coordinates 1e-9
     Bohr. K3's launch counts are set to 0 just before its job and never
     again, so the kernels line's K3 launches are the main path's.
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
     1x104, 16x104 (9 sweeps), 1x78, 16x78 (15) and 16x54 (14), and at
     every other f64 batch the phase's main runs launched, all timed. In this
     phase and the dynamics phase, the launches of a check or rerun on
     the card are discarded: the kernels line counts the main runs'.
 10. optmain_surface: the rest of optmain on SQM2 f64, each part held to
     the CPU (multioptpy_tpu_torch/optmain_paths.py). (a) optmain ts.xyz
     -sqm2 -opt rfo_bofill -order 1 -fc 5 -freq -temp 298.15 -press
     101325 -cmds -pca -km -gi bond 1,11 bond 4,12 --eigh_impl pallas from
     the full flagship's TS: converged, exactly one imaginary mode, finite
     thermochemistry, one animation per mode above 10 cm^-1, a point-group
     line, input.json, run_log.csv and geometry_params.csv, a K1 launch at
     the Hessian's 108x72; SQM2's exact Hessian at the final geometry on
     the card and on the CPU (the kernel's algorithm): one imaginary mode
     each, frequencies within 1e-3 cm^-1 and RRHO within 1e-8 Ha; and
     -force_freq from the reactant after 5 unconverged steps, finite. (b)
     SQM2 orbitals at the TS and the natural reaction orbitals from the
     IRC's reactant end, card against CPU (1e-10 Ha orbital energies,
     1e-8 density and NRO eigenvalues). (c) -oniom 11-18 lj (the
     dienophile as the SQM2 layer: K1 at 1x32 and the Hessian's 108x32),
     and with -mi 3; (d) -mf seam 1 2 (the cation doublet as the second
     state: SQM2 takes no multiplicity); (e) -of 1-10 11-18 -kp 0.1 3.0
     1,11 (bias_param_grads.csv, one row a step), then EDEEL's seam
     target with the diene as donor and the dienophile as acceptor (K1 at
     1x40 and 1x32) against the CPU (1e-10 Ha, 1e-8 Ha/Bohr): 20 steps
     each from the reactant, finite, the first 3 within 1e-8 Ha of the
     CPU's. (f) optmain -calc emt on Cu13 and -calc tersoff on Si8, 20
     steps each, every energy within 1e-8 Ha of the CPU's. (g) the five
     Jobs on the card (SQM2 optimization, MD, an 8-image band and an EIP
     search between the flagship's IRC ends, 5 steps each; AutoTS on
     Muller-Brown), finite; then optimize's StageTimer on 10 SQM2 steps
     with and without RunLogger's callback (the logger's host cost a
     step). kernel_check rows follow at 1x32 and 1x40, and at every
     other f64 batch the phase's main runs launched, all timed.
 11. cli_surface: the command-line flags that act, at full width, each
     part held to the CPU (multioptpy_tpu_torch/cli_paths.py). (a)
     optmain ts.xyz -calc sqm2 -order 1 -o rfo_bofill -ns 5 -irc 0.1 10
     lqa --eigh_impl pallas from the full flagship's TS: the chain takes
     the IRC (not the meta-IRC), one imaginary mode at the optimized
     geometry on the card and on the CPU, the IRC's point count printed,
     its first 3 energies of each branch within 1e-10 Ha of the same IRC
     on the CPU (branches matched: the imaginary mode's sign is each
     eigensolver's), K1 at 1x54, 108x72, 2x72 and 216x72. (b) run_autots
     ts.xyz -calc sqm2 -cfg v1.json with skip_to_step4 (saddle refinement,
     a 10-step LQA IRC, 20 steps at each end): one imaginary mode, the
     refined TS within 1e-9 Ha of the flagship's and of the CPU's energy
     there, ts.xyz, irc_end_1.xyz and irc_end_2.xyz written. (c) optmain
     diels_alder.xyz -calc sqm -srb -ns 10 --eigh_impl pallas: a non-zero
     SRB term at the reactant, the run's first energy SQM's without it
     plus the term (1e-10 Ha), its first 3 energies within 1e-10 Ha of the
     CPU's. (d) relaxedscan -sqm2 -scan bond 1,11 3.2,2.6 -nsample 3 -ns
     5 under -diis gdiis -d 0.5 and under -opt sd -d 0.5 --eigh_impl
     pallas: each point's energy within 1e-8 Ha of the same scan on the
     CPU. Timed kernel_check rows follow for every f64 batch the phase's
     main runs launched that no row holds yet.
 12. mesh: the device mesh on meshes of cuda:0 (multioptpy_tpu_torch/
     mesh_paths.py), each sharded run against its unsharded counterpart on
     the card. (a) On the full flagship's 16-image initial band, 4 shards
     of 4 images (SQM2 f64, K1 at 4x72 a gradient): CI-NEB with FIRE for
     20 iterations (climbing from 10), held to the card's own
     make_neb_step loop to 1e-10 Ha and 1e-9 Bohr and its first 3
     iterations' energies to the same band's on the CPU (the kernel's
     algorithm) to 1e-8 Ha; qsm2 (the gathered band) for 10 and NEB with
     the global L-BFGS clock for 8 (1e-10 Ha, 1e-10 / 1e-9 Bohr). (b) The
     full flagship AutoTS with mesh = 2 shards of cuda:0 (8 images a
     shard, one saddle candidate a shard, 250 band iterations without
     redistribution, as the reference's mesh path runs them; the saddle
     refinement cut from 120 steps to 60: mesh_paths.
     FLAGSHIP_SADDLE_STEPS): one imaginary mode, two distinct IRC
     endpoints below the TS; the band within 1e-10 Ha and 1e-9 Bohr of the
     same 250 iterations unsharded (neb_scan), the TS within 1e-6 Ha of an
     unsharded refinement of the same NEB image; its gap to the unsharded
     full flagship's TS, whose band redistributes every 25 iterations,
     printed (another saddle: ROADMAP Queue 3, F11); each stage's wall
     time beside the unsharded one's. Then -aneb 1 5 for 10 iterations on
     (b)'s band (the flagship's initial band has no interior maximum)
     through aneb_sharded against a one-shard mesh with the same rounding
     (1e-10), the band grown to a multiple of 4. (c) One round of 16
     n-octane conformer candidates (-sqm2 -bsize 16 -pbc, kick and
     relaxation cut to 10 steps each: mesh_paths.CONF_*), 4 shards of 4
     (K1 at 4x104, 4x78 and 624x104), held to the unsharded round to 1e-10
     Ha and 1e-8 Bohr; slice A's 256 rings (SQM f32) through
     sharded_optimize_batch for 10 steps, 4 shards of 64 (K1 at 64x24,
     64x32 and 3072x32 f32), every step held to 3e-5 of |E| (slice A's f32
     bound) of the same 64-ring blocks run unsharded one by one and of the
     unsharded run of all 256. The F12 check before it (ROADMAP Queue 3):
     the step paths' matrix-vector product (device.bmv) on one member and
     on 64 equal to the same members of a batch of 256, to the bit, at
     D = 24, 32 (f32), 54, 72, 104 (f64), beside `a @ x[..., None]`'s gaps;
     slice A's initial state and 3 steps, tensor by tensor, for the first
     64 rings and for the first ring alone against the 256 (the 64 to the
     bit); one step op by op (a dispatch mode) for 64, 16 and 1 ring from
     the same state: no op may differ for 64 or 16, and the first ops that
     differ for the ring alone are printed with their call sites. (d)
     2 shards: GPNEB on the Muller-Brown band of 4 images (1e-10 Ha, 1e-9
     Bohr), the mapper's batched AFIR executor on two Diels-Alder tasks,
     one a shard (1e-10 Bohr), optimize_batch on tests/test_parallel.py's
     LJ batch (rtol 1e-10). (e) The tensor-parallel SQM2 gradient (f64,
     tp_energy_and_gradient; meshes of cuda:0 on the axis "tp"): the
     98-atom C32H66 (alkane_chain(32), band 392: torch.linalg.eigh through
     K1's gate) on 1, 2 and 4 shards (rows 98; 49+49; 25+25+24+24),
     each held to the unsharded gradient on the card to 1e-12 Ha and 1e-12
     Ha/Bohr, and the card's to the port's CPU result to 1e-9 Ha and 1e-8
     Ha/Bohr; 5 rfo_fsb steps of it through `optimize` with
     SQM2(tp_mesh=2 shards) from the default model Hessian (Lindh) against
     the same steps unsharded (1e-10 Ha, 1e-9 Bohr: mesh_paths.TP_STEPS);
     n-octane on 2 shards (13+13), whose 104-wide band launches K1 at
     1x104 f64, held to 1e-12. Each run prints its shards, rows or members
     per shard, wall s, ms per step, iteration or gradient beside the
     unsharded run's and their ratio, its K1 launches by shape and its
     gaps; the launches counted are the sharded runs'. Timed kernel_check
     rows follow for every shape the phase launched that no timed row
     holds yet.
Slice A must launch the warp variant and slice B the block variant. The
kernel_check rows time the wrapper and the kernel launch alone (padded
input, no sort or gather) as the median of 3 groups of CUDA-event timings
each, the plain version as one call after a warm one (the call it is
compared with), torch.linalg.eigh
as the wrapper, or as one call after a warm one where a call takes over
0.1 s. Then
the kernels line (one entry per K1 variant, one for K3), the card's name
and power limit, and last the fixed
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


def once_ms(fn):
    """One call of fn on the card, ms by CUDA events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def check_row(jc, gen, b, d, dtype, where, card, timed=True, sweeps=None):
    """One kernel_check row: the kernel against its plain version on a
    random (b, d, d) batch at `sweeps`, else at the sweeps of `where` (a
    main-path shape: its `eigh64.plan` count; the near-degenerate and boundary
    rows 12), timed with the plain version, torch.linalg.eigh and the bound
    when `timed`. Emits the row and raises when the kernel disagrees."""
    from multioptpy_tpu_torch.device import cuda_ms
    from multioptpy_tpu_torch.ops.eigh64 import (jacobi_sweeps_for,
                                                 rfo_extra_sweeps)

    # clustered spectra converge slowly: the near-degenerate batch and
    # the boundary rows (B = 12289 random matrices hold close pairs)
    # get 12 sweeps; every main-path shape the main path's (`plan`:
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
        # one timed call after a warm one (the comparison's above): the
        # plain version takes 0.1-3 s
        row["plain_ms"] = once_ms(lambda: jc.jacobi_eigh_plain(a, sw))
        # torch.linalg.eigh takes up to seconds at the largest batches:
        # one timed call after a warm one there
        lib_ms = cuda_ms(lambda: torch.linalg.eigh(a), reps=1)
        row["library_ms"] = (lib_ms if lib_ms > 100.0 else
                             median_ms(lambda: torch.linalg.eigh(a)))
        row["bound_ms"], row["bound_by"] = bound_ms(b, d, sw, dtype)
    emit({"phase": "kernel_check", **row, "card": card})
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{row}")
    return row


def phase_kernel_check(jc, card):
    from multioptpy_tpu_torch.ops.cuda_build import build

    t0 = time.perf_counter()
    lib_path, log = build(jc.SOURCE)
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
    # the batches `eigh_fast` sends to the kernel in the benchmark's cells
    # (ops/eigh64.eigh_route), at the route's sweep count
    from multioptpy_tpu_torch.ops.eigh64 import k1_sweeps
    routed = [(16, 104, "n-octane Loewdin of 16 conformers"),
              (2496, 104, "n-octane Loewdin, exact Hessians of 16"),
              (16, 78, "n-octane RS-RFO step of 16 conformers"),
              (16, 54, "Diels-Alder RS-RFO step of 16 orientations"),
              (16, 72, "Diels-Alder Loewdin of 16 orientations"),
              (1728, 72, "Diels-Alder Loewdin, exact Hessians of 16"),
              (108, 72, "Diels-Alder Loewdin, exact Hessian"),
              (156, 104, "n-octane Loewdin, exact Hessian"),
              (16, 28, "n-octane EEQ of 16 conformers"),
              (2496, 28, "n-octane EEQ, exact Hessians of 16"),
              (1728, 20, "Diels-Alder EEQ, exact Hessians of 16"),
              (588, 99, "C32H66 EEQ, exact Hessian")]
    rows += [check_row(jc, gen, b, d, torch.float64, f"eigh_fast: {where}",
                       card, sweeps=k1_sweeps(d, torch.float64))
             for b, d, where in routed]

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


def k3_row(tc, gen, b, d, where, card):
    """One kernel_check row of K3 (ops/tridiag_cuda.py) on a random f64
    (b, d, d) batch: values against its plain version on up to three
    members (the first, middle and last: the plain version's QL chain runs
    in Python, ~2.5 s a 392 x 392 matrix), reconstruction and orthonormality
    on all, each within 1e-11 of max|a|; the wrapper and the launch alone
    (tridiag_cuda.launch: no checks or reshapes) timed as the median of 3
    groups of CUDA events, the plain version's members once, and
    torch.linalg.eigh and the bound (9 D^3 operations a matrix at the
    peak, gpu_bench/roofline/eigh.py's count). Emits the row and raises
    when K3 disagrees."""
    from multioptpy_tpu_torch.device import cuda_ms

    a = random_sym(gen, b, d, torch.float64)
    w, v = tc.tridiag_eigh_cuda(a)
    torch.cuda.synchronize()
    scale = max(1.0, a.abs().max().item())
    members = sorted({0, b // 2, b - 1})
    t0 = time.perf_counter()
    w_p = torch.cat([tc.tridiag_eigh_plain(a[k:k + 1].cpu())[0]
                     for k in members])
    plain_s = time.perf_counter() - t0
    eye = torch.eye(d, dtype=torch.float64, device="cuda")
    row = {"kernel": "k3", "batch": b, "d": d, "dtype": "float64",
           "where": where,
           "eig_err_vs_plain": (w[members].cpu() - w_p).abs().max().item(),
           "reconstruction_err": (torch.einsum("bij,bj,bkj->bik", v, w, v)
                                  - a).abs().max().item(),
           "orthonormality_err": (v.mT @ v - eye).abs().max().item(),
           "scale": scale, "plain_members": len(members)}
    row["ok"] = (row["eig_err_vs_plain"] <= 1e-11 * scale
                 and row["reconstruction_err"] <= 1e-11 * scale
                 and row["orthonormality_err"] <= 1e-11)
    row["ms"] = median_ms(lambda: tc.tridiag_eigh_cuda(a))
    a3 = a.contiguous()
    row["kernel_only_ms"] = median_ms(lambda: tc.launch(a3))
    row["plain_ms"] = 1e3 * plain_s
    lib_ms = cuda_ms(lambda: torch.linalg.eigh(a), reps=1)
    row["library_ms"] = (lib_ms if lib_ms > 100.0 else
                         median_ms(lambda: torch.linalg.eigh(a)))
    ops = 9.0 * d ** 3 * b / PEAK_OPS[torch.float64]
    byt = b * (2 * d * d + d) * 8 / PEAK_BYTES
    row["bound_ms"] = 1e3 * max(ops, byt)
    row["bound_by"] = "operations" if ops > byt else "bytes"
    emit({"phase": "kernel_check", **row, "card": card})
    if not row["ok"]:
        raise AssertionError(f"K3 disagrees with its plain version: {row}")
    return row


def phase_k3_check(card):
    """K3 at C32H66's shapes past K1's gate: the exact Hessian's 588 band
    and Loewdin matrices, a step's 1 x 392 and 1 x 294 (which the route
    leaves on cuSOLVER), and a 16-member batch's 16 x 392."""
    from multioptpy_tpu_torch.ops import tridiag_cuda as tc
    from multioptpy_tpu_torch.ops.cuda_build import build

    t0 = time.perf_counter()
    lib_path, log = build(tc.SOURCE)
    emit({"phase": "build", "library": str(lib_path.relative_to(REPO)),
          "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})
    gen = torch.Generator().manual_seed(19)
    return [k3_row(tc, gen, b, d, where, card) for b, d, where in (
        (588, 392, "C32H66 band and Loewdin, exact Hessian"),
        (1, 392, "C32H66 band and Loewdin, a step"),
        (1, 294, "C32H66 RS-RFO step"),
        (16, 392, "C32H66 band of 16 members"))]


def phase_c32h66_start(jc, card):
    """c32h66.opt1's job start on the card (module docstring, 1b). The job
    through K3 runs second, each after a warm gradient; K1's and K3's
    counts are set to 0 just before it. Returns its K1 launches."""
    from multioptpy_tpu_torch.calculators.sqm import SQM2
    from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig, optimize
    from multioptpy_tpu_torch.io.fixtures import alkane_chain
    from multioptpy_tpu_torch.logging_utils import StageTimer, recording
    from multioptpy_tpu_torch.ops import eigh64
    from multioptpy_tpu_torch.ops import tridiag_cuda as tc
    from multioptpy_tpu_torch.units import ANGSTROM2BOHR

    c, z = alkane_chain(32)
    rng = np.random.default_rng(32)
    x = torch.as_tensor(c + 0.1 * ANGSTROM2BOHR * rng.standard_normal(
        c.shape), device="cuda")
    calc = SQM2(device="cuda")
    cfg = OptimizeConfig(method="rfo_fsb", init_hessian="exact", nsteps=2)
    table, runs = eigh64.K3_MIN_BATCH, {}
    for route in ("cusolver", "k3"):
        eigh64.K3_MIN_BATCH = table if route == "k3" else {}
        try:
            calc.energy_and_gradient(x[None], z)
            jc.reset_launches()
            tc.reset_launches()
            rec = StageTimer()
            t0 = time.perf_counter()
            with recording(rec):
                res = optimize(calc, x, z, config=cfg, device="cuda")
            torch.cuda.synchronize()
            runs[route] = (time.perf_counter() - t0, res, rec.eigh_calls)
        finally:
            eigh64.K3_MIN_BATCH = table
    launches = dict(jc.jacobi_eigh_cuda.variant_launches)
    k3_launches = dict(tc.tridiag_eigh_cuda.stage_launches)
    (lib_s, lib, lib_calls), (k3_s, k3, k3_calls) = runs["cusolver"], \
        runs["k3"]
    n_cmp = min(len(lib.energy_history), len(k3.energy_history))
    out = {
        "phase": "c32h66_start", "config": "C32H66 SQM2 f64 rfo_fsb exact, "
                                           "2 steps",
        "run_s_k3": k3_s, "run_s_cusolver": lib_s,
        "k3_calls": {f"{b}x{d} {dt} {caller}": n
                     for (caller, route, b, d, dt), n in k3_calls.items()
                     if route == "k3"},
        "k3_calls_with_table_emptied": sum(
            n for key, n in lib_calls.items() if key[1] == "k3"),
        "k3_kernel_launches": k3_launches, "kernel_launches": launches,
        "max_abs_e_diff_vs_cusolver": float(np.abs(
            k3.energy_history[:n_cmp] - lib.energy_history[:n_cmp]).max()),
        "max_abs_x_diff_vs_cusolver": float(
            (k3.coords - lib.coords).abs().max()),
        "card": card}
    emit(out)
    if not (out["k3_calls"] and all(k.startswith("588x392 ")
                                    for k in out["k3_calls"])
            and sum(out["k3_calls"].values()) == 2
            and out["k3_calls_with_table_emptied"] == 0
            and k3_launches["sytrd"] == 2):
        raise AssertionError(f"c32h66_start: the start's two 588 x 392 "
                             f"solves did not take K3: {out}")
    if not (out["max_abs_e_diff_vs_cusolver"] <= 1e-10
            and out["max_abs_x_diff_vs_cusolver"] <= 1e-9):
        raise AssertionError(f"c32h66_start: K3's job differs from "
                             f"cuSOLVER's: {out}")
    return launches


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
    # convergence on this RFO Hessian (ops/eigh64.plan)
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
    return launches, res, detail


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
    from multioptpy_tpu_torch.ops.eigh64 import (jacobi_sweeps_for,
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
    batches of 1 and 16, and orientsearch's 16x54 RS-RFO Hessian, and
    every other f64 batch the phase launched, all timed."""
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

    # the new shapes; then every other f64 batch the phase launched, timed
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
                              sweeps=sw))
    emit({"phase": "workflows_done", "seconds": phase_s,
          "with_kernel_rows_s": time.perf_counter() - t_phase,
          "kernel_launches": totals, "card": card})
    return totals


def phase_optmain_surface(jc, card, full_res, rows):
    """The rest of optmain on the card (SQM2 f64 on the Diels-Alder system;
    multioptpy_tpu_torch/optmain_paths.py), each part held to the CPU: (a)
    -freq from the full flagship's TS and -force_freq from the reactant,
    (b) orbitals, (c) ONIOM with and without -mi, (d) a two-state seam,
    (e) fragment-averaged gradients under a bias and EDEEL's fragments,
    (f) EMT and Tersoff, (g) the five Jobs. Appends timed kernel_check
    rows for the new K1 shapes 1x32 and 1x40 and every other f64 batch the
    main runs launched."""
    import tempfile

    from multioptpy_tpu_torch import optmain_paths as op
    from multioptpy_tpu_torch.dynamics_paths import write_structure
    from multioptpy_tpu_torch.io.fixtures import diels_alder_reactant

    torch.set_num_threads(8)
    t_phase = time.perf_counter()
    totals = dict.fromkeys(jc.VARIANTS, 0)
    seen_shapes = set()

    def take():
        """A main run's launches since the last reset, added to the phase's
        totals (a check on the card discards its own with
        jc.reset_launches())."""
        v = dict(jc.jacobi_eigh_cuda.variant_launches)
        for k in totals:
            totals[k] += v[k]
        seen_shapes.update(jc.jacobi_eigh_cuda.shape_launches)
        by_shape = shape_counts(jc)
        jc.reset_launches()
        return v, by_shape

    def gate(ok, what, out):
        if not ok:
            raise AssertionError(f"optmain_surface {what}: {out}")

    def put(out):
        out["phase_elapsed_s"] = time.perf_counter() - t_phase
        emit(out)

    tmp = tempfile.TemporaryDirectory()
    work = tmp.name
    da, z = diels_alder_reactant()
    da_xyz = write_structure(f"{work}/diels_alder.xyz", da, z)
    ts_xyz = write_structure(f"{work}/ts.xyz", full_res.ts_coords, z)

    # (a) -freq at the flagship's TS; -force_freq from the reactant
    jc.reset_launches()
    run = op.freq_run(ts_xyz, "cuda", f"{work}/freq", eigh_impl="pallas")
    v, by_shape = take()
    coords, _ = op.final_geometry(f"{work}/freq")
    t0 = time.perf_counter()
    check = op.freq_check(coords, z, "cuda")
    jc.reset_launches()
    forced = op.optmain(da_xyz, op.FORCE_FREQ_FLAGS, "cuda",
                        f"{work}/force_freq", eigh_impl="pallas")
    v2, by_shape2 = take()
    forced_freqs = np.loadtxt(f"{work}/force_freq/frequencies_cm1.csv")
    out = {"phase": "optmain_surface", "part": "a_freq",
           "run": "optmain ts.xyz " + " ".join(op.TS_FLAGS)
                  + " --eigh_impl pallas", **run,
           "ts_energy_minus_flagship_ts": run["final_energy"]
           - full_res.ts_energy,
           "card_vs_cpu": check, "cpu_check_s": time.perf_counter() - t0,
           "force_freq": {"run": "optmain diels_alder.xyz "
                                 + " ".join(op.FORCE_FREQ_FLAGS),
                          "seconds": forced["seconds"],
                          "ms_per_step": forced["ms_per_step"],
                          "converged": forced["converged"],
                          "frequencies_finite": bool(np.isfinite(
                              forced_freqs).all()),
                          "thermochemistry": op.thermochemistry(
                              f"{work}/force_freq"),
                          "kernel_launches": v2,
                          "k1_launches_by_shape": by_shape2},
           "kernel_launches": v, "k1_launches_by_shape": by_shape,
           "card": card}
    put(out)
    gate(run["converged"] and run["n_imaginary"] == 1
         and run["thermo_finite"]
         and run["animations"] == run["modes_above_10"]
         and run["point_group_line"] is not None
         and {"input.json", "run_log.csv", "geometry_params.csv"}
         <= set(run["files"]), "(a) -freq at the TS", out)
    gate(check["n_imaginary_card_cpu"] == [1, 1]
         and check["freq_max_abs_diff_cm1"] <= 1e-3
         and check["rrho_max_abs_diff_ha"] <= 1e-8, "(a) card vs CPU", out)
    gate(by_shape.get("108x72x72 f64 sweeps=9", 0) > 0,
         "(a) no K1 launch at the Hessian's 108x72", out)
    gate(not forced["converged"] and out["force_freq"]["frequencies_finite"]
         and np.isfinite(list(out["force_freq"]["thermochemistry"]
                              .values())).all(), "(a) -force_freq", out)

    # (b) orbitals at the TS; NROs from the IRC's reactant end to the TS
    jc.reset_launches()
    orb = op.orbitals_check(coords, full_res.reactant_coords.cpu().numpy(),
                            z, "cuda")
    v, by_shape = take()
    out = {"phase": "optmain_surface", "part": "b_orbitals", **orb,
           "kernel_launches": v, "k1_launches_by_shape": by_shape,
           "card": card}
    put(out)
    gate(orb["orbital_energy_max_abs_diff"] <= 1e-10
         and orb["density_max_abs_diff"] <= 1e-8
         and orb["nro_eigenvalue_max_abs_diff"] <= 1e-8, "(b) orbitals",
         out)

    # (c) ONIOM, (d) two states, (e) fragments: 20 steps each from the
    # reactant, the first 3 again on the CPU
    expect = {"c_oniom": ("1x32x32", "108x32x32"),
              "c_oniom_mi": ("1x32x32", "108x32x32"),
              "d_two_state": ("1x72x72", "108x72x72"),
              "e_fragments": ("1x72x72",)}
    for tag, flags in op.WRAPPER_RUNS:
        jc.reset_launches()
        run = op.optmain(da_xyz, (*flags, "-ns", str(op.WRAPPER_STEPS)),
                         "cuda", f"{work}/{tag}", eigh_impl="pallas")
        v, by_shape = take()
        t0 = time.perf_counter()
        gap = op.wrapper_cpu_check(da_xyz, flags, run["energies"],
                                   f"{work}/{tag}_cpu")
        e = run.pop("energies")
        run.pop("stdout")
        out = {"phase": "optmain_surface", "part": tag,
               "run": "optmain diels_alder.xyz " + " ".join(flags)
                      + f" -ns {op.WRAPPER_STEPS} --eigh_impl pallas",
               **run, "first_energy": float(e[0]), "last_energy": float(e[-1]),
               "finite": bool(np.isfinite(e).all()),
               "cpu_rerun_s": time.perf_counter() - t0,
               f"first{op.CMP_STEPS}_max_abs_e_diff_cpu_vs_card": gap,
               "kernel_launches": v, "k1_launches_by_shape": by_shape,
               "card": card}
        if tag == "e_fragments":
            pg = np.loadtxt(f"{work}/{tag}/bias_param_grads.csv", ndmin=2)
            out["bias_param_grads_rows"] = len(pg)
            # EDEEL's energy, gradient and diabatic energies on the card
            # (a main run: its CPU half launches nothing)
            out["edeel"] = op.edeel_check(da, z, "cuda")
            (out["edeel"]["kernel_launches"],
             out["edeel"]["k1_launches_by_shape"]) = take()
        put(out)
        gate(out["finite"] and run["steps"] > 0, f"({tag[0]}) {tag}", out)
        gate(gap <= 1e-8, f"({tag[0]}) {tag} card vs CPU", out)
        gate(all(any(k.startswith(s + " f64") for k in by_shape)
                 for s in expect[tag]), f"({tag[0]}) {tag} K1 shapes", out)
        if tag == "e_fragments":
            gate(out["bias_param_grads_rows"] == run["steps"]
                 and out["edeel"]["energy_abs_diff"] <= 1e-10
                 and out["edeel"]["gradient_max_abs_diff"] <= 1e-8
                 and any(k.startswith("1x40x40 f64") for k in
                         out["edeel"]["k1_launches_by_shape"]),
                 "(e) bias_param_grads.csv and EDEEL", out)

    # (f) EMT on Cu13 and Tersoff on Si8, card against CPU at every step
    jc.reset_launches()
    toys = op.toy_runs("cuda", work)
    v, by_shape = take()
    out = {"phase": "optmain_surface", "part": "f_emt_tersoff", **toys,
           "kernel_launches": v, "k1_launches_by_shape": by_shape,
           "card": card}
    put(out)
    gate(all(r["max_abs_e_diff_cpu_vs_card"] <= 1e-8
             and np.isfinite(r["final_energy"]) for r in toys.values()),
         "(f) EMT / Tersoff", out)

    # (g) the five Jobs on the card
    jc.reset_launches()
    jobs = op.jobs_run(full_res.reactant_coords.cpu().numpy(),
                       full_res.product_coords.cpu().numpy(), z, "cuda")
    v, by_shape = take()
    # the cost of RunLogger's per-step host reads, by optimize's timer
    logging = op.logger_cost(da, z, "cuda", f"{work}/logger")
    jc.reset_launches()
    out = {"phase": "optmain_surface", "part": "g_jobs", "jobs": jobs,
           "kernel_launches": v, "k1_launches_by_shape": by_shape,
           "logging": logging, "card": card}
    put(out)
    gate(all(r["finite"] for r in jobs.values()), "(g) Jobs", out)
    gate(logging["run_logger"]["steps"] == logging["empty"]["steps"] > 0,
         "(g) timer", out)
    tmp.cleanup()

    # the new shapes, timed at the main runs' sweeps; then every other
    # f64 batch the phase launched
    phase_s = time.perf_counter() - t_phase
    gen = torch.Generator().manual_seed(8)
    timed = {(b, d): sw for b, d, tag, sw in seen_shapes
             if tag == "f64" and b == 1 and d in (32, 40)}
    for (b, d), where in (((1, 32), "ONIOM model / acrolein SQM2 band"),
                          ((1, 40), "EDEEL diene SQM2 band")):
        rows.append(check_row(jc, gen, b, d, torch.float64, where, card,
                              sweeps=timed.get((b, d))))
    held = {(r["batch"], r["d"], r["sweeps"]) for r in rows}
    for b, dd, sw in sorted({(b, dd, sw) for b, dd, tag, sw in seen_shapes
                             if tag == "f64" and (b, dd, sw) not in held}):
        rows.append(check_row(jc, gen, b, dd, torch.float64,
                              f"batch of {b} in optmain_surface", card,
                              sweeps=sw))
    emit({"phase": "optmain_surface_done", "seconds": phase_s,
          "with_kernel_rows_s": time.perf_counter() - t_phase,
          "kernel_launches": totals, "card": card})
    return totals


def phase_cli_surface(jc, card, full_res, rows):
    """The command-line flags that act, at full width on the Diels-Alder
    system (multioptpy_tpu_torch/cli_paths.py), each part held to the CPU:
    (a) optmain -irc from the full flagship's TS, (b) run_autots with a v1
    config that sets skip_to_step4 from that TS, (c) optmain -calc sqm
    -srb from the reactant, (d) relaxedscan under -diis gdiis -d 0.5 and
    under -opt sd -d 0.5. Appends timed kernel_check rows for every f64
    batch the phase's main runs launched that no row holds yet."""
    import tempfile

    from multioptpy_tpu_torch import cli_paths as cp
    from multioptpy_tpu_torch.calculators.sqm import SQM2
    from multioptpy_tpu_torch.dynamics_paths import write_structure
    from multioptpy_tpu_torch.io.fixtures import diels_alder_reactant
    from multioptpy_tpu_torch.io.xyz import read_xyz
    from multioptpy_tpu_torch.optmain_paths import optmain
    from multioptpy_tpu_torch.units import ANGSTROM2BOHR
    from multioptpy_tpu_torch.workflow_paths import relaxedscan_run

    torch.set_num_threads(8)
    t_phase = time.perf_counter()
    totals = dict.fromkeys(jc.VARIANTS, 0)
    seen_shapes = set()

    def take():
        """A main run's launches since the last reset, added to the phase's
        totals (a check on the card discards its own with
        jc.reset_launches())."""
        v = dict(jc.jacobi_eigh_cuda.variant_launches)
        for k in totals:
            totals[k] += v[k]
        seen_shapes.update(jc.jacobi_eigh_cuda.shape_launches)
        by_shape = shape_counts(jc)
        jc.reset_launches()
        return v, by_shape

    def gate(ok, what, out):
        if not ok:
            raise AssertionError(f"cli_surface {what}: {out}")

    def put(out):
        out["phase_elapsed_s"] = time.perf_counter() - t_phase
        emit(out)

    tmp = tempfile.TemporaryDirectory()
    work = tmp.name
    da, z = diels_alder_reactant()
    da_xyz = write_structure(f"{work}/diels_alder.xyz", da, z)
    ts_xyz = write_structure(f"{work}/ts.xyz", full_res.ts_coords, z)

    # (a) optmain -irc from the flagship's TS
    jc.reset_launches()
    run = cp.irc_chain_run(ts_xyz, "cuda", f"{work}/irc")
    v, by_shape = take()
    check = cp.irc_chain_cpu_check(run, z, "cuda")
    jc.reset_launches()
    gap_key = f"first{cp.IRC_CMP}_max_abs_e_diff_cpu_vs_card"
    out = {"phase": "cli_surface", "part": "a_optmain_irc",
           "run": "optmain ts.xyz " + " ".join(cp.IRC_FLAGS)
                  + " --eigh_impl pallas",
           **{k: run[k] for k in ("seconds", "steps", "converged",
                                  "took_irc", "irc_points")},
           "irc_first3": {"forward": run["forward"][:3].tolist(),
                          "backward": run["backward"][:3].tolist()},
           "finite": bool(np.isfinite(run["forward"]).all()
                          and np.isfinite(run["backward"]).all()),
           "card_vs_cpu": check, "kernel_launches": v,
           "k1_launches_by_shape": by_shape, "card": card}
    put(out)
    gate(run["took_irc"] and check["n_imaginary_card_cpu"] == [1, 1]
         and out["finite"]
         and run["irc_points"] == len(run["forward"]) * 2 > 0,
         "(a) the chain took the IRC from one imaginary mode", out)
    gate(check[gap_key] <= 1e-10, "(a) card vs CPU", out)
    gate(all(any(k.startswith(s + " f64") for k in by_shape)
             for s in ("1x54x54", "108x72x72", "2x72x72", "216x72x72")),
         "(a) K1 shapes", out)

    # (b) run_autots -cfg v1.json with skip_to_step4 from the same TS
    jc.reset_launches()
    run = cp.skip_to_step4_run(ts_xyz, "cuda", f"{work}/autots")
    v, by_shape = take()
    e_cpu = float(SQM2(device="cpu").energy(
        torch.as_tensor(run["ts"])[None], z)[0])
    out = {"phase": "cli_surface", "part": "b_skip_to_step4",
           "run": "run_autots ts.xyz -calc sqm2 -cfg v1.json",
           "config": cp.SKIP_TO_STEP4,
           **{k: run[k] for k in ("seconds", "ts_energy", "n_imaginary",
                                  "files", "last_line")},
           "ts_energy_minus_flagship_ts": run["ts_energy"]
           - full_res.ts_energy,
           # ts.xyz's comment carries 10 decimals
           "cpu_energy_at_ts_minus_card": e_cpu - run["ts_energy"],
           "kernel_launches": v, "k1_launches_by_shape": by_shape,
           "card": card}
    put(out)
    gate(run["n_imaginary"] == 1
         and abs(out["ts_energy_minus_flagship_ts"]) <= 1e-9
         and abs(out["cpu_energy_at_ts_minus_card"]) <= 1e-9
         and run["files"] == ["irc_end_1.xyz", "irc_end_2.xyz", "ts.xyz"],
         "(b) skip_to_step4", out)

    # (c) optmain -calc sqm -srb from the reactant
    jc.reset_launches()
    run = optmain(da_xyz, (*cp.SRB_FLAGS, "-ns", str(cp.SRB_STEPS)), "cuda",
                  f"{work}/srb", eigh_impl="pallas")
    v, by_shape = take()
    term = cp.srb_term(read_xyz(da_xyz)[1] * ANGSTROM2BOHR, z, "cuda")
    jc.reset_launches()
    cpu = optmain(da_xyz, (*cp.SRB_FLAGS, "-ns", str(cp.SRB_CMP - 1)), "cpu",
                  f"{work}/srb_cpu")
    e = run.pop("energies")
    run.pop("stdout")
    n = min(cp.SRB_CMP, len(e), len(cpu["energies"]))
    gap_key = f"first{cp.SRB_CMP}_max_abs_e_diff_cpu_vs_card"
    out = {"phase": "cli_surface", "part": "c_sqm_srb",
           "run": "optmain diels_alder.xyz " + " ".join(cp.SRB_FLAGS)
                  + f" -ns {cp.SRB_STEPS} --eigh_impl pallas",
           **run, "first_energy": float(e[0]), "last_energy": float(e[-1]),
           "finite": bool(np.isfinite(e).all()), **term,
           "first_energy_minus_srb_sum": float(e[0]) - (
               term["energy_without_srb"] + term["srb_energy"]),
           "cpu_rerun_s": cpu["seconds"],
           gap_key: float(np.abs(e[:n] - cpu["energies"][:n]).max()),
           "kernel_launches": v, "k1_launches_by_shape": by_shape,
           "card": card}
    put(out)
    gate(out["finite"] and abs(term["srb_energy"]) > 1e-6
         and abs(out["first_energy_minus_srb_sum"]) <= 1e-10,
         "(c) the SRB term at the reactant", out)
    gate(out[gap_key] <= 1e-10, "(c) card vs CPU", out)

    # (d) relaxedscan under -diis gdiis -d 0.5 and under -opt sd -d 0.5;
    # the CPU's step and band through LAPACK
    for tag, flags in cp.SCAN_RUNS.items():
        flags = (*cp.SCAN_FLAGS, *flags)
        jc.reset_launches()
        run = relaxedscan_run(da_xyz, "cuda", f"{work}/scan_{tag}", flags)
        v, by_shape = take()
        cpu = relaxedscan_run(da_xyz, "cpu", f"{work}/scan_{tag}_cpu", flags,
                              eigh_impl="xla")
        out = {"phase": "cli_surface", "part": f"d_relaxedscan_{tag}",
               "run": "relaxedscan diels_alder.xyz " + " ".join(flags)
                      + " --eigh_impl pallas", **run,
               "cpu_rerun_s": cpu["seconds"],
               "max_abs_e_diff_cpu_vs_card": float(np.abs(
                   np.subtract(run["energies"], cpu["energies"])).max()),
               "kernel_launches": v, "k1_launches_by_shape": by_shape,
               "card": card}
        put(out)
        gate(run["finite"] and run["points"] == 3
             and out["max_abs_e_diff_cpu_vs_card"] <= 1e-8,
             f"(d) relaxedscan {tag} card vs CPU", out)
    tmp.cleanup()

    # every f64 batch the phase launched that no row holds yet, timed
    phase_s = time.perf_counter() - t_phase
    gen = torch.Generator().manual_seed(10)
    held = {(r["batch"], r["d"], r["sweeps"]) for r in rows
            if r["dtype"] == "float64"}
    for b, dd, sw in sorted({(b, dd, sw) for b, dd, tag, sw in seen_shapes
                             if tag == "f64" and (b, dd, sw) not in held}):
        rows.append(check_row(jc, gen, b, dd, torch.float64,
                              f"batch of {b} in cli_surface", card,
                              sweeps=sw))
    emit({"phase": "cli_surface_done", "seconds": phase_s,
          "with_kernel_rows_s": time.perf_counter() - t_phase,
          "kernel_launches": totals, "card": card})
    return totals


def phase_mesh(jc, card, full_res, full_detail, rows):
    """The device mesh on meshes of cuda:0 (multioptpy_tpu_torch/
    mesh_paths.py), each sharded run held to its unsharded counterpart on
    the card: (a) the sharded band on the full flagship's 16-image initial
    band, 4 shards (CI-NEB with FIRE, its first iterations also on a CPU
    mesh; qsm2; NEB with L-BFGS; -aneb 1 5); (b) the full flagship AutoTS
    on 2 shards against the unsharded one of `phase_autots`; (c) a
    16-candidate n-octane conformer round and slice A's 256 rings through
    sharded_optimize_batch, 4 shards, after the F12 check (a member's
    step does not depend on its batch); (d) GPNEB, the mapper's batched
    AFIR executor and optimize_batch on 2 shards; (e) the tensor-parallel
    SQM2 gradient of C32H66 on 1, 2 and 4 shards, 5 rfo_fsb steps of it on
    2, n-octane on 2. The launches counted are the sharded runs'; timed
    kernel_check rows follow for every shape they launched that no row
    holds yet."""
    import dataclasses

    from multioptpy_tpu_torch import mesh_paths as mp
    from multioptpy_tpu_torch.calculators.sqm import SQM2
    from multioptpy_tpu_torch.drivers.neb import neb_scan
    from multioptpy_tpu_torch.io.fixtures import (alkane_chain,
                                                  diels_alder_reactant)
    from multioptpy_tpu_torch.workflows.autots import autots, refine_saddle

    torch.set_num_threads(8)
    t_phase = time.perf_counter()
    totals = dict.fromkeys(jc.VARIANTS, 0)
    seen_shapes = set()
    counted = {}

    def take():
        """The sharded run's launches since the last reset, added to the
        phase's totals; resets (the unsharded counterpart's launches are
        discarded with jc.reset_launches())."""
        v = dict(jc.jacobi_eigh_cuda.variant_launches)
        for k in totals:
            totals[k] += v[k]
        seen_shapes.update(jc.jacobi_eigh_cuda.shape_launches)
        counted.update(kernel_launches=v,
                       k1_launches_by_shape=shape_counts(jc))
        jc.reset_launches()

    def gate(ok, what, out):
        if not ok:
            raise AssertionError(f"mesh {what}: {out}")

    def put(part, run, **extra):
        out = {"phase": "mesh", "part": part, **run, **extra, **counted,
               "phase_elapsed_s": time.perf_counter() - t_phase,
               "card": card}
        emit(out)
        jc.reset_launches()
        return out

    da, z = diels_alder_reactant()
    path0 = full_detail["path0"]
    calc = SQM2(eigh_impl="pallas", device="cuda")

    # (a) the sharded band, 4 shards of 4 images
    bands = (("cineb", "fire", mp.BAND_ITERATIONS, 1e-9),
             ("qsm2", "fire", mp.GATHER_ITERATIONS, 1e-10),
             ("neb", "lbfgs", mp.LBFGS_ITERATIONS, 1e-9))
    for variant, opt, n, tol_x in bands:
        jc.reset_launches()
        run = mp.band_pair(calc, path0, z, mp.band_config(variant, opt, n),
                           "cuda", between=take)
        energies = run.pop("energies")
        extra = {}
        if variant == "cineb":
            extra = mp.band_cpu_check(path0, z, energies)
        out = put(f"a_band_{variant}_{opt}", run, **extra)
        gate(run["shards_stayed_on_their_devices"]
             and run["iteration"] == n and np.isfinite(energies).all(),
             f"(a) {variant} {opt} ran", out)
        gate(run["max_abs_e_diff_vs_unsharded"] <= 1e-10
             and run["max_abs_x_diff_vs_unsharded"] <= tol_x
             and run["fmax_diff_vs_unsharded"] <= (1e-10 if opt == "lbfgs"
                                                   else 1e-12),
             f"(a) {variant} {opt} against the unsharded band", out)
        for key, gap in extra.items():
            if key.endswith("cpu_vs_card"):
                gate(gap <= 1e-8, "(a) card vs CPU", out)

    # (b) the full flagship on 2 shards
    stage_s, clock, detail = {}, [0.0], {}

    def hook(name, **info):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stage_s[name] = now - clock[0]
        clock[0] = now
        detail.update(info)

    jc.reset_launches()
    t0 = clock[0] = time.perf_counter()
    cfg_b = mp.flagship_on_a_mesh_config()
    res = autots(calc, da, z, cfg_b, device="cuda",
                 mesh=mp.mesh_of("cuda", mp.PAIR_SHARDS), stage_hook=hook)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    take()
    # the mesh path's band runs its iterations without redistribution (as
    # the reference's neb_sharded): held to the same band unsharded, and
    # its TS to an unsharded refinement of the same NEB image
    neb_cfg = dataclasses.replace(cfg_b.neb,
                                  redistribute="", redistribute_every=0)
    t1 = time.perf_counter()
    band_one = neb_scan(calc, detail["path0"], z, neb_cfg, device="cuda")
    pick = next(c for c in res.candidates if c["selected"])
    ts_one = refine_saddle(calc, res.neb_path[pick["index"]], z,
                           cfg_b.saddle, device="cuda")
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t1
    jc.reset_launches()
    ends = (res.reactant_coords - res.product_coords).cpu().numpy()
    out = put("b_flagship_on_a_mesh", {
        "config": "tests/test_flagship_autots.py on SQM2 f64, 2 shards, "
                  f"saddle refinement {mp.FLAGSHIP_SADDLE_STEPS} steps",
        "shards": mp.PAIR_SHARDS,
        "images_per_shard": len(res.neb_energies) // mp.PAIR_SHARDS,
        "run_s": run_s, "stage_s": stage_s,
        "stage_seconds": res.stage_seconds,
        "unsharded_stage_seconds": full_res.stage_seconds,
        "ts_energy": res.ts_energy,
        "unsharded_ts_energy": full_res.ts_energy,
        "ts_energy_minus_unsharded_flagship": res.ts_energy
        - full_res.ts_energy,
        "band_max_abs_e_diff_vs_unsharded_band": float(np.abs(
            np.asarray(res.neb_energies)
            - band_one.energies.cpu().numpy()).max()),
        "band_max_abs_x_diff_vs_unsharded_band": float(
            (res.neb_path - band_one.path).abs().max()),
        "ts_energy_minus_unsharded_refinement": res.ts_energy
        - float(ts_one.energy),
        "unsharded_checks_s": check_s,
        "n_imaginary": res.n_imaginary,
        "barrier_forward": res.barrier_forward,
        "barrier_backward": res.barrier_backward,
        "endpoints_rms_bohr": float(np.sqrt(np.mean(ends ** 2))),
        "candidates": [{k: c[k] for k in ("index", "energy", "n_imaginary",
                                          "converged")}
                       for c in res.candidates],
        "unsharded_candidates": [{k: c[k] for k in ("index", "energy",
                                                    "n_imaginary",
                                                    "converged")}
                                 for c in full_res.candidates],
        "neb_energies": np.asarray(res.neb_energies).tolist()})
    gate(res.n_imaginary == 1 and res.barrier_forward > 0
         and res.barrier_backward > 0 and out["endpoints_rms_bohr"] > 0.1,
         "(b) one imaginary mode, two distinct endpoints below the TS", out)
    # the band without redistribution ends at another saddle than the
    # unsharded flagship's, whose band redistributes every 25 iterations
    # (PERF.md; ROADMAP Queue 3, F11): the TS is held to the
    # unsharded run of the same band and refinement, and its gap to the
    # flagship's TS is printed
    gate(out["band_max_abs_e_diff_vs_unsharded_band"] <= 1e-10
         and out["band_max_abs_x_diff_vs_unsharded_band"] <= 1e-9,
         "(b) the sharded band against the same band unsharded", out)
    gate(abs(out["ts_energy_minus_unsharded_refinement"]) <= 1e-6,
         "(b) the TS against the unsharded refinement", out)

    # (a) -aneb 1 5 through aneb_sharded on (b)'s band, whose maxima the
    # insertion densifies (the flagship's initial band falls from its
    # first image to its last: no interior maximum to grow around)
    jc.reset_launches()
    run = mp.aneb_pair(calc, res.neb_path, z, "cuda", between=take)
    energies = run.pop("energies")
    out = put("a_aneb_sharded", run)
    gate(run["same_shape"] and run["images_end"] % mp.SHARDS == 0
         and run["images_end"] > run["images_start"]
         and np.isfinite(energies).all(), "(a) -aneb 1 5 grew the band", out)
    gate(run["max_abs_e_diff_vs_unsharded"] <= 1e-10
         and run["max_abs_x_diff_vs_unsharded"] <= 1e-10,
         "(a) aneb_sharded against one shard", out)

    # (c) the ensembles, 4 shards
    oc, z_oc = alkane_chain(mp.OCTANE_CARBONS)
    jc.reset_launches()
    run = mp.conf_pair(oc, z_oc, "cuda", between=take)
    run.pop("kicked")
    out = put("c_confsearch_n_octane", run)
    gate(run["nonfinite"] == 0
         and run["conformers"] == run["unsharded_conformers"]
         and run["max_abs_e_diff_vs_unsharded"] <= 1e-10
         and run["max_abs_x_diff_vs_unsharded"] <= 1e-8,
         "(c) the conformer round against the unsharded one", out)
    # F12: the step paths' matrix-vector products and slice A's step
    # path do not depend on the batch (ROADMAP Queue 3)
    jc.reset_launches()
    t0 = time.perf_counter()
    probe = {"matvec": mp.batch_probe("cuda"),
             "ring_step": mp.ring_step_probe("cuda", n_steps=3),
             "ops": mp.op_probe("cuda")}
    jc.reset_launches()
    counted.clear()
    out = put("c_f12_probe", {"seconds": time.perf_counter() - t0, **probe})
    gate(all(max(row[f].values()) == 0.0 for row in probe["matvec"]
             for f in ("bmv", "bmv_transposed")),
         "(c) F12: bmv depends on its batch", out)
    gate(all(gaps[0] == 0.0 for row in probe["ring_step"]
             for key, gaps in row.items() if key != "step"),
         "(c) F12: the first 64 rings' step path against the 256's", out)
    gate(not probe["ops"][64]["first_differing"]
         and not probe["ops"][16]["first_differing"],
         "(c) F12: an op of the step depends on its batch", out)
    jc.reset_launches()
    run = mp.rings_pair("cuda", between=take)
    out = put("c_s8_rings", run)
    gate(run["finite"] and run["energy_fell"]
         and run["max_rel_e_diff_vs_blocks_alone"] <= 3e-5,
         "(c) the rings against their blocks run alone", out)
    gate(max(run["max_rel_e_diff_vs_whole_batch_by_step"]) <= 3e-5,
         "(c) the rings against the whole batch", out)

    # (d) GPNEB, the mapper's executor, optimize_batch, 2 shards
    jc.reset_launches()
    run = mp.gpneb_pair("cuda", between=take)
    out = put("d_gpneb", run)
    gate(run["max_abs_e_diff_vs_unsharded"] <= 1e-10
         and run["max_abs_x_diff_vs_unsharded"] <= 1e-9,
         "(d) gpneb against the unsharded run", out)
    jc.reset_launches()
    run = mp.afir_pair(da, z, "cuda", between=take)
    out = put("d_mapper_afir_executor", run)
    gate(run["finite"] and run["max_abs_x_diff_vs_unsharded"] <= 1e-10,
         "(d) the executor against the unsharded one", out)
    jc.reset_launches()
    run = mp.lj_batch_run("cuda", between=take)
    out = put("d_optimize_batch_lj", run)
    gate(run["converged"] == 16 and run["max_rel_e_diff"] <= 1e-10,
         "(d) optimize_batch against the unsharded run", out)

    # (e) the tensor-parallel SQM2 gradient
    jc.reset_launches()
    run = mp.tp_gradient_runs("cuda", between=take)
    card_g = run.pop("gradient")
    run["band_route"] = ("torch.linalg.eigh (eigh64.plan: D = "
                         f"{run['band']} > K1's f64 limit "
                         f"{jc.max_dim(torch.float64)})")
    extra = mp.tp_cpu_check(run["energy"], card_g)
    out = put("e1_tp_c32h66", run, **extra)
    gate(all(r["unsharded_after"] for r in run["runs"])
         and [r["rows_per_shard"] for r in run["runs"]]
         == [[98], [49, 49], [25, 25, 24, 24]]
         and np.isfinite(card_g.numpy()).all(),
         "(e1) ran on the shards asked for", out)
    gate(all(r["abs_e_diff_vs_unsharded"] <= 1e-12
             and r["max_abs_g_diff_vs_unsharded"] <= 1e-12
             for r in run["runs"]),
         "(e1) the sharded gradients against the unsharded one", out)
    gate(extra["abs_e_diff_cpu_vs_card"] <= 1e-9
         and extra["max_abs_g_diff_cpu_vs_card"] <= 1e-8,
         "(e1) the card against the CPU", out)
    gate(run["band"] > jc.max_dim(torch.float64)
         and not any(d == run["band"] for _, d, _, _ in seen_shapes),
         "(e1) the band went to torch.linalg.eigh", out)
    jc.reset_launches()
    run = mp.tp_optimize_pair("cuda", between=take)
    energies = run.pop("energies")
    out = put("e2_tp_optimize_c32h66", run)
    gate(run["steps"] == run["unsharded_steps"] == mp.TP_STEPS
         and np.isfinite(energies).all() and energies[-1] < energies[0],
         "(e2) the steps ran", out)
    gate(run["max_abs_e_diff_vs_unsharded"] <= 1e-10
         and run["max_abs_x_diff_vs_unsharded"] <= 1e-9,
         "(e2) the sharded steps against the unsharded ones", out)
    jc.reset_launches()
    run = mp.tp_octane_pair("cuda", between=take)
    out = put("e3_tp_n_octane", run)
    gate(out["k1_launches_by_shape"].get("1x104x104 f64 sweeps=9", 0) > 0,
         "(e3) K1 launched at 1x104 f64 on the TP path", out)
    gate(run["abs_e_diff_vs_unsharded"] <= 1e-12
         and run["max_abs_g_diff_vs_unsharded"] <= 1e-12,
         "(e3) the sharded gradient against the unsharded one", out)

    # every shape the sharded runs launched that no row holds yet, timed
    phase_s = time.perf_counter() - t_phase
    gen = torch.Generator().manual_seed(11)
    tags = {"f32": torch.float32, "f64": torch.float64}
    held = {(r["batch"], r["d"], "f" + r["dtype"][-2:], r["sweeps"])
            for r in rows if "ms" in r}
    for b, dd, tag, sw in sorted(seen_shapes):
        if (b, dd, tag, sw) not in held:
            rows.append(check_row(jc, gen, b, dd, tags[tag],
                                  f"batch of {b} in mesh", card, sweeps=sw))
    emit({"phase": "mesh_done", "seconds": phase_s,
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
    k3_rows = phase_k3_check(card)
    main_path = [phase_c32h66_start(jc, card), phase_slice_a(jc, card),
                 phase_slice_b(jc, card), phase_autots(jc, card)[0]]
    full_launches, full_res, full_detail = phase_autots(jc, card, full=True)
    from multioptpy_tpu_torch.flagship import saddle_start
    main_path += [full_launches,
                  phase_methods(jc, card, saddle_start(full_res)),
                  phase_reaction_paths(jc, card, full_res, rows),
                  phase_dynamics_and_double_ended(jc, card, full_res),
                  phase_workflows(jc, card, full_res, rows),
                  phase_optmain_surface(jc, card, full_res, rows),
                  phase_cli_surface(jc, card, full_res, rows),
                  phase_mesh(jc, card, full_res, full_detail, rows)]

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
    from multioptpy_tpu_torch.ops.tridiag_cuda import tridiag_eigh_cuda
    kernels.append({
        "name": "tridiag_eigh", "route": "cuda",
        "source": "multioptpy_tpu_torch/csrc/tridiag_eigh.cu",
        "replaces": None,
        "launches": tridiag_eigh_cuda.launches,
        "launches_by_stage": tridiag_eigh_cuda.stage_launches,
        "max_abs_err": max(r["eig_err_vs_plain"] for r in k3_rows),
        **{k: sum(r[k] for r in k3_rows) for k in (
            "ms", "kernel_only_ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": ("operations" if all(r["bound_by"] == "operations"
                                         for r in k3_rows) else "bytes"),
        "shapes": [f"{r['batch']}x{r['d']}x{r['d']} float64" for r in k3_rows],
        "note": "K3 (sytrd, ormtr, steqr): launches are the main path's "
                "kernel launches (c32h66_start on); ms and the other times "
                "one call at each row's shape, summed; plain_ms covers up "
                "to three members a row"})
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
