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
     rfo_fsb, an exact initial Hessian and eigh_impl="pallas", 150 steps
     (the throughput configuration of examples/04_scale_demo.py).
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
Slice A must launch the warp variant and slice B the block variant. Then
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


def phase_kernel_check(jc, card):
    from multioptpy_tpu_torch.device import cuda_ms
    from multioptpy_tpu_torch.steppers.rfo import (jacobi_sweeps_for,
                                                   rfo_extra_sweeps)

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
    rows = []
    for b, d, dtype, where in cases + extra:
        # clustered spectra converge slowly: the near-degenerate batch and
        # the boundary rows (B = 12289 random matrices hold close pairs)
        # get 12 sweeps; every main-path shape the main path's (`_eigh`:
        # one more than its CPU count, an RS-RFO step more in f64)
        sw = (12 if where in ("near-degenerate", "variant boundary")
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
            ok = (err_w <= tol_w * scale and err_r <= tol_r * scale
                  and err_o <= tol_r * d)
        row["ok"] = ok
        if (b, d, dtype, where) in cases:
            row["ms"] = cuda_ms(lambda: jc.jacobi_eigh_cuda(a, sw))
            row["plain_ms"] = cuda_ms(lambda: jc.jacobi_eigh_plain(a, sw),
                                      reps=3)
            row["library_ms"] = cuda_ms(lambda: torch.linalg.eigh(a))
            row["bound_ms"], row["bound_by"] = bound_ms(b, d, sw, dtype)
        emit({"phase": "kernel_check", **row, "card": card})
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version: "
                                 f"{row}")
        rows.append(row)

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

    batch_n, n_steps = 256, 150
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
    return launches


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
                 phase_autots(jc, card), phase_autots(jc, card, full=True)]

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
            "note": "ms, plain_ms, bound_ms, library_ms: one call at each "
                    "main-path shape of this variant, summed"})
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
