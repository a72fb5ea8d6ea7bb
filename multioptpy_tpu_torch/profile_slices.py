#!/usr/bin/env python3
"""Where a step of the PyTorch port's two slices spends its time on a CUDA
card.

Run from the repository root:  python3 -m multioptpy_tpu_torch.profile_slices

For each slice of chip_smoke.py (A: 256 perturbed S8 rings on SQM f32;
B: the Diels-Alder reactant on SQM2 f64; rfo_fsb, eigh_impl="pallas") it
times, warm, with the host clock around work that ends in
torch.cuda.synchronize():
  * energy_gradient -- calc.energy_and_gradient of the batch;
  * exact_hessian   -- calc.hessian (the seminumerical Hessian);
  * projector       -- the TR/rot projector and projected Hessian;
  * rfo_step        -- rs_rfo_step on the projected Hessian;
  * update          -- the FSB Hessian update;
  * step            -- one full optimizer step (make_step_fn);
  * the Jacobi kernel alone at the step's two shapes;
then runs torch.profiler over a few full steps and reports the device
time per step, the kernel launches per step, the device's idle share
(1 - device time / unprofiled step time), the Jacobi kernel's device time
and launches per step, and the top kernels by device time. Prints one
JSON line per slice and the card's name and power limit.
"""

import json
import subprocess
import time

import numpy as np
import torch

from multioptpy_tpu_torch.calculators.sqm import SQM, SQM2
from multioptpy_tpu_torch.device import resolve_device
from multioptpy_tpu_torch.drivers.optimize import (OptimizeConfig, init_state,
                                                   make_step_fn)
from multioptpy_tpu_torch.geometry import (project_gradient_tr_rot,
                                           tr_rot_projector)
from multioptpy_tpu_torch.hessian.updates import update_hessian
from multioptpy_tpu_torch.io.fixtures import diels_alder_reactant
from multioptpy_tpu_torch.ops.jacobi_cuda import jacobi_eigh_cuda
from multioptpy_tpu_torch.steppers.rfo import (_eigh, jacobi_sweeps_for,
                                               rfo_extra_sweeps, rs_rfo_step)


def host_ms(fn, reps):
    """Mean ms per call, host clock, synchronized, after one warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def profile_steps(step, state, n):
    """Device time and launches per step over n steps, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state = step(state)
        torch.cuda.synchronize()
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((dev_us, ev.count, ev.key))
    kernels.sort(reverse=True)
    total_us = sum(k[0] for k in kernels)
    jacobi = [k for k in kernels if "jacobi_" in k[2]]
    return {
        "device_ms_per_step": total_us / n / 1e3,
        "launches_per_step": sum(k[1] for k in kernels) / n,
        "jacobi_ms_per_step": sum(k[0] for k in jacobi) / n / 1e3,
        "jacobi_launches_per_step": sum(k[1] for k in jacobi) / n,
        "top_kernels": [{"name": name[:80], "count_per_step": cnt / n,
                         "ms_per_step": us / n / 1e3,
                         "share": us / total_us if total_us else None}
                        for us, cnt, name in kernels[:8]],
    }


def breakdown(name, calc, x, z, cfg, reps):
    b, n, _ = x.shape
    state = init_state(x, z, calc, config=cfg)
    step = make_step_fn(calc, z, config=cfg)
    for _ in range(2):                 # a quasi-Newton pair in hand
        state = step(state)
    g = project_gradient_tr_rot(state.gradient, state.coords).reshape(b, -1)
    eye = torch.eye(3 * n, dtype=x.dtype, device=x.device)

    def projected():
        p = tr_rot_projector(state.coords)
        h = p.mT @ state.hessian @ p
        return 0.5 * (h + h.mT) + 1e3 * (eye - p)

    h_eff = projected()
    s = (state.coords - state.prev_coords).reshape(b, -1)
    y = (state.raw_gradient - state.prev_raw_gradient).reshape(b, -1)
    band = 4 * n          # s + p orbitals per atom (no row-3 d shells here)
    band_sweeps = jacobi_sweeps_for(band) + 1
    out = {
        "slice": name, "batch": b, "atoms": n, "dtype": str(x.dtype),
        "energy_gradient_ms": host_ms(
            lambda: calc.energy_and_gradient(state.coords, z), reps),
        "exact_hessian_ms": host_ms(lambda: calc.hessian(state.coords, z), 1),
        "projector_ms": host_ms(projected, reps),
        "rfo_step_ms": host_ms(lambda: rs_rfo_step(
            g, h_eff, state.trust_radius, eigh_impl="pallas"), reps),
        "update_ms": host_ms(lambda: update_hessian(state.hessian, s, y,
                                                    "fsb"), reps),
        "step_ms": host_ms(lambda: step(state), reps),
        "kernel_rfo_shape_ms": host_ms(
            lambda: _eigh(h_eff, "pallas", rfo_extra_sweeps(h_eff.dtype)),
            reps),
    }
    a_band = torch.randn(b, band, band, dtype=x.dtype, device=x.device)
    a_band = 0.5 * (a_band + a_band.mT)
    out["kernel_band_shape_ms"] = host_ms(
        lambda: jacobi_eigh_cuda(a_band, band_sweeps), reps)
    prof = profile_steps(step, state, 5)
    out.update(prof)
    out["device_idle_share"] = 1.0 - prof["device_ms_per_step"] / out[
        "step_ms"]
    return out


def main():
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    loose = dict(max_force=3e-3, rms_force=2e-3, max_displacement=1e-2,
                 rms_displacement=7e-3)
    k = np.arange(8)
    ang = 2 * np.pi * k / 8
    ring = np.stack([4.3 * np.cos(ang), 4.3 * np.sin(ang),
                     0.9 * (-1.0) ** k], axis=-1)
    rng = np.random.default_rng(11)
    x_a = torch.as_tensor(ring[None] + 0.12 * rng.standard_normal(
        (256, 8, 3)), dtype=torch.float32, device=dev)
    res_a = breakdown(
        "A: 256xS8 SQM f32", SQM(eigh_impl="pallas", device=dev), x_a,
        np.full(8, 16), OptimizeConfig(method="rfo_fsb", init_hessian="exact",
                                       eigh_impl="pallas", **loose), reps=20)
    print(json.dumps({**res_a, "card": card}), flush=True)
    coords, z = diels_alder_reactant()
    x_b = torch.as_tensor(coords, device=dev)[None]
    res_b = breakdown(
        "B: Diels-Alder SQM2 f64", SQM2(eigh_impl="pallas", device=dev), x_b,
        z, OptimizeConfig(method="rfo_fsb", init_hessian="exact",
                          eigh_impl="pallas"), reps=20)
    print(json.dumps({**res_b, "card": card}), flush=True)
    print(card)


if __name__ == "__main__":
    main()
