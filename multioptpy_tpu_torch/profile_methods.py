#!/usr/bin/env python3
"""What a step of each optimizer method costs on a CUDA card, and how many
kernels it launches.

Run from the repository root:  python3 -m multioptpy_tpu_torch.profile_methods

For every Diels-Alder run of chip_smoke.py's `methods` phase
(`flagship.method_runs()`, SQM2 f64, eigh_impl="pallas", all from the
reactant here) and for FIRE, L-BFGS and Adam on the 256-ring S8 ensemble
(SQM f32), it takes 2 warm steps, then reports:
  * step_ms -- one step, host clock, synchronized (mean of 3);
  * device_ms_per_step, launches_per_step, jacobi_launches_per_step and
    the top kernels -- torch.profiler over 3 steps;
  * device_idle_share -- 1 - device time / step_ms.
The launches per step are the Python loops of small launches that the
fixed-iteration parts of the reference (bisections, `_simplex_qp`,
`gp_step`, `to_cartesian`, SHAKE) became. Prints one JSON line per run and
the card's name and power limit.
"""

import json
import subprocess

import numpy as np
import torch

from multioptpy_tpu_torch.calculators.sqm import SQM, SQM2
from multioptpy_tpu_torch.coords.internals import auto_internals
from multioptpy_tpu_torch.device import resolve_device
from multioptpy_tpu_torch.drivers.optimize import (OptimizeConfig, init_state,
                                                   make_step_fn)
from multioptpy_tpu_torch.flagship import method_constraints, method_runs
from multioptpy_tpu_torch.io.fixtures import diels_alder_reactant
from multioptpy_tpu_torch.profile_slices import host_ms, profile_steps

_LOOSE = dict(max_force=3e-3, rms_force=2e-3, max_displacement=1e-2,
              rms_displacement=7e-3)


def step_costs(calc, x, z, cfg, reps=3):
    """A warm step's host time and its profile."""
    internals = None
    if cfg.method.lower().startswith("dic"):
        internals = auto_internals(x[0].cpu().numpy(), z)
    cons = method_constraints(cfg.method)
    targets = None
    if cons is not None:
        cons.n_atoms = x.shape[1]
        targets = cons.targets(x)
    state = init_state(x, z, calc, config=cfg, internals=internals)
    step = make_step_fn(calc, z, config=cfg, constraints=cons,
                        constraint_targets=targets, internals=internals)
    for _ in range(2):
        state = step(state)
    out = {"step_ms": host_ms(lambda: step(state), reps)}
    out.update(profile_steps(step, state, reps))
    out["device_idle_share"] = 1.0 - out["device_ms_per_step"] / out[
        "step_ms"]
    return out


def main():
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    coords, z = diels_alder_reactant()
    x = torch.as_tensor(coords, device=dev)[None]
    calc = SQM2(eigh_impl="pallas", device=dev)
    for label, kw, _ in method_runs():
        cfg = OptimizeConfig(eigh_impl="pallas", **kw)
        print(json.dumps({"run": label, "system": "Diels-Alder SQM2 f64",
                          **step_costs(calc, x, z, cfg), "card": card}),
              flush=True)
    k = np.arange(8)
    ang = 2 * np.pi * k / 8
    ring = np.stack([4.3 * np.cos(ang), 4.3 * np.sin(ang),
                     0.9 * (-1.0) ** k], axis=-1)
    rng = np.random.default_rng(11)
    x_a = torch.as_tensor(ring[None] + 0.12 * rng.standard_normal(
        (256, 8, 3)), dtype=torch.float32, device=dev)
    calc_a = SQM(eigh_impl="pallas", device=dev)
    for method in ("fire", "lbfgs", "adam"):
        cfg = OptimizeConfig(method=method, eigh_impl="pallas", **_LOOSE)
        print(json.dumps({"run": method, "system": "256xS8 SQM f32",
                          **step_costs(calc_a, x_a, np.full(8, 16), cfg),
                          "card": card}), flush=True)
    print(card)


if __name__ == "__main__":
    main()
