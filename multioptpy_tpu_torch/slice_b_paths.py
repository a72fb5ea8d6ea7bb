#!/usr/bin/env python3
"""Slice B's optimization path under several eigensolver routes.

Run as a file from the repository root:

    python3 multioptpy_tpu_torch/slice_b_paths.py [--nsteps N] [--tree DIR] ROUTE ...

ROUTE is IMPL:DEVICE. IMPL is the `eigh_impl` of the stepper and the
calculator: "pallas" (the Jacobi kernel on the card), "kernel" (its
algorithm on any device: the plain version on the CPU) or "xla"
(torch.linalg.eigh). DEVICE is "cuda" or "cpu". Each route runs
chip_smoke.py's slice B configuration, the Diels-Alder reactant on SQM2 in
f64 with rfo_fsb and an exact initial Hessian, for up to N steps (default
60), after a 2-step run on the same device that warms it. It prints one
JSON line per route: the steps taken, whether the run converged, the final
energy and max |gradient|, every energy, the Jacobi kernel's launches and
the wall-clock ms per step. Then the card's name and power limit, when
there is a card.

--tree DIR imports the port from another checkout (for example a
`git archive` of an earlier commit) instead of this file's own.
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time


def run_route(route, nsteps):
    import torch
    from multioptpy_tpu_torch.calculators.sqm import SQM2
    from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig, optimize
    from multioptpy_tpu_torch.io.fixtures import diels_alder_reactant
    from multioptpy_tpu_torch.ops import jacobi_cuda

    impl, device = route.split(":")
    coords, z = diels_alder_reactant()
    calc = SQM2(eigh_impl=impl, device=device)

    def run(n):
        cfg = OptimizeConfig(method="rfo_fsb", init_hessian="exact",
                             eigh_impl=impl, nsteps=n)
        t0 = time.perf_counter()
        res = optimize(calc, coords, z, config=cfg, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    run(2)
    before = jacobi_cuda.jacobi_eigh_cuda.launches
    res, seconds = run(nsteps)
    return {"route": route, "nsteps": nsteps,
            "n_iterations": int(res.n_iterations),
            "converged": bool(res.converged),
            "e_final": float(res.energy_history[-1]),
            "max_grad_final": float(res.gradient.abs().max()),
            "kernel_launches": jacobi_cuda.jacobi_eigh_cuda.launches - before,
            "ms_per_step": seconds / max(int(res.n_iterations), 1) * 1e3,
            "energies": res.energy_history.tolist()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("routes", nargs="+")
    parser.add_argument("--nsteps", type=int, default=60)
    parser.add_argument("--tree", default=str(
        pathlib.Path(__file__).resolve().parent.parent))
    args = parser.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path[0] = str(tree)     # in place of this file's own directory
    for route in args.routes:
        print(json.dumps({"tree": tree.name, **run_route(route, args.nsteps)}),
              flush=True)
    if any(r.endswith(":cuda") for r in args.routes):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True,
                             timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
