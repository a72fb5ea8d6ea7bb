"""The flagship AutoTS configurations, and a check of the Jacobi sweep
counts on the eigenproblems the flagship poses.

`flagship_config(full)` is the reduced configuration of
tests/test_tpu_flagship_smoke.py, or with `full` the one of
tests/test_flagship_autots.py (`chip_smoke.py` runs both on the card).

`SADDLE_RUNS` are the transition-state refinements of `chip_smoke.py`'s
`methods` phase: RS-P-RFO and mode-following RS-I-RFO with Bofill updates
and an exact Hessian every 5 steps, from the full flagship's saddle-stage
start (`saddle_start`); `method_runs()` lists them with the phase's other
Diels-Alder runs, and `run_method` runs one.

Run as a script, it drives the reduced flagship on the card (or, with
`--device cpu`, on the CPU) with every Jacobi call answered by
`torch.linalg.eigh`, keeps the matrices those calls receive (every RS-RFO
Hessian, a sample of SQM bands), and prints, per sweep count, the largest
off-diagonal the kernel's algorithm (its plain version) leaves relative
to max|a| (`chip_smoke.py`'s `methods` phase does the same for the
RS-P-RFO Hessians of `SADDLE_RUNS`, through `saddle_sweep_residuals`):

    python3 -m multioptpy_tpu_torch.flagship [--device cpu]
"""

import argparse
import json
import time

import torch

from multioptpy_tpu_torch.device import resolve_device
from multioptpy_tpu_torch.drivers.irc import IRCConfig
from multioptpy_tpu_torch.drivers.neb import NEBConfig
from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig
from multioptpy_tpu_torch.workflows.autots import AutoTSConfig

_AFIR = ((300.0, (1,), (11,)), (300.0, (4,), (12,)))
_MODEL = "model:lindh2007d3_raw"


def flagship_config(full=False, eigh_impl="pallas"):
    """The Diels-Alder AutoTS configuration, `eigh_impl` on every
    optimization stage."""
    if full:
        return AutoTSConfig(
            afir_list=_AFIR,
            afir_opt=OptimizeConfig(method="rfo_fsb", nsteps=300,
                                    init_hessian=_MODEL, fc_count=-1,
                                    mfc_count=30, eigh_impl=eigh_impl),
            n_images=16,
            neb=NEBConfig(variant="cineb", n_steps=250, k_spring=0.01,
                          climbing_start=80, fmax=5e-4, dt0=0.05,
                          dt_max=0.2, redistribute="linear",
                          redistribute_every=25),
            top_n_candidates=2,
            saddle=OptimizeConfig(method="rfo_bofill", saddle_order=1,
                                  nsteps=120, fc_count=5,
                                  init_hessian="exact", eigh_impl=eigh_impl),
            irc=IRCConfig(method="lqa", step_size=0.1, n_steps=70),
            endpoint_opt=OptimizeConfig(method="rfo_fsb", nsteps=150,
                                        init_hessian=_MODEL,
                                        eigh_impl=eigh_impl))
    return AutoTSConfig(
        afir_list=_AFIR,
        afir_opt=OptimizeConfig(method="rfo_fsb", nsteps=150,
                                init_hessian=_MODEL, fc_count=-1,
                                mfc_count=30, eigh_impl=eigh_impl),
        n_images=8,
        neb=NEBConfig(variant="cineb", n_steps=80, k_spring=0.01,
                      climbing_start=30, fmax=5e-4, dt0=0.05, dt_max=0.2),
        top_n_candidates=1,
        saddle=OptimizeConfig(method="rfo_bofill", saddle_order=1, nsteps=80,
                              fc_count=5, init_hessian="exact",
                              eigh_impl=eigh_impl),
        irc=IRCConfig(method="lqa", step_size=0.12, n_steps=30),
        endpoint_opt=OptimizeConfig(method="rfo_fsb", nsteps=80,
                                    init_hessian=_MODEL,
                                    eigh_impl=eigh_impl))


SADDLE_RUNS = {
    name: dict(method=name, saddle_order=1, fc_count=5)
    for name in ("rsprfo_bofill", "mf_rsirfo_bofill")}


def method_runs():
    """(label, OptimizeConfig fields, start) of the Diels-Alder method runs:
    `SADDLE_RUNS` from the saddle start, the other RS-I-RFO routes, two DIIS
    variants, the RMS-force switch and four first-order engines from the
    reactant."""
    runs = [(name, kw, "saddle") for name, kw in SADDLE_RUNS.items()]
    runs += [(m, dict(method=m), "reactant") for m in (
        "rsirfo_block_fsb", "rsirfo_fsb_trim", "mwrsirfo_fsb",
        "dic_rsirfo_fsb", "crsirfo_fsb")]
    runs += [(f"rfo_fsb -diis {v}", dict(method="rfo_fsb", diis_variant=v),
              "reactant") for v in ("gediis", "kdiis")]
    runs += [("-opt fire rfo_fsb", dict(method="rfo_fsb",
                                        switch_method="fire"), "reactant")]
    runs += [(m, dict(method=m), "reactant")
             for m in ("fire", "lbfgs", "cg", "gpmin")]
    return runs


def method_constraints(method):
    """The constraint of a method run: `crsirfo` holds the C2-C3 bond
    (`-pc bond 2,3`); the others run unconstrained."""
    from multioptpy_tpu_torch.constraints import Constraints

    return (Constraints(bonds=[(2, 3, None)])
            if method.startswith("crsirfo") else None)


def run_method(calc, start, z, kw, nsteps, eigh_impl, device):
    """`optimize` of one method run from `start` (N, 3)."""
    from multioptpy_tpu_torch.drivers.optimize import optimize

    return optimize(calc, start, z, config=OptimizeConfig(
        nsteps=nsteps, eigh_impl=eigh_impl, **kw),
        constraints=method_constraints(kw["method"]), device=device)


SWEEP_COUNTS = (8, 9, 10, 11, 12, 13, 14, 16)


def saddle_start(res):
    """The saddle stage's starting geometry of an AutoTS result: the NEB
    image of the selected candidate."""
    idx = next(c["index"] for c in res.candidates if c["selected"])
    return res.neb_path[idx]


def offdiagonal_by_sweeps(mats, sweep_counts=SWEEP_COUNTS):
    """{sweeps: largest off-diagonal / max|a|} the kernel's algorithm (its
    plain version) leaves on the batch `mats`, and the matrix count."""
    from multioptpy_tpu_torch.ops.jacobi_cuda import jacobi_eigh_plain

    a = torch.cat(mats)
    scale = a.abs().amax((-2, -1))
    rows = {"matrices": int(a.shape[0])}
    for sw in sweep_counts:
        _, v = jacobi_eigh_plain(a, sw)
        r = v.mT @ a @ v
        off = (r - torch.diag_embed(torch.diagonal(r, dim1=-2, dim2=-1))
               ).abs().amax((-2, -1)) / scale
        rows[sw] = float(off.max())
    return rows


def saddle_sweep_residuals(start, device=None, nsteps=20):
    """Run `SADDLE_RUNS` from `start` (N, 3) for `nsteps` steps each with
    the RS-P-RFO eigensolves answered by `torch.linalg.eigh` through an
    `eigh_impl` that keeps the matrices; returns {run: offdiagonal_by_
    sweeps(...)} over every Hessian the step diagonalized."""
    from multioptpy_tpu_torch.calculators.sqm import SQM2
    from multioptpy_tpu_torch.drivers.optimize import optimize
    from multioptpy_tpu_torch.io.fixtures import diels_alder_reactant

    dev = resolve_device(device)
    _, z = diels_alder_reactant()
    calc = SQM2(eigh_impl="xla", device=dev)
    out = {}
    for name, kw in SADDLE_RUNS.items():
        kept = []

        def record(h, sweeps):
            del sweeps
            kept.append(h.clone())
            return torch.linalg.eigh(h)

        optimize(calc, start, z, config=OptimizeConfig(
            nsteps=nsteps, eigh_impl=record, **kw), device=dev)
        out[name] = offdiagonal_by_sweeps(kept)
    return out


def sweep_residuals(device=None, sweep_counts=SWEEP_COUNTS):
    """Run the reduced flagship on `device` (None means the CUDA card) with
    every Jacobi call answered by `torch.linalg.eigh` through an
    `eigh_impl` that keeps the matrices, and return {kind: {sweeps: largest
    off-diagonal / max|a|}} for the RS-RFO Hessians ("rfo", D = 54) and
    the SQM bands ("band", D = 72, every 5th call of at most 8 matrices;
    every 27th matrix of every 3rd larger one), with the count of matrices
    of each kind."""
    from multioptpy_tpu_torch.calculators.sqm import SQM2
    from multioptpy_tpu_torch.io.fixtures import diels_alder_reactant
    from multioptpy_tpu_torch.workflows.autots import autots

    dev = resolve_device(device)
    kept = {"rfo": [], "band": []}
    calls = [0]

    def record(h, sweeps):
        del sweeps
        calls[0] += 1
        if h.shape[-1] == 54:
            kept["rfo"].append(h.clone())
        elif h.shape[0] <= 8 and calls[0] % 5 == 0:
            kept["band"].append(h.clone())
        elif h.shape[0] > 8 and calls[0] % 3 == 0:
            kept["band"].append(h[::27].clone())
        return torch.linalg.eigh(h)

    coords, z = diels_alder_reactant()
    autots(SQM2(eigh_impl=record, device=dev), coords, z,
           flagship_config(eigh_impl=record), device=dev)
    return {kind: offdiagonal_by_sweeps(mats, sweep_counts)
            for kind, mats in kept.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python3 -m multioptpy_tpu_torch.flagship",
        description="Jacobi sweep counts on the reduced flagship's "
                    "eigenproblems")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--threads", type=int, default=8,
                    help="torch CPU threads")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.set_num_threads(args.threads)
    t0 = time.perf_counter()
    res = sweep_residuals(dev)
    print(json.dumps({"device": args.device,
                      "max_rel_offdiagonal_by_sweeps": res,
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
