"""Command-line entry points of the port: `optmain` and `run_autots`.

Counterpart of `multioptpy_tpu/cli.py` for the flags the ported engines
serve: the input and its charge and multiplicity, the SQM/SQM2 and
Muller-Brown backends, the optimizer, Hessian, convergence and trust flags,
AFIR (`-ma`), the float64 switch, and `run_autots`'s `-cfg`, `-prod`,
`-nimg` and `-p`. `--device` picks the card (default `cuda`) or the CPU.
Any other flag of the reference exits with status 2 and names ROADMAP
Queue 1 item 18. Atom selections accept the "1,2,4-7" syntax.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch


def num_parse(spec):
    """'1,2,4-7' -> [1, 2, 4, 5, 6, 7] (1-based)."""
    out = []
    for tok in str(spec).split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "-" in tok:
            a, b = tok.split("-")
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(tok))
    return out


def _base_parser(description):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("input", help="xyz input file")
    p.add_argument("-c", "--charge", type=int, default=0)
    p.add_argument("-m", "--multiplicity", type=int, default=1)
    p.add_argument("-calc", "--calculator", default=None,
                   help="backend: sqm | sqm2 | muller_brown")
    p.add_argument("-sqm1", "--sqm1", action="store_true",
                   help="the on-device SQM backend")
    p.add_argument("-sqm2", "--sqm2", action="store_true",
                   help="the on-device SQM2 backend")
    p.add_argument("-ns", "--NSTEP", type=int, default=1000)
    p.add_argument("-o", "-opt", "--opt_method", nargs="*",
                   default=["rfo_fsb"])
    p.add_argument("-fc", "--fc_count", type=int, default=-1)
    p.add_argument("-mfc", "--mfc_count", type=int, default=-1)
    p.add_argument("-mh", "--model_hessian", default=None,
                   help="lindh2007d3_raw | lindh2007d3")
    p.add_argument("-order", "--saddle_order", type=int, default=0)
    p.add_argument("-tight", "--tight_convergence_criteria",
                   action="store_true")
    p.add_argument("-loose", "--loose_convergence_criteria",
                   action="store_true")
    p.add_argument("-tcc", dest="tight_convergence_criteria",
                   action="store_true")
    p.add_argument("-lcc", dest="loose_convergence_criteria",
                   action="store_true")
    p.add_argument("-tr", "--trust_radius", type=float, default=None)
    p.add_argument("-mintr", "--min_trust_radius", type=float, default=0.01)
    p.add_argument("-modelhess", "--use_model_hessian", nargs="?",
                   const="fischerd3old", default=None,
                   help="alias of -mh; the bare flag means fischerd3old, "
                        "as in the reference")
    p.add_argument("-ma", "--manual_AFIR", nargs="*", default=[],
                   help="AFIR: repeated [gamma(kJ/mol) fragm1 fragm2]")
    p.add_argument("-x64", "--float64", action="store_true", default=True)
    p.add_argument("-out", "--output_dir", default=None)
    p.add_argument("-elec", "--electronic_charge", type=int, default=None)
    p.add_argument("-spin", "--spin_multiplicity", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def _parse(p, argv):
    """parse_args that names the ROADMAP item for the reference's other
    flags instead of argparse's bare 'unrecognized arguments'."""
    args, extra = p.parse_known_args(argv)
    if extra:
        p.exit(2, f"{p.prog}: not ported: {' '.join(extra)} (the rest of "
                  "the reference's flags arrive with ROADMAP Queue 1 item "
                  "18)\n")
    return args


def _load_system(args):
    from multioptpy_tpu_torch.device import resolve_device
    from multioptpy_tpu_torch.io.xyz import read_xyz
    from multioptpy_tpu_torch.periodic import symbols_to_z
    from multioptpy_tpu_torch.units import ANGSTROM2BOHR

    symbols, coords_ang = read_xyz(args.input)
    z = symbols_to_z(symbols)
    dtype = torch.float64 if args.float64 else torch.float32
    coords = torch.as_tensor(coords_ang * ANGSTROM2BOHR, dtype=dtype,
                             device=resolve_device(args.device))
    return symbols, coords, z


def _make_calculator(args):
    from multioptpy_tpu_torch.calculators.base import get_calculator

    charge = args.charge
    mult = args.multiplicity
    if args.electronic_charge is not None:
        charge = args.electronic_charge
    if args.spin_multiplicity is not None:
        mult = args.spin_multiplicity
    if args.calculator:
        name = args.calculator
    elif args.sqm2:
        name = "sqm2"
    elif args.sqm1:
        name = "sqm"
    else:
        raise NotImplementedError(
            "the reference's default backend (lj) and the host backends "
            "are not ported: pass -calc sqm|sqm2|muller_brown, -sqm1 or "
            "-sqm2 (lj: ROADMAP Queue 1 item 1; the others: item 14)")
    if name not in ("sqm", "sqm2", "muller_brown"):
        raise NotImplementedError(
            f"calculator '{name}' arrives with ROADMAP Queue 1 item 14")
    return get_calculator(name, charge=charge, multiplicity=mult,
                          device=args.device)


def _make_bias(args, z):
    """-ma triples -> BiasEngine (None without them)."""
    from multioptpy_tpu_torch.potentials import BiasEngine, get_potential

    ma = args.manual_AFIR
    pots = [get_potential("afir", gamma=float(ma[i]),
                          fragm_1=num_parse(ma[i + 1]),
                          fragm_2=num_parse(ma[i + 2]),
                          element_z=np.asarray(z))
            for i in range(0, len(ma) - 2, 3)]
    return BiasEngine(pots) if pots else None


def _opt_config(args):
    from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig

    # `-o high_force_engine quasi_newton` asks for RMS-force switching
    method = (args.opt_method[1] if len(args.opt_method) > 1
              else args.opt_method[0])
    switch = args.opt_method[0] if len(args.opt_method) > 1 else None
    kw = dict(method=method, switch_method=switch, nsteps=args.NSTEP,
              saddle_order=args.saddle_order, fc_count=args.fc_count,
              mfc_count=args.mfc_count, trust_radius_ang=args.trust_radius,
              trust_radius_min_ang=args.min_trust_radius)
    mh = args.model_hessian or args.use_model_hessian
    if mh:
        kw["init_hessian"] = f"model:{mh}"
    if args.tight_convergence_criteria:
        kw.update(max_force=1.5e-5, rms_force=1e-5, max_displacement=6e-5,
                  rms_displacement=4e-5)
    elif args.loose_convergence_criteria:
        kw.update(max_force=3e-3, rms_force=2e-3, max_displacement=1e-2,
                  rms_displacement=7e-3)
    return OptimizeConfig(**kw)


def _outdir(args, suffix):
    base = args.output_dir or (os.path.splitext(args.input)[0] + suffix)
    os.makedirs(base, exist_ok=True)
    return base


def _write(path, symbols, coords_bohr, comment=""):
    from multioptpy_tpu_torch.io.xyz import write_xyz
    from multioptpy_tpu_torch.units import BOHR2ANGSTROM

    c = (coords_bohr.detach().cpu().numpy()
         if isinstance(coords_bohr, torch.Tensor) else coords_bohr)
    write_xyz(path, symbols, np.asarray(c) * BOHR2ANGSTROM, comment)


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def run_optmain(argv=None):
    """Geometry optimization: optimized.xyz, trajectory.xyz and
    energies.csv in `<input>_opt/`; exit status 0 when converged."""
    p = _base_parser("multioptpy_tpu_torch geometry optimization")
    args = _parse(p, argv)
    symbols, coords, z = _load_system(args)
    calc = _make_calculator(args)
    bias = _make_bias(args, z)
    cfg = _opt_config(args)

    from multioptpy_tpu_torch.drivers.optimize import optimize
    from multioptpy_tpu_torch.io.xyz import write_trajectory
    from multioptpy_tpu_torch.units import BOHR2ANGSTROM

    out = _outdir(args, "_opt")

    def cb(it, st):
        print(f"# iter {it:4d}  E = {float(st.energy[0]):+.10f}  "
              f"max|g| = {float(st.gradient.abs().max()):.3e}  "
              f"trust = {float(st.trust_radius[0]):.4f}")

    res = optimize(calc, coords, z, bias_engine=bias, config=cfg,
                   record_trajectory=True, callback=cb, device=args.device)
    _write(os.path.join(out, "optimized.xyz"), symbols, res.coords,
           f"E = {float(res.energy):.10f}")
    write_trajectory(os.path.join(out, "trajectory.xyz"), symbols,
                     res.coords_history * BOHR2ANGSTROM)
    np.savetxt(os.path.join(out, "energies.csv"), res.energy_history,
               header="energy_hartree")
    print(f"converged: {bool(res.converged)} after {res.n_iterations} steps; "
          f"E = {float(res.energy):.10f} Ha -> {out}/")
    return 0 if bool(res.converged) else 1


def run_autots_cli(argv=None):
    """AutoTS pipeline: ts.xyz, irc_end_1.xyz and irc_end_2.xyz in
    `<input>_autots/`. `-cfg` takes a JSON file: the reference's v1 legacy
    format (step1_settings..step4_settings) or {"autots": {scalar fields
    of AutoTSConfig}}."""
    p = _base_parser("multioptpy_tpu_torch AutoTS")
    p.add_argument("-cfg", "--config", default=None, help="JSON config")
    p.add_argument("-prod", "--product", default=None, help="product xyz")
    p.add_argument("-nimg", "--n_images", type=int, default=12)
    p.add_argument("-p", "--partition", type=int, default=0,
                   help="number of interpolation nodes (overrides -nimg "
                        "when > 0)")
    args = _parse(p, argv)
    symbols, coords, z = _load_system(args)
    calc = _make_calculator(args)
    from multioptpy_tpu_torch.io.xyz import read_xyz
    from multioptpy_tpu_torch.units import ANGSTROM2BOHR
    from multioptpy_tpu_torch.workflows.autots import (AutoTSConfig,
                                                       autots,
                                                       autots_config_from_v1)

    n_images = args.partition if args.partition > 0 else args.n_images
    kw = {"n_images": n_images}
    ts_config = None
    flow = {}
    if args.config:
        with open(args.config) as f:
            cfg = json.load(f)
        if "workflow" in cfg:
            raise NotImplementedError(
                "the v2 workflow engine arrives with ROADMAP Queue 1 item 16")
        if any(f"step{i}_settings" in cfg for i in range(1, 5)) or \
                any(k in cfg for k in ("skip_step1", "skip_to_step4",
                                       "run_step4")):
            ts_config, flow = autots_config_from_v1(
                cfg, n_images_default=n_images)
        else:
            kw.update(cfg.get("autots", {}))
    if flow.get("skip_to_step4"):
        raise NotImplementedError(
            "the v1 skip_to_step4 flow arrives with ROADMAP Queue 1 item 18")
    if ts_config is None:
        if args.manual_AFIR:
            kw["afir_gamma"] = float(args.manual_AFIR[0])
            kw["afir_fragm_1"] = num_parse(args.manual_AFIR[1])
            kw["afir_fragm_2"] = num_parse(args.manual_AFIR[2])
        ts_config = AutoTSConfig(**kw)
    elif args.manual_AFIR:
        # -ma overrides the config's step-1 AFIR
        ts_config = dataclasses.replace(
            ts_config, afir_gamma=float(args.manual_AFIR[0]),
            afir_fragm_1=num_parse(args.manual_AFIR[1]),
            afir_fragm_2=num_parse(args.manual_AFIR[2]), afir_list=())
    product = None
    if args.product:
        _, prod_ang = read_xyz(args.product)
        product = torch.as_tensor(prod_ang * ANGSTROM2BOHR,
                                  dtype=coords.dtype, device=coords.device)
    res = autots(calc, coords, z, ts_config, product_coords=product,
                 device=args.device)
    out = _outdir(args, "_autots")
    _write(os.path.join(out, "ts.xyz"), symbols, res.ts_coords,
           f"E = {res.ts_energy:.10f}, n_imag = {res.n_imaginary}")
    _write(os.path.join(out, "irc_end_1.xyz"), symbols, res.reactant_coords)
    _write(os.path.join(out, "irc_end_2.xyz"), symbols, res.product_coords)
    print(f"AutoTS: TS E = {res.ts_energy:.8f} ({res.n_imaginary} imaginary)"
          f"; barriers {res.barrier_forward:.6f} / "
          f"{res.barrier_backward:.6f} Ha -> {out}/")
    return 0


COMMANDS = {
    "optmain": run_optmain,
    "run_autots": run_autots_cli,
}

# the reference's other commands, with the ROADMAP item that ports them
UNPORTED_COMMANDS = {
    "nebmain": 18, "mdmain": 12, "ircmain": 18, "confsearch": 16,
    "relaxedscan": 16, "orientsearch": 16, "ieipmain": 12, "run_mapper": 16,
}


def main(argv=None):
    """`python -m multioptpy_tpu_torch <command> ...` dispatch."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m multioptpy_tpu_torch <command> [args]\n"
              f"commands: {' '.join(COMMANDS)}")
        return 0 if argv else 2
    cmd = argv.pop(0)
    if cmd in UNPORTED_COMMANDS:
        print(f"error: '{cmd}' is not ported yet (ROADMAP Queue 1 item "
              f"{UNPORTED_COMMANDS[cmd]})", file=sys.stderr)
        return 2
    if cmd not in COMMANDS:
        print(f"error: unknown command '{cmd}' "
              f"(choose from {', '.join(COMMANDS)})", file=sys.stderr)
        return 2
    return COMMANDS[cmd](argv)
