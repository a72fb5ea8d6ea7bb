"""Command-line entry points of the port: `optmain`, `nebmain`,
`ircmain` and `run_autots`.

Counterpart of `multioptpy_tpu/cli.py` for the flags the ported engines
serve: the input and its charge and multiplicity, the SQM/SQM2, LJ and
Muller-Brown backends, the optimizer (`-opt` with one method, or two for
RMS-force switching), Hessian, convergence and trust flags, AFIR (`-ma`),
the float64 switch, `optmain`'s `-diis`, `-delta`, constraints (`-fix`,
`-pc`, `-gfix`) and guards (`-sc`, `-dc`, `-negeigval`), every flag of
`nebmain` but `-spng` (item 15) and `-cfbenm` (item 13), `ircmain`'s `-im`
and `-is`, and `run_autots`'s `-cfg`, `-prod`, `-nimg` and `-p`.
`--device` picks the card (default `cuda`) or the CPU. Any other flag of
the reference exits with status 2 and names ROADMAP Queue 1 item 18. Atom
selections accept the "1,2,4-7" syntax.
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
                   help="backend: lj (default) | sqm | sqm2 | muller_brown")
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
                   help="a model kind (hessian/model.py): lindh | "
                        "lindh2007 | fischer | schlegel | swart | gfn0 | "
                        "gfnff | morse, with its suffixes")
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
        name = "lj"
    if name not in ("lj", "sqm", "sqm2", "muller_brown"):
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


def _is_number(s):
    try:
        float(s)
        return True
    except ValueError:
        return False


def _make_constraints(args):
    """-fix and -pc -> Constraints (None without them). -pc takes bond i,j
    [ang] | angle i,j,k [deg] | dihedral i,j,k,l [deg] | fbond f1 f2 [ang]
    | x|y|z atoms | atoms_pair i,j | rot | eigvec k."""
    from multioptpy_tpu_torch.constraints import Constraints

    fixed = num_parse(args.fix_atoms) if args.fix_atoms else []
    bonds, angles, dihedrals, fbonds = [], [], [], []
    fixed_coords, atoms_pairs, eigvec_modes = [], [], []
    pc = list(args.projection_constrain)
    i = 0
    while i < len(pc):
        kind = pc[i]
        if kind == "fbond":
            f1, f2 = num_parse(pc[i + 1]), num_parse(pc[i + 2])
            val = None
            if i + 3 < len(pc) and _is_number(pc[i + 3]):
                val = float(pc[i + 3])
                i += 4
            else:
                i += 3
            fbonds.append((f1, f2, val))
            continue
        if kind == "rot":
            # the driver projects translation and rotation out of every
            # step already
            i += 1
            continue
        if kind == "eigvec":
            eigvec_modes.append(int(pc[i + 1]))
            i += 2
            continue
        atoms = num_parse(pc[i + 1])
        val = None
        if i + 2 < len(pc) and _is_number(pc[i + 2]):
            val = float(pc[i + 2])
            i += 3
        else:
            i += 2
        if kind == "bond":
            bonds.append((atoms[0], atoms[1], val))
        elif kind == "angle":
            angles.append((atoms[0], atoms[1], atoms[2], val))
        elif kind == "dihedral":
            dihedrals.append((atoms[0], atoms[1], atoms[2], atoms[3], val))
        elif kind in ("x", "y", "z"):
            fixed_coords.extend((a, kind) for a in atoms)
        elif kind == "atoms_pair":
            atoms_pairs.append((atoms[0], atoms[1]))
        else:
            raise SystemExit(f"error: unknown -pc kind '{kind}' (choose "
                             f"from bond, fbond, angle, dihedral, x, y, z, "
                             f"rot, eigvec, atoms_pair)")
    if not (fixed or bonds or angles or dihedrals or fbonds or fixed_coords
            or atoms_pairs or eigvec_modes):
        return None
    return Constraints(bonds=bonds, angles=angles, dihedrals=dihedrals,
                       fbonds=fbonds, fixed_atoms=fixed,
                       fixed_coords=fixed_coords, atoms_pairs=atoms_pairs,
                       eigvec_modes=eigvec_modes)


def _opt_config(args):
    from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig

    # `-o high_force_engine quasi_newton` asks for RMS-force switching
    method = (args.opt_method[1] if len(args.opt_method) > 1
              else args.opt_method[0])
    switch = args.opt_method[0] if len(args.opt_method) > 1 else None
    kw = dict(method=method, switch_method=switch, nsteps=args.NSTEP,
              saddle_order=args.saddle_order, fc_count=args.fc_count,
              mfc_count=args.mfc_count, trust_radius_ang=args.trust_radius,
              trust_radius_min_ang=args.min_trust_radius,
              diis_variant=getattr(args, "diis_variant", None),
              delta=getattr(args, "delta", 1.0))
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
    p.add_argument("-diis", "--diis_variant", default=None,
                   choices=["gdiis", "gediis", "kdiis", "ediis", "adiis",
                            "c2diis"],
                   help="DIIS extrapolation on the quasi-Newton steps")
    p.add_argument("-delta", "--delta", type=float, default=1.0,
                   help="first-order step scale")
    p.add_argument("-fix", "--fix_atoms", default="",
                   help="frozen atoms, e.g. 1,2,5-8")
    p.add_argument("-pc", "--projection_constrain", nargs="*", default=[],
                   help="bond i,j [value_ang] | angle i,j,k [deg] | "
                        "dihedral i,j,k,l [deg] | fbond f1 f2 [ang] | "
                        "x|y|z atoms | atoms_pair i,j | rot | eigvec k")
    p.add_argument("-gfix", "--gradient_fix_atoms", nargs="*", default=[],
                   help="zero the bond-stretch gradient of atom pairs, "
                        "e.g. 1,2")
    p.add_argument("-sc", "--shape_conditions", nargs="*", default=[],
                   help="abort unless [value gt|lt atoms] conditions hold, "
                        "e.g. 2.0 gt 1,2")
    p.add_argument("-dc", "--dissociate_check", default="10",
                   help="abort when fragments separate beyond this many "
                        "ang")
    p.add_argument("-negeigval", "--detect_negative_eigenvalues",
                   action="store_true",
                   help="stop a saddle search (with -fc) whose Hessian has "
                        "no negative eigenvalue left")
    args = _parse(p, argv)
    symbols, coords, z = _load_system(args)
    calc = _make_calculator(args)
    if args.gradient_fix_atoms:
        from multioptpy_tpu_torch.calculators.base import BondGradProjWrapper
        pairs = []
        for spec in args.gradient_fix_atoms:
            a = num_parse(spec)
            if len(a) != 2:
                raise SystemExit("-gfix expects atom pairs like 1,2")
            pairs.append((a[0], a[1]))
        calc = BondGradProjWrapper(calc, pairs)
    bias = _make_bias(args, z)
    cons = _make_constraints(args)
    if cons is not None and cons.eigvec_modes:
        cons.resolve_eigvecs(calc.hessian(coords[None], z)[0])
    cfg = _opt_config(args)

    from multioptpy_tpu_torch.drivers.optimize import optimize
    from multioptpy_tpu_torch.io.xyz import write_trajectory
    from multioptpy_tpu_torch.units import ANGSTROM2BOHR, BOHR2ANGSTROM

    out = _outdir(args, "_opt")

    def cb(it, st):
        print(f"# iter {it:4d}  E = {float(st.energy[0]):+.10f}  "
              f"max|g| = {float(st.gradient.abs().max()):.3e}  "
              f"trust = {float(st.trust_radius[0]):.4f}")

    res = optimize(calc, coords, z, bias_engine=bias, config=cfg,
                   constraints=cons, record_trajectory=True, callback=cb,
                   dissociation_limit=float(args.dissociate_check)
                   * ANGSTROM2BOHR,
                   shape_conditions=list(args.shape_conditions),
                   detect_negative_eigenvalues=args.detect_negative_eigenvalues,
                   device=args.device)
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


def _write_irc_curvature(out, irc_res, z, step_size):
    """Per-step IRC curvature properties and path bending angles of each
    branch: irc_curvature_properties_{forward,backward}.csv and
    path_bending_angle_{forward,backward}.csv."""
    if irc_res.forward_gradients is None or irc_res.ts_hessian is None:
        return
    from multioptpy_tpu_torch.analysis.pes import (irc_branch_curvature_table,
                                                   path_bending_angles)
    from multioptpy_tpu_torch.geometry import masses_from_z

    masses = masses_from_z(np.asarray(z)).numpy()
    for name, grads, path in (
            ("forward", irc_res.forward_gradients, irc_res.forward_path),
            ("backward", irc_res.backward_gradients, irc_res.backward_path)):
        if grads is None or len(grads) < 2:
            continue
        table = irc_branch_curvature_table(grads, masses,
                                           irc_res.ts_hessian, step_size)
        header = ",".join(["Scalar_Curvature"]
                          + [f"Curvature_Coupling_{i + 1}"
                             for i in range(table.shape[1] - 1)])
        np.savetxt(os.path.join(out, f"irc_curvature_properties_{name}.csv"),
                   table, delimiter=",", header=header, comments="")
        bends = path_bending_angles(np.asarray(path)
                                    * np.sqrt(masses)[None, :, None])
        if len(bends):
            np.savetxt(os.path.join(out, f"path_bending_angle_{name}.csv"),
                       bends, header="bending_angle_deg")


# nebmain's in-loop redistribution flags: (flag, dest, scheme); each takes
# the apply-every-N-iterations interval (0 = off), the last given wins
REDISTRIBUTION_FLAGS = (
    ("-ad", "align_distances", "linear"),
    ("-adene", "align_distances_energy", "energy"),
    ("-adpred", "align_distances_energy_predicted", "pred"),
    ("-adrpred", "align_distances_ritz_energy_predicted", "ritz"),
    ("-ads", "align_distances_spline", "spline"),
    ("-ads2", "align_distances_spline_ver2", "spline2"),
    ("-adg", "align_distances_geodesic", "geodesic"),
    ("-adb", "align_distances_bernstein", "bernstein"),
    ("-adbene", "align_distances_bernstein_energy", "bernstein_energy"),
    ("-adadene", "align_distances_adaptive_energy", "adaptive"))


def _neb_parser():
    p = _base_parser("multioptpy_tpu_torch NEB")
    p.add_argument("-i2", "--end_input", default=None,
                   help="product xyz (else `input` is a trajectory or a "
                        "folder of *_N.xyz images)")
    p.add_argument("-nimg", "--n_images", type=int, default=12)
    p.add_argument("-p", "--partition", type=int, default=0,
                   help="number of interpolation nodes (overrides -nimg "
                        "when > 0)")
    p.add_argument("-nebv", "--neb_variant", default=None,
                   help="force law: neb cineb dneb lup om qsm qsm2 string "
                        "bneb bneb2 bneb3 nesb dmf ewbneb gpneb")
    for flag, variant in (("-om", "om"), ("-lup", "lup"), ("-bneb", "bneb"),
                          ("-bneb2", "bneb2"), ("-bneb3", "bneb3"),
                          ("-dneb", "dneb"), ("-nesb", "nesb"),
                          ("-dmf", "dmf"), ("-ewbneb", "ewbneb"),
                          ("-qsm", "qsm"), ("-qsmv2", "qsm2")):
        p.add_argument(flag, dest="variant_flags", action="append_const",
                       const=variant, default=None,
                       help=f"use the {variant} force law")
    p.add_argument("-sd", "--steepest_descent", type=int, default=None,
                   nargs="?", const=0, help="steepest-descent band clock")
    p.add_argument("-cg", "--conjugate_gradient", nargs="?", const="hs",
                   default=None,
                   help="conjugate-gradient band clock: FR/PR/HS/DY/HZ")
    p.add_argument("-lbfgs", "--memory_limited_BFGS", action="store_true",
                   help="L-BFGS band clock")
    p.add_argument("-gqnt", "--global_quasi_newton", action="store_true",
                   help="the L-BFGS whole-band clock")
    p.add_argument("-sdneb", "-sd2", dest="opt_flags", action="append_const",
                   const="sd", default=None)
    p.add_argument("-cgneb", dest="opt_flags", action="append_const",
                   const="cg_pr")
    p.add_argument("-lbfgsneb", dest="opt_flags", action="append_const",
                   const="lbfgs")
    p.add_argument("-afneb", dest="opt_flags", action="append_const",
                   const="afire", help="per-image adaptive FIRE clocks")
    p.add_argument("-aneb", "--adaptive_neb", nargs="*", default=None,
                   help="adaptive NEB [interp_num frequency]")
    p.add_argument("-pitr", "--per_image_trust", action="store_true",
                   help="per-image trust radii")
    p.add_argument("-k", "--spring_const", type=float, default=0.01)
    p.add_argument("-cineb", "--apply_CI_NEB", type=int, default=None,
                   help="climbing-image start iteration")
    p.add_argument("-ci", "--climbing_image", type=int, nargs="*",
                   default=None, help="spline climbing image [start "
                                      "interval]")
    p.add_argument("-cist", "--ci_start", type=int, default=20)
    p.add_argument("-notsopt", "--not_ts_optimization", action="store_true",
                   help="disable the climbing image")
    p.add_argument("-aconv", "--apply_convergence_criteria",
                   action="store_true",
                   help="stop when max|F| < fmax (else run every NSTEP "
                        "iteration)")
    p.add_argument("-fe", "--fixedges", type=int, default=None,
                   help="0 relax both endpoints, 3 freeze both")
    p.add_argument("-rrs", "--ratio_of_rfo_step", type=float, default=0.5,
                   help="RFO fraction of the interior move (rfo clock)")
    p.add_argument("-spng", "--save_pict", action="store_true",
                   help="energy-profile plot (ROADMAP Queue 1 item 15)")
    p.add_argument("-idpp", "--use_idpp", action="store_true")
    p.add_argument("-cfbenm", "--use_cfb_enm", action="store_true",
                   help="flat-bottom elastic-network preprocessing "
                        "(ROADMAP Queue 1 item 13)")
    for flag, name, scheme in REDISTRIBUTION_FLAGS:
        p.add_argument(flag, "--" + name, type=int, default=0,
                       help=f"in-loop '{scheme}' redistribution interval")
    p.add_argument("-adsg", "--align_distances_savgol", default="0,0,0",
                   help="Savitzky-Golay redistribution: interval,window,"
                        "polyorder")
    p.add_argument("-nd", "--node_distance", type=float, default=None,
                   help="initial-path node spacing in ang, linear")
    p.add_argument("-nds", "--node_distance_spline", type=float,
                   default=None, help="as -nd via spline")
    p.add_argument("-ndb", "--node_distance_bernstein", type=float,
                   default=None, help="as -nd via Bernstein")
    p.add_argument("-ndsg", "--node_distance_savgol", default=None,
                   help="as -nd via Savitzky-Golay: dist,window,order")
    p.add_argument("-nebopt", "--neb_optimizer", default="fire",
                   help="band clock: fire | afire | quickmin | lbfgs | sd | "
                        "rfo | cg_pr | cg_fr | cg_hs | cg_dy | cg_hz")
    p.add_argument("-dmfb", "--dmf_beta", type=float, default=10.0,
                   help="MaxFlux reciprocal temperature (1/Hartree)")
    p.add_argument("-dmfn", "--dmf_nsegs", type=int, default=4,
                   help="MaxFlux action-quadrature subdivision per segment")
    return p


def _neb_initial_path(args, dev):
    """(symbols, path0 (I,N,3) Bohr on `dev`): two endpoints (linear or
    IDPP), a folder of *_N.xyz images, or a trajectory; then the -nd
    family's resampling."""
    import glob

    from multioptpy_tpu_torch.drivers.neb import idpp_path, interpolate_linear
    from multioptpy_tpu_torch.interpolation import (
        bernstein_resample, cubic_spline_resample, linear_resample,
        savitzky_golay_smooth)
    from multioptpy_tpu_torch.io.xyz import read_trajectory, read_xyz
    from multioptpy_tpu_torch.units import ANGSTROM2BOHR, BOHR2ANGSTROM

    dtype = torch.float64 if args.float64 else torch.float32

    def tensor(ang):
        return torch.as_tensor(np.asarray(ang) * ANGSTROM2BOHR, dtype=dtype,
                               device=dev)

    if args.end_input:
        symbols, start_ang = read_xyz(args.input)
        _, end_ang = read_xyz(args.end_input)
        start, end = tensor(start_ang), tensor(end_ang)
        nimg = args.partition if args.partition > 0 else args.n_images
        path0 = (idpp_path(start, end, nimg) if args.use_idpp
                 else interpolate_linear(start, end, nimg))
    elif os.path.isdir(args.input):
        files = sum([sorted(glob.glob(os.path.join(
            args.input, "*_" + "[0-9]" * i + ".xyz"))) for i in range(1, 7)],
            [])
        if len(files) < 3:
            raise SystemExit(f"{args.input}: found {len(files)} *_N.xyz "
                             "images (need >= 3)")
        frames = []
        for f in files:
            symbols, c_ang = read_xyz(f)
            frames.append(c_ang)
        path0 = tensor(np.stack(frames))
    else:
        symbols, frames, _ = read_trajectory(args.input)
        path0 = tensor(frames)

    for dist, scheme in ((args.node_distance, "linear"),
                         (args.node_distance_spline, "spline"),
                         (args.node_distance_bernstein, "bernstein"),
                         (args.node_distance_savgol, "savgol")):
        if dist is None:
            continue
        if scheme == "savgol":
            dist = float(str(dist).split(",")[0])
        p_np = path0.detach().cpu().numpy()
        total_bohr = float(np.sqrt(((p_np[1:] - p_np[:-1]) ** 2).sum(
            axis=(1, 2))).sum())
        n_new = max(3, int(np.ceil(total_bohr * BOHR2ANGSTROM
                                   / float(dist))) + 1)
        if scheme == "linear":
            path0 = linear_resample(path0, n_new)
        elif scheme == "spline":
            path0 = cubic_spline_resample(path0, n_new)
        elif scheme == "bernstein":
            path0 = bernstein_resample(path0, n_new)
        else:
            path0 = linear_resample(savitzky_golay_smooth(path0), n_new)
        break
    return symbols, path0


def _neb_config(args):
    from multioptpy_tpu_torch.drivers.neb import NEBConfig

    variant = args.neb_variant or (args.variant_flags or ["cineb"])[-1]
    optimizer = ((args.opt_flags or [args.neb_optimizer])[-1]
                 if args.neb_optimizer == "fire" else args.neb_optimizer)
    if args.fc_count > 0 or (args.mfc_count > 0
                             and (args.model_hessian
                                  or args.use_model_hessian)):
        optimizer = "rfo"       # a Hessian-based band clock
    elif args.memory_limited_BFGS or args.global_quasi_newton:
        optimizer = "lbfgs"
    elif args.conjugate_gradient is not None:
        optimizer = "cg_" + str(args.conjugate_gradient).lower()
    elif args.steepest_descent is not None:
        optimizer = "sd"
    ci_start = args.ci_start
    if args.apply_CI_NEB is not None:
        ci_start = args.apply_CI_NEB
    if args.not_ts_optimization:
        ci_start = 10 ** 9
    sci_start, sci_interval = 0, 0
    if args.climbing_image:
        sci_start = int(args.climbing_image[0])
        sci_interval = (int(args.climbing_image[1])
                        if len(args.climbing_image) > 1 else 1)
    redist, redist_every = "", 0
    for _, name, scheme in REDISTRIBUTION_FLAGS:
        interval = getattr(args, name, 0)
        if interval and interval > 0:
            redist, redist_every = scheme, interval
    sg = str(args.align_distances_savgol).split(",")
    sg_window, sg_order = 5, 3
    if len(sg) >= 1 and sg[0].strip() and int(sg[0]) > 0:
        redist, redist_every = "savgol", int(sg[0])
        if len(sg) >= 3:
            sg_window, sg_order = int(sg[1]), int(sg[2])
    # without -aconv the band runs every NSTEP iteration
    fmax = NEBConfig().fmax if args.apply_convergence_criteria else 0.0
    return NEBConfig(variant=variant, n_steps=args.NSTEP,
                     k_spring=args.spring_const, climbing_start=ci_start,
                     optimizer=optimizer, fmax=fmax,
                     optimize_endpoints=(args.fixedges == 0),
                     per_image_trust=args.per_image_trust,
                     dmf_beta=args.dmf_beta, dmf_nsegs=args.dmf_nsegs,
                     rfo_ratio=args.ratio_of_rfo_step,
                     redistribute=redist, redistribute_every=redist_every,
                     savgol_window=sg_window, savgol_order=sg_order,
                     spline_ci_start=sci_start,
                     spline_ci_interval=sci_interval)


def neb_job(argv=None):
    """nebmain's flags as a band run: (args, symbols, the initial path
    (I,N,3) Bohr on the flags' device, z, NEBConfig, and the keywords of
    `aneb` under -aneb, else None). Exits 2 on -spng and -cfbenm."""
    from multioptpy_tpu_torch.device import resolve_device
    from multioptpy_tpu_torch.periodic import symbols_to_z

    p = _neb_parser()
    args = _parse(p, argv)
    if args.save_pict:
        p.exit(2, f"{p.prog}: not ported: -spng (the plot writer arrives "
                  "with ROADMAP Queue 1 item 15)\n")
    if args.use_cfb_enm:
        p.exit(2, f"{p.prog}: not ported: -cfbenm (the cfb_enm potential "
                  "arrives with ROADMAP Queue 1 item 13)\n")
    symbols, path0 = _neb_initial_path(args, resolve_device(args.device))
    z = np.asarray(symbols_to_z(symbols))
    aneb_kw = None
    if args.adaptive_neb is not None:
        # -aneb [interpolation_num frequency]: in-run densification
        aneb_kw = {}
        if len(args.adaptive_neb) >= 1 and args.adaptive_neb[0]:
            aneb_kw["interpolation_num"] = int(args.adaptive_neb[0])
        if len(args.adaptive_neb) >= 2:
            aneb_kw["frequency"] = int(args.adaptive_neb[1])
    return args, symbols, path0, z, _neb_config(args), aneb_kw


def run_nebmain(argv=None):
    """NEB path optimization: neb_path.xyz and the per-iteration CSVs
    (path_length, energy_plot, bias_force_rms, orthogonality,
    perp_rms_gradient, perp_max_gradient; one row per iteration, one column
    per image) in `<input>_neb/`."""
    from multioptpy_tpu_torch.device import resolve_device
    from multioptpy_tpu_torch.drivers.neb import aneb, neb, neb_forces
    from multioptpy_tpu_torch.io.xyz import write_trajectory
    from multioptpy_tpu_torch.units import BOHR2ANGSTROM

    args, symbols, path0, z, cfg, aneb_kw = neb_job(argv)
    dev = resolve_device(args.device)
    calc = _make_calculator(args)
    bias = _make_bias(args, z)
    out = _outdir(args, "_neb")
    base_variant = "neb" if cfg.variant == "cineb" else cfg.variant

    def cb(it, path, energies, grads, fmax):
        print(f"# neb iter {it:4d}  max|F| = {float(fmax):.3e}  "
              f"E_max = {float(energies.max()):+.8f}")
        climbing = cfg.variant == "cineb" and it >= cfg.climbing_start
        n_img = path.shape[0]
        forces = neb_forces(path, energies, grads, cfg.k_spring,
                            base_variant, climbing, cfg.optimize_endpoints,
                            cfg.dmf_beta, cfg.dmf_nsegs)
        f2 = forces.reshape(n_img, -1).cpu().numpy()
        g2 = grads.reshape(n_img, -1).cpu().numpy()
        p_np = path.cpu().numpy()
        centered = p_np - p_np.mean(axis=1, keepdims=True)
        seg = np.linalg.norm(np.diff(centered, axis=0).reshape(n_img - 1, -1),
                             axis=1)
        pl = np.concatenate([[0.0], np.cumsum(seg)]) * BOHR2ANGSTROM
        fn, gn = np.linalg.norm(f2, axis=1), np.linalg.norm(g2, axis=1)
        cos = np.where((fn > 1e-10) & (gn > 1e-10),
                       np.sum(f2 * g2, axis=1) / np.maximum(fn * gn, 1e-30),
                       0.0)
        rows = {"path_length.csv": pl,
                "energy_plot.csv": energies.cpu().numpy(),
                "bias_force_rms.csv": np.sqrt(np.mean(g2 ** 2, axis=1)),
                "orthogonality.csv": cos,
                "perp_rms_gradient.csv": np.sqrt(np.mean(f2 ** 2, axis=1)),
                "perp_max_gradient.csv": np.max(np.abs(f2), axis=1)}
        for name, vals in rows.items():
            with open(os.path.join(out, name), "a") as f:
                f.write(",".join(str(float(v)) for v in vals) + "\n")

    if aneb_kw is not None:
        res = aneb(calc, path0, z, cfg, bias_engine=bias, device=dev,
                   **aneb_kw)
    else:
        res = neb(calc, path0, z, cfg, bias_engine=bias, callback=cb,
                  device=dev)
    e_np = res.energies.detach().cpu().numpy()
    write_trajectory(os.path.join(out, "neb_path.xyz"), symbols,
                     res.path.detach().cpu().numpy() * BOHR2ANGSTROM,
                     [f"E = {e:.10f}" for e in e_np])
    if not os.path.exists(os.path.join(out, "energy_plot.csv")):
        # the adaptive band runs without the per-iteration callback
        np.savetxt(os.path.join(out, "energy_plot.csv"), e_np,
                   header="energy_hartree")
    print(f"converged: {bool(res.converged)}; TS guess = image "
          f"{res.ts_index}; E = {float(e_np[res.ts_index]):.8f}")
    return 0


def run_ircmain(argv=None):
    """IRC from a saddle point: irc_forward.xyz, irc_backward.xyz,
    irc_energies.csv and the curvature CSVs in `<input>_irc/`. `-im` picks
    the integrator (lqa, euler, rk4, dvv, hpc), `-is` the mass-weighted
    step; -ns below 1000 sets the steps (else 200)."""
    p = _base_parser("multioptpy_tpu_torch IRC")
    p.add_argument("-im", "--irc_method", default="lqa")
    p.add_argument("-is", "--irc_step", type=float, default=0.05)
    args = _parse(p, argv)
    symbols, coords, z = _load_system(args)
    calc = _make_calculator(args)
    from multioptpy_tpu_torch.drivers.irc import IRCConfig, irc
    from multioptpy_tpu_torch.io.xyz import write_trajectory
    from multioptpy_tpu_torch.units import BOHR2ANGSTROM

    res = irc(calc, coords, z, config=IRCConfig(
        method=args.irc_method, step_size=args.irc_step,
        n_steps=args.NSTEP if args.NSTEP < 1000 else 200),
        device=args.device)
    out = _outdir(args, "_irc")
    write_trajectory(os.path.join(out, "irc_forward.xyz"), symbols,
                     res.forward_path * BOHR2ANGSTROM)
    write_trajectory(os.path.join(out, "irc_backward.xyz"), symbols,
                     res.backward_path * BOHR2ANGSTROM)
    np.savetxt(os.path.join(out, "irc_energies.csv"),
               np.stack([res.forward_energies, res.backward_energies], 1),
               header="forward backward")
    _write_irc_curvature(out, res, z, args.irc_step)
    print(f"IRC done; TS E = {res.ts_energy:.8f} -> {out}/")
    return 0


COMMANDS = {
    "optmain": run_optmain,
    "nebmain": run_nebmain,
    "ircmain": run_ircmain,
    "run_autots": run_autots_cli,
}

# the reference's other commands, with the ROADMAP item that ports them
UNPORTED_COMMANDS = {
    "mdmain": 12, "confsearch": 16, "relaxedscan": 16, "orientsearch": 16,
    "ieipmain": 12, "run_mapper": 16,
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
