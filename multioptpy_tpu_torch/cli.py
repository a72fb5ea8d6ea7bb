"""Command-line entry points of the port: `optmain`, `nebmain`,
`ircmain`, `run_autots` (with the v2 workflow engine), `confsearch`,
`relaxedscan`, `orientsearch`, `run_mapper`, `mdmain` and `ieipmain`,
every command of the reference.

Counterpart of `multioptpy_tpu/cli.py`, flag for flag: every command
accepts the flags of the reference's parser for that command, with the
same option strings, destinations, defaults and actions, and applies
each as the reference does. One shared parser carries the flags common
to every command: the input and its charge and multiplicity, every
backend (LJ, EMT, Tersoff, SQM/SQM2 with `-srb`, Muller-Brown and the
host bridges with their options), the optimizer (`-opt`, `-diis`,
`-delta`, `-d`), Hessian, convergence and trust flags, every bias
potential, constraints, guards and calculator wrappers. Where the
reference parses a shared flag on a command and applies it to nothing
(`-fix -pc -gi -dc -sc -gfix -of -negeigval -mi -mf` outside `optmain`,
`-beta` outside `ieipmain`), so does the port (ROADMAP Queue 3, F10).
The port's only flags of its own are `--device`, which picks the card
(default `cuda`) or the CPU, and `--eigh_impl`, which picks the
eigensolver of the RS-RFO step and of the SQM band. A flag of neither
package exits with status 2 through argparse. Atom selections accept the
"1,2,4-7" syntax.
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
                   help="backend: lj (default) | emt | tersoff | sqm | sqm2 "
                        "| muller_brown | tblite | dxtb | pyscf | psi4 | "
                        "ase | gpaw | pwscf")
    # host-bridge backends and their options (each raises its ImportError
    # where the library is absent)
    p.add_argument("-bs", "--basisset", default="6-31G*")
    p.add_argument("-func", "--functional", default="B3LYP")
    p.add_argument("-xtb", "--xtb", default=None,
                   help="the tblite bridge with this method (GFN2-xTB)")
    p.add_argument("-pyscf", "--usepyscf", action="store_true",
                   help="the PySCF bridge (-func, -bs)")
    p.add_argument("-es", "--excited_state", type=int, default=0,
                   help="TDA excited-state index for the PySCF bridge")
    p.add_argument("-dxtb", "--usedxtb", default=None,
                   help="the dxtb bridge with this method (GFN1-xTB)")
    p.add_argument("-os", "--othersoft", default=None,
                   help="an external code through the ASE bridge: orca, "
                        "gaussian, nwchem, gamessus, mopac, mace_mp, uma")
    p.add_argument("-osp", "--software_path_file",
                   default="./software_path.conf",
                   help="path map for -os backends")
    p.add_argument("-cpcm", "--cpcm_solv_model", default=None,
                   help="CPCM implicit solvent for the tblite bridge")
    p.add_argument("-alpb", "--alpb_solv_model", default=None,
                   help="ALPB implicit solvent for the tblite bridge")
    p.add_argument("-sub_bs", "--sub_basisset", nargs="*", default=[],
                   help="per-element basis overrides, e.g. I LanL2DZ "
                        "(PySCF bridge)")
    p.add_argument("-ecp", "--effective_core_potential", nargs="*",
                   default=[], help="per-element ECPs (PySCF bridge)")
    p.add_argument("-u", "--unrestrict", action="store_true",
                   help="unrestricted SCF (PySCF bridge)")
    p.add_argument("-grid", "--dft_grid", type=int, default=3,
                   help="DFT grid fineness (PySCF bridge)")
    p.add_argument("-core", "--N_THREAD", type=int, default=8,
                   help="host-backend threads (Psi4 bridge)")
    p.add_argument("-mem", "--SET_MEMORY", default="2GB",
                   help="host-backend memory (Psi4 bridge)")
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
    p.add_argument("-diis", "--diis_variant", default=None,
                   choices=["gdiis", "gediis", "kdiis", "ediis", "adiis",
                            "c2diis"],
                   help="DIIS extrapolation on the quasi-Newton steps")
    p.add_argument("-delta", "--delta", type=float, default=1.0,
                   help="first-order step scale")
    p.add_argument("-d", "--DELTA", default=None,
                   help="first-order step scale; 'x' means the method's "
                        "default, and a value applies while -delta is 1.0")
    p.add_argument("-srb", "--srb", action="store_true",
                   help="the GFN0 short-range bond correction of -calc sqm")
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
    # bias potentials: the reference's flag names and argument orders
    p.add_argument("-ma", "--manual_AFIR", nargs="*", default=[],
                   help="gamma(kJ/mol) fragm1 fragm2 (repeatable triplets)")
    p.add_argument("-rp", "--repulsive_potential", nargs="*", default=[],
                   help="well_scale dist_scale fragm1 fragm2 scale|value "
                        "(repeatable quintets; UFF LJ)")
    p.add_argument("-rpv2", "--repulsive_potential_v2", nargs="*",
                   default=[],
                   help="well dist length(ang) const_rep const_attr "
                        "order_rep order_attr center(1,2) target(3-5) "
                        "scale|value (repeatable 10-lets; probe-point LJ)")
    p.add_argument("-rpg", "--repulsive_potential_gaussian", nargs="*",
                   default=[],
                   help="LJ_well(kJ/mol) LJ_dist(ang) gau_well(kJ/mol) "
                        "gau_dist(ang) gau_range(ang) fragm1 fragm2 "
                        "(repeatable 7-lets)")
    p.add_argument("-cp", "--cone_potential", nargs="*", default=[],
                   help="well(kJ/mol) dist(ang) cone_angle(deg) center "
                        "three_atoms(2,3,4) target(5-9) (repeatable 6-lets)")
    p.add_argument("-fp", "--flux_potential", nargs="*", default=[],
                   help="kx,ky,kz px,py,pz x,y,z(ang) fragm "
                        "(repeatable quadruplets)")
    p.add_argument("-kp", "--keep_pot", nargs="*", default=[],
                   help="k r0(ang) atom1,atom2 (repeatable triplets)")
    p.add_argument("-kpv2", "--keep_pot_v2", nargs="*", default=[],
                   help="k r0(ang) fragm1 fragm2 (repeatable quadruplets)")
    p.add_argument("-akp", "--anharmonic_keep_pot", nargs="*", default=[],
                   help="De(a.u.) k(a.u.) r0(ang) atom1,atom2 "
                        "(repeatable quadruplets; Morse)")
    p.add_argument("-ka", "--keep_angle", nargs="*", default=[],
                   help="k angle(deg) a1,a2,a3")
    p.add_argument("-kav2", "--keep_angle_v2", nargs="*", default=[],
                   help="k angle(deg) fragm1 fragm2 fragm3 "
                        "(repeatable quintets)")
    p.add_argument("-up", "--universal_potential", nargs="*", default=[],
                   help="potential(kJ/mol) target_atoms (repeatable pairs)")
    p.add_argument("-kda", "--keep_dihedral_angle", nargs="*", default=[],
                   help="k angle(deg) a1,a2,a3,a4")
    p.add_argument("-kdav2", "--keep_dihedral_angle_v2", nargs="*",
                   default=[],
                   help="k angle(deg) f1 f2 f3 f4 (repeatable 6-lets)")
    p.add_argument("-kdac", "--keep_dihedral_angle_cos", nargs="*",
                   default=[],
                   help="k n angle(deg) f1 f2 f3 f4 (repeatable 7-lets)")
    p.add_argument("-kopa", "--keep_out_of_plain_angle", nargs="*",
                   default=[],
                   help="k angle(deg) a1,a2,a3,a4 (repeatable triplets)")
    p.add_argument("-kopav2", "--keep_out_of_plain_angle_v2", nargs="*",
                   default=[],
                   help="k angle(deg) f1 f2 f3 f4 (repeatable 6-lets)")
    p.add_argument("-vpp", "--void_point_pot", nargs="*", default=[],
                   help="k r0(ang) x,y,z(ang) atoms order "
                        "(repeatable quintets)")
    p.add_argument("-brp", "--bond_range_potential", nargs="*", default=[],
                   help="k_upper k_lower upper(ang) lower(ang) fragm1 "
                        "fragm2 (repeatable 6-lets)")
    p.add_argument("-wp", "--well_pot", nargs="*", default=[],
                   help="wall(kJ/mol) fragm1 fragm2 a,b,c,d(ang) "
                        "(repeatable quadruplets)")
    p.add_argument("-wwp", "--wall_well_pot", nargs="*", default=[],
                   help="wall(kJ/mol) x|y|z a,b,c,d(ang) atoms "
                        "(repeatable quadruplets)")
    p.add_argument("-vpwp", "--void_point_well_pot", nargs="*", default=[],
                   help="wall(kJ/mol) x,y,z(ang) a,b,c,d(ang) atoms "
                        "(repeatable quadruplets)")
    p.add_argument("-awp", "--around_well_pot", nargs="*", default=[],
                   help="wall(kJ/mol) center_fragm a,b,c,d(ang) atoms "
                        "(repeatable quadruplets)")
    p.add_argument("-metad", "--metadynamics", nargs="*", default=[],
                   help="bond height(kJ/mol) width(ang) a1,a2 "
                        "(repeatable quadruplets; gaussian hills)")
    p.add_argument("-lmefp", "--linear_mechano_force_pot", nargs="*",
                   default=[],
                   help="force(pN) atoms1 atoms2 (repeatable triplets)")
    p.add_argument("-lmefpv2", "--linear_mechano_force_pot_v2", nargs="*",
                   default=[],
                   help="force(pN) atom_pair (repeatable pairs)")
    p.add_argument("-aerpv2", "--asym_ellipsoid_v2", nargs="*", default=[],
                   help="same syntax as -aerp (free-parameter variant)")
    p.add_argument("-nrp", "--nano_reactor_potential", nargs="*",
                   default=[],
                   help="inner(ang) outer(ang) t_contract(ps) t_expand(ps) "
                        "k_contract(kcal/mol/A^2) k_expand (one 6-let)")
    p.add_argument("-esp", "--electrostatic_potential", nargs="*",
                   default=[],
                   help="charge_scale fragm1 fragm2 (repeatable triplets; "
                        "UFF effective charges)")
    p.add_argument("-espap", "--electrostatic_potential_atom_pair",
                   nargs="*", default=[],
                   help="charge_scale atoms (repeatable pairs)")
    p.add_argument("-aerp", "--asym_ellipsoid", nargs="*", default=[],
                   help="eps(kJ/mol) sig_xp,xm,yp,ym,zp,zm(ang) dist(ang) "
                        "root,lj offtgt|none (repeatable quintets; GNB "
                        "asymmetric ellipsoidal LJ)")
    p.add_argument("-smp", "--spacer_model_potential", nargs="*", default=[],
                   help="depth(kJ/mol) sigma(ang) cavity_scaling n_particles "
                        "target_atoms (repeatable quintets)")
    p.add_argument("-x64", "--float64", action="store_true", default=True)
    p.add_argument("-out", "--output_dir", default=None)
    p.add_argument("-elec", "--electronic_charge", type=int, default=None)
    p.add_argument("-spin", "--spin_multiplicity", type=int, default=None)
    # optmain's constraints, guards and calculator wrappers; the other
    # commands parse them and apply them to nothing, as the reference's do
    p.add_argument("-fix", "--fix_atoms", default="",
                   help="frozen atoms, e.g. 1,2,5-8")
    p.add_argument("-pc", "--projection_constrain", nargs="*", default=[],
                   help="bond i,j [value_ang] | angle i,j,k [deg] | "
                        "dihedral i,j,k,l [deg] | fbond f1 f2 [ang] | "
                        "x|y|z atoms | atoms_pair i,j | rot | eigvec k")
    p.add_argument("-gi", "--geom_info", nargs="*", default=[],
                   help="track internal coordinates per step: bond i,j | "
                        "angle i,j,k | dihedral i,j,k,l (repeatable pairs)")
    p.add_argument("-dc", "--dissociate_check", default="10",
                   help="abort when fragments separate beyond this many "
                        "ang")
    p.add_argument("-sc", "--shape_conditions", nargs="*", default=[],
                   help="abort unless [value gt|lt atoms] conditions hold, "
                        "e.g. 2.0 gt 1,2")
    p.add_argument("-gfix", "--gradient_fix_atoms", nargs="*", default=[],
                   help="zero the bond-stretch gradient of atom pairs, "
                        "e.g. 1,2")
    p.add_argument("-of", "--opt_fragment", nargs="*", default=[],
                   help="fragment-averaged gradients: one atom list per "
                        "rigid fragment, e.g. 1-10 11-18")
    p.add_argument("-negeigval", "--detect_negative_eigenvalues",
                   action="store_true",
                   help="stop a saddle search (with -fc) whose Hessian has "
                        "no negative eigenvalue left")
    p.add_argument("-mi", "--microiter", type=int, default=0,
                   help="low-layer microiterations per ONIOM step")
    p.add_argument("-beta", "--BETA", type=float, default=1.0,
                   help="ieipmain: scale of the image-pair attraction")
    p.add_argument("-mf", "--model_function", nargs="*", default=[],
                   help="2-state model function: [kind charge2 mult2], "
                        "kind in seam/avoiding/conical/mesx/mesx2/meci")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--eigh_impl", default=None,
                   choices=("xla", "pallas", "kernel"),
                   help="eigensolver of the RS-RFO step and of the SQM "
                        "band (ops/eigh64.plan)")
    return p


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
    """The backend the flags name, on `--device`."""
    from multioptpy_tpu_torch.calculators.base import get_calculator

    charge = args.charge
    mult = args.multiplicity
    if args.electronic_charge is not None:
        charge = args.electronic_charge
    if args.spin_multiplicity is not None:
        mult = args.spin_multiplicity
    kw = {}
    if args.calculator:
        name = args.calculator
        if name == "sqm" and args.srb:
            kw["srb"] = True
    elif args.sqm2:
        name = "sqm2"
    elif args.sqm1:
        name = "sqm"
    elif args.xtb:
        name, kw = "tblite", {"method": args.xtb}
        # solvation=(model, solvent), forwarded to tblite's Calculator.add
        if args.cpcm_solv_model:
            kw["solvation"] = ("cpcm", args.cpcm_solv_model)
        elif args.alpb_solv_model:
            kw["solvation"] = ("alpb", args.alpb_solv_model)
    elif args.usedxtb:
        name, kw = "dxtb", {"method": args.usedxtb}
    elif args.othersoft:
        name, kw = "ase", {"software_type": args.othersoft,
                           "conf_path": args.software_path_file}
    elif args.usepyscf:
        name, kw = "pyscf", {"method": args.functional,
                             "basis": args.basisset,
                             "excited_state": args.excited_state}
        # element -> basis name / ECP pairs
        sb = list(args.sub_basisset)
        if sb:
            kw["sub_basis"] = {sb[i]: sb[i + 1]
                               for i in range(0, len(sb) - 1, 2)}
        ecp = list(args.effective_core_potential)
        if ecp:
            kw["ecp"] = {ecp[i]: ecp[i + 1]
                         for i in range(0, len(ecp) - 1, 2)}
        if args.unrestrict:
            kw["unrestricted"] = True
        kw["grid"] = args.dft_grid
    else:
        name = "lj"
    if name == "psi4":
        if args.SET_MEMORY:
            kw.setdefault("memory", args.SET_MEMORY)
        if args.N_THREAD:
            kw.setdefault("n_threads", args.N_THREAD)
    if args.eigh_impl and name in ("sqm", "sqm2"):
        kw["eigh_impl"] = args.eigh_impl
    return get_calculator(name, charge=charge, multiplicity=mult,
                          device=args.device, **kw)


def _asym_ellipsoid(vals, z):
    """-aerp / -aerpv2 quintets -> one asym_ellipsoid potential."""
    from multioptpy_tpu_torch.potentials import get_potential

    atoms, offtgt, eps_l, sig_l, dist_l = [], [], [], [], []
    for i in range(0, len(vals), 5):
        eps_l.append(float(vals[i]))
        sig_l.append([float(s) for s in vals[i + 1].split(",")])
        dist_l.append(float(vals[i + 2]))
        pair = num_parse(vals[i + 3])
        atoms.append((pair[0], pair[1]))
        off = vals[i + 4]
        offtgt.append(num_parse(off) if off not in ("0", "none") else [])
    return get_potential("asym_ellipsoid", atoms=atoms, offtgt=offtgt,
                         eps=eps_l, sig=sig_l, dist=dist_l,
                         element_z=np.asarray(z))


def _make_bias(args, z):
    """The bias flags -> BiasEngine (None without them)."""
    from multioptpy_tpu_torch.potentials import BiasEngine, get_potential

    pots = []
    ma = args.manual_AFIR
    for i in range(0, len(ma), 3):
        pots.append(get_potential(
            "afir", gamma=float(ma[i]), fragm_1=num_parse(ma[i + 1]),
            fragm_2=num_parse(ma[i + 2]), element_z=np.asarray(z)))
    kp = args.keep_pot
    for i in range(0, len(kp), 3):
        pots.append(get_potential(
            "keep", spring_const=float(kp[i]), distance=float(kp[i + 1]),
            atom_pair=num_parse(kp[i + 2])))
    ka = args.keep_angle
    for i in range(0, len(ka), 3):
        pots.append(get_potential(
            "keep_angle", spring_const=float(ka[i]), angle=float(ka[i + 1]),
            atoms=num_parse(ka[i + 2])))
    kda = args.keep_dihedral_angle
    for i in range(0, len(kda), 3):
        pots.append(get_potential(
            "keep_dihedral", spring_const=float(kda[i]),
            angle=float(kda[i + 1]), atoms=num_parse(kda[i + 2])))

    def chunks(flag, n, vals=None):
        vals = vals if vals is not None else getattr(args, flag, []) or []
        if len(vals) % n:
            raise SystemExit(f"error: -{flag} takes groups of {n} arguments")
        for i in range(0, len(vals), n):
            yield vals[i:i + n]

    zz = np.asarray(z)
    for ws, ds, f1, f2, mode in chunks("repulsive_potential", 5):
        name = ("lj_repulsive_scale" if mode == "scale"
                else "lj_repulsive_value")
        kwargs = (dict(well_scale=float(ws), dist_scale=float(ds))
                  if mode == "scale"
                  else dict(well_value_kjmol=float(ws),
                            dist_value_ang=float(ds)))
        pots.append(get_potential(name, fragm_1=num_parse(f1),
                                  fragm_2=num_parse(f2), element_z=zz,
                                  **kwargs))
    for (w, d, ln, cr, ca, orp, oat, ctr, tgt,
         mode) in chunks("repulsive_potential_v2", 10):
        pots.append(get_potential(
            "lj_repulsive_v2_probe", well=float(w), dist=float(d),
            length_ang=float(ln), const_rep=float(cr), const_attr=float(ca),
            order_rep=float(orp), order_attr=float(oat),
            center=num_parse(ctr), target=num_parse(tgt), element_z=zz,
            mode=mode))
    for (lw, ld, gw, gd, gr, f1,
         f2) in chunks("repulsive_potential_gaussian", 7):
        pots.append(get_potential(
            "lj_repulsive_gaussian", well_depth=float(lw), dist=float(ld),
            gau_well_depth=float(gw), gau_dist=float(gd),
            gau_range=float(gr), fragm_1=num_parse(f1),
            fragm_2=num_parse(f2), element_z=zz))
    for w, d, ang, ctr, three, tgt in chunks("cone_potential", 6):
        pots.append(get_potential(
            "cone", well_value=float(w), dist_value=float(d),
            cone_angle=float(ang), center=num_parse(ctr)[0],
            three_atoms=num_parse(three), target=num_parse(tgt),
            element_z=zz))
    for ks, ps, xyz, frag in chunks("flux_potential", 4):
        pots.append(get_potential(
            "flux", const=[float(v) for v in ks.split(",")],
            order=[float(v) for v in ps.split(",")],
            direction=[float(v) for v in xyz.split(",")],
            atoms=num_parse(frag)))
    for k, r0, f1, f2 in chunks("keep_pot_v2", 4):
        pots.append(get_potential(
            "keep_v2", spring_const=float(k), distance=float(r0),
            fragm_1=num_parse(f1), fragm_2=num_parse(f2)))
    for de, k, r0, pair in chunks("anharmonic_keep_pot", 4):
        pots.append(get_potential(
            "keep_anharmonic", well_depth=float(de), spring_const=float(k),
            distance=float(r0), atom_pair=num_parse(pair)))
    for k, ang, f1, f2, f3 in chunks("keep_angle_v2", 5):
        pots.append(get_potential(
            "keep_angle_v2", spring_const=float(k), angle=float(ang),
            fragm_1=num_parse(f1), fragm_2=num_parse(f2),
            fragm_3=num_parse(f3)))
    for const, atoms in chunks("universal_potential", 2):
        pots.append(get_potential("universal", const=float(const),
                                  atoms=num_parse(atoms)))
    for k, ang, f1, f2, f3, f4 in chunks("keep_dihedral_angle_v2", 6):
        pots.append(get_potential(
            "keep_dihedral_v2", spring_const=float(k), angle=float(ang),
            fragm_1=num_parse(f1), fragm_2=num_parse(f2),
            fragm_3=num_parse(f3), fragm_4=num_parse(f4)))
    for k, n, ang, f1, f2, f3, f4 in chunks("keep_dihedral_angle_cos", 7):
        pots.append(get_potential(
            "keep_dihedral_cos", potential_const=float(k),
            multiplicity=float(n), angle=float(ang), fragm_1=num_parse(f1),
            fragm_2=num_parse(f2), fragm_3=num_parse(f3),
            fragm_4=num_parse(f4)))
    for k, ang, atoms in chunks("keep_out_of_plain_angle", 3):
        # the flag names the center first; the potential takes it second,
        # so reorder (c, n1, n2, n3) -> (n1, c, n2, n3)
        a = num_parse(atoms)
        pots.append(get_potential(
            "keep_out_of_plane", spring_const=float(k), angle=float(ang),
            atoms=[a[1], a[0], a[2], a[3]]))
    for k, ang, f1, f2, f3, f4 in chunks("keep_out_of_plain_angle_v2", 6):
        # same center-first -> center-second reordering as -kopa
        pots.append(get_potential(
            "keep_out_of_plane_v2", spring_const=float(k), angle=float(ang),
            fragm_1=num_parse(f2), fragm_2=num_parse(f1),
            fragm_3=num_parse(f3), fragm_4=num_parse(f4)))
    for k, r0, xyz, atoms, order in chunks("void_point_pot", 5):
        pots.append(get_potential(
            "void_point", spring_const=float(k), distance=float(r0),
            order=float(order), point=[float(v) for v in xyz.split(",")],
            atom=num_parse(atoms)))
    for ku, kl, up, lo, f1, f2 in chunks("bond_range_potential", 6):
        pots.append(get_potential(
            "value_range", upper_const=float(ku), lower_const=float(kl),
            upper_distance=float(up), lower_distance=float(lo),
            fragm_1=num_parse(f1), fragm_2=num_parse(f2)))
    for w, f1, f2, lims in chunks("well_pot", 4):
        pots.append(get_potential(
            "well", wall_energy=float(w),
            limits=[float(v) for v in lims.split(",")],
            fragm_1=num_parse(f1), fragm_2=num_parse(f2)))
    for w, axis, lims, atoms in chunks("wall_well_pot", 4):
        pots.append(get_potential(
            "well_wall", wall_energy=float(w),
            limits=[float(v) for v in lims.split(",")], axis=axis,
            atoms=num_parse(atoms)))
    for w, xyz, lims, atoms in chunks("void_point_well_pot", 4):
        pots.append(get_potential(
            "well_vp", wall_energy=float(w),
            limits=[float(v) for v in lims.split(",")],
            point=[float(v) for v in xyz.split(",")],
            atoms=num_parse(atoms)))
    for w, ctr, lims, atoms in chunks("around_well_pot", 4):
        pots.append(get_potential(
            "well_around", wall_energy=float(w),
            limits=[float(v) for v in lims.split(",")],
            center_fragm=num_parse(ctr), atoms=num_parse(atoms)))
    for kind, h, wd, atoms in chunks("metadynamics", 4):
        if kind != "bond":
            raise SystemExit("error: -metad supports the 'bond' collective "
                             "variable (gaussian hills on a pair distance)")
        pots.append(get_potential(
            "gaussian_metadyn", height_kjmol=float(h), width_ang=float(wd),
            atom_pair=num_parse(atoms)))
    for f, a1, a2 in chunks("linear_mechano_force_pot", 3):
        pots.append(get_potential(
            "mechano_force", force_pn=float(f), atoms_1=num_parse(a1),
            atoms_2=num_parse(a2)))
    for f, pair in chunks("linear_mechano_force_pot_v2", 2):
        pots.append(get_potential(
            "mechano_force_v2", force_pn=float(f), atom_pair=num_parse(pair)))
    for s, f1, f2 in chunks("electrostatic_potential", 3):
        pots.append(get_potential(
            "electrostatic_fragment", charge_scale=float(s),
            fragm_1=num_parse(f1), fragm_2=num_parse(f2), element_z=zz))
    for s, atoms in chunks("electrostatic_potential_atom_pair", 2):
        pots.append(get_potential(
            "electrostatic_atom_pair", charge_scale=float(s),
            atoms=num_parse(atoms), element_z=zz))
    nrp = getattr(args, "nano_reactor_potential", []) or []
    for inner, outer, tc, te, kc, ke in chunks("nano_reactor_potential", 6,
                                               nrp):
        pots.append(get_potential(
            "nanoreactor", inner_wall_ang=float(inner),
            outer_wall_ang=float(outer), contraction_time=float(tc),
            expansion_time=float(te), contraction_k=float(kc),
            expansion_k=float(ke), element_z=zz))
    # asymmetric ellipsoidal LJ probes: eps(kJ/mol) sig_xp,xm,yp,ym,zp,zm
    # (ang) dist(ang) root,lj offtgt
    aerp = getattr(args, "asym_ellipsoid", []) or []
    if aerp and len(aerp) % 5 != 0:
        raise SystemExit("error: -aerp takes quintets: eps sig6 dist "
                         "root,lj offtgt|none")
    smp_check = getattr(args, "spacer_model_potential", []) or []
    if smp_check and len(smp_check) % 5 != 0:
        raise SystemExit("error: -smp takes quintets: depth sigma scaling "
                         "n_particles target_atoms")
    # -aerpv2 (the free-parameter variant) has the same syntax
    for vals in (aerp, getattr(args, "asym_ellipsoid_v2", []) or []):
        if vals:
            pots.append(_asym_ellipsoid(vals, z))
    # spacer implicit-solvent particles: depth(kJ/mol) sigma(ang) cavity_scaling n_particles target_atoms
    smp = getattr(args, "spacer_model_potential", []) or []
    for i in range(0, len(smp), 5):
        pots.append(get_potential(
            "spacer", depth_kjmol=float(smp[i]), sigma_ang=float(smp[i + 1]),
            cavity_scaling=float(smp[i + 2]), n_particles=int(smp[i + 3]),
            target=num_parse(smp[i + 4]), element_z=np.asarray(z)))
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
              diis_variant=args.diis_variant, delta=args.delta)
    # -d/--DELTA: "x" (or absent) keeps the method's default; a value
    # feeds the first-order step scale while -delta stays at 1.0
    if args.DELTA not in (None, "x") and kw["delta"] == 1.0:
        kw["delta"] = float(args.DELTA)
    if args.eigh_impl:
        kw["eigh_impl"] = args.eigh_impl
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

def _optmain_calculator(args, coords):
    """The flags' backend with optmain's wrappers, in the reference's
    order: -of (fragment-averaged gradients), -gfix, -oniom (the backend
    as the high layer; -mi low-layer microiterations), -mf (a two-state
    model function whose second state is the backend at [charge2
    mult2])."""
    import copy

    calc = _make_calculator(args)
    if args.opt_fragment:
        from multioptpy_tpu_torch.calculators.base import FragmentGradWrapper
        calc = FragmentGradWrapper(
            calc, [num_parse(spec) for spec in args.opt_fragment],
            int(coords.shape[0]))
    if args.gradient_fix_atoms:
        from multioptpy_tpu_torch.calculators.base import BondGradProjWrapper
        pairs = []
        for spec in args.gradient_fix_atoms:
            a = num_parse(spec)
            if len(a) != 2:
                raise SystemExit("-gfix expects atom pairs like 1,2")
            pairs.append((a[0], a[1]))
        calc = BondGradProjWrapper(calc, pairs)
    if args.oniom_flag:
        from multioptpy_tpu_torch.calculators.base import get_calculator
        from multioptpy_tpu_torch.calculators.oniom import (MicroiterONIOM,
                                                            ONIOM)
        high_atoms = num_parse(args.oniom_flag[0])
        low = get_calculator(args.oniom_flag[1] if len(args.oniom_flag) > 1
                             else "lj", device=args.device)
        if args.microiter > 0:
            calc = MicroiterONIOM(high_calc=calc, low_calc=low,
                                  high_atoms=high_atoms,
                                  microiter=args.microiter)
        else:
            calc = ONIOM(high_calc=calc, low_calc=low, high_atoms=high_atoms)
    if args.model_function:
        from multioptpy_tpu_torch.calculators.two_state import (
            TwoStateModelFunction)
        spec = list(args.model_function)
        kind = spec[0] if spec else "seam"
        kind = {"avoid": "avoiding"}.get(kind, kind)
        args2 = copy.copy(args)
        if len(spec) > 1:
            args2.charge = int(spec[1])
            args2.electronic_charge = None
        if len(spec) > 2:
            args2.multiplicity = int(spec[2])
            args2.spin_multiplicity = None
        calc = TwoStateModelFunction(calc, _make_calculator(args2),
                                     kind=kind)
    return calc


def _tracked_params(args):
    """-gi pairs: [("bond", [i, j]), ("angle", [i, j, k]), ...]."""
    gi = list(args.geom_info)
    return [(gi[i], num_parse(gi[i + 1])) for i in range(0, len(gi) - 1, 2)]


def _frequency_analysis(args, calc, res, z, out):
    """-freq / -force_freq: the exact Hessian at the final geometry, its
    normal modes and RRHO thermochemistry; frequencies_cm1.csv,
    normal_modes.txt, vibration_animation/ and thermochemistry.txt."""
    from multioptpy_tpu_torch.analysis.vibrations import (
        count_imaginary, normal_modes, rrho_thermochemistry,
        write_mode_animations, write_normal_modes)

    h = calc.hessian(res.coords[None], z)[0]
    nm = normal_modes(h, res.coords, z)
    freqs = nm.frequencies_cm1.cpu().numpy()
    thermo = rrho_thermochemistry(h, res.coords, z,
                                  temperature=args.temperature,
                                  pressure=args.pressure)
    np.savetxt(os.path.join(out, "frequencies_cm1.csv"), freqs,
               header="frequency_cm1")
    write_normal_modes(nm, z, os.path.join(out, "normal_modes.txt"))
    write_mode_animations(nm, res.coords, z,
                          os.path.join(out, "vibration_animation"))
    with open(os.path.join(out, "thermochemistry.txt"), "w") as f:
        for k in ("zpe", "e_thermal", "enthalpy", "entropy", "gibbs"):
            v = getattr(thermo, k)
            f.write(f"{k}: {v}\n")
            print(f"  {k}: {v}")
    print(f"  imaginary modes: {count_imaginary(freqs)}")


def _print_point_group(coords, z):
    """The point group of the final geometry. A degenerate input's error
    is reported and the run goes on; any other error propagates (ROADMAP
    Queue 3, D2: the reference skips on every exception)."""
    from multioptpy_tpu_torch.analysis.symmetry import (SYMMETRY_ERRORS,
                                                        analyze_symmetry)
    try:
        pg = analyze_symmetry(coords.cpu().numpy(), np.asarray(z))
    except SYMMETRY_ERRORS as e:
        print(f"symmetry analysis skipped: {e}")
    else:
        print(f"point group: {pg}")


def _path_analyses(args, res, out):
    """-cmds, -pca: 2-D embeddings of the optimization path; -km: the
    Koopman analysis of the energy history."""
    traj = np.asarray(res.coords_history)
    if args.cmds:
        from multioptpy_tpu_torch.analysis.pes import cmds_path_analysis
        np.savetxt(os.path.join(out, "cmds_path.csv"),
                   cmds_path_analysis(traj).coords_2d, header="cmds_2d")
    if args.pca:
        from multioptpy_tpu_torch.analysis.pes import pca_path_analysis
        np.savetxt(os.path.join(out, "pca_path.csv"),
                   pca_path_analysis(traj).coords_2d, header="pca_2d")
    if args.koopman:
        from multioptpy_tpu_torch.analysis.pes import (
            koopman_convergence_analysis)
        km = koopman_convergence_analysis(np.asarray(res.energy_history))
        with open(os.path.join(out, "koopman.txt"), "w") as f:
            f.write(repr(km) + "\n")


def run_optmain(argv=None):
    """Geometry optimization. In `<input>_opt/`: optimized.xyz,
    trajectory.xyz, energies.csv, input.json (every option), run_log.csv
    (one row per step), geometry_params.csv (-gi), bias_param_grads.csv
    (dE/dparam of every bias potential per step, under bias flags), and
    the analyses asked for (-freq, -cmds, -pca, -km); the point group is
    printed unless -nosymm; -irc chains an IRC (irc_path.xyz,
    irc_energies.csv). Exit status 0 when converged."""
    p = _base_parser("multioptpy_tpu_torch geometry optimization")
    p.add_argument("-oniom", "--oniom_flag", nargs="*", default=[],
                   help="2-layer ONIOM: high_layer_atoms [low_calc "
                        "(default lj)]")
    p.add_argument("-freq", "--frequency_analysis", action="store_true",
                   help="normal modes and RRHO thermochemistry after "
                        "convergence")
    p.add_argument("-force_freq", "--force_frequency_analysis",
                   action="store_true",
                   help="the frequency analysis whether converged or not")
    p.add_argument("-temp", "--temperature", type=float, default=298.15)
    p.add_argument("-press", "--pressure", type=float, default=101325.0)
    p.add_argument("-irc", "--intrinsic_reaction_coordinates", nargs="*",
                   default=None,
                   help="an IRC after the optimization: [step_size "
                        "max_steps method] (default 0.05 200 lqa); a meta-"
                        "IRC where the Hessian has no negative eigenvalue")
    p.add_argument("-cmds", "--cmds", action="store_true",
                   help="CMDS embedding of the optimization path")
    p.add_argument("-pca", "--pca", action="store_true",
                   help="PCA embedding of the optimization path")
    p.add_argument("-km", "--koopman", action="store_true",
                   help="Koopman convergence analysis")
    p.add_argument("-nosymm", "--no_symmetry_analyzer", action="store_true",
                   help="skip the point group of the final geometry")
    p.add_argument("-pbc", "--pbc", nargs="*", default=[],
                   help="periodic cell lengths in ang: [a b c] (parsed, "
                        "applied to nothing, as in the reference: ROADMAP "
                        "Queue 3, F8)")
    args = p.parse_args(argv)
    symbols, coords, z = _load_system(args)
    calc = _optmain_calculator(args, coords)
    bias = _make_bias(args, z)
    cons = _make_constraints(args)
    if cons is not None and cons.eigvec_modes:
        cons.resolve_eigvecs(calc.hessian(coords[None], z)[0])
    cfg = _opt_config(args)

    from multioptpy_tpu_torch.drivers.optimize import optimize
    from multioptpy_tpu_torch.io.xyz import write_trajectory
    from multioptpy_tpu_torch.logging_utils import RunLogger, snapshot_config
    from multioptpy_tpu_torch.units import ANGSTROM2BOHR, BOHR2ANGSTROM

    out = _outdir(args, "_opt")
    logger = RunLogger(out, tracked_params=_tracked_params(args))
    log_cb = logger.make_callback()
    pgrad_rows = []

    def cb(it, st):
        print(f"# iter {it:4d}  E = {float(st.energy[0]):+.10f}  "
              f"max|g| = {float(st.gradient.abs().max()):.3e}  "
              f"trust = {float(st.trust_radius[0]):.4f}")
        log_cb(it, st)
        if bias is not None:
            pg = bias.compute(st.coords).param_grads
            pgrad_rows.append(torch.cat(
                [g.reshape(-1) for g in pg]).cpu().numpy())

    snapshot_config(out, cfg, extra={"input": args.input})
    res = optimize(calc, coords, z, bias_engine=bias, config=cfg,
                   constraints=cons, record_trajectory=True, callback=cb,
                   dissociation_limit=float(args.dissociate_check)
                   * ANGSTROM2BOHR,
                   shape_conditions=list(args.shape_conditions),
                   detect_negative_eigenvalues=args.detect_negative_eigenvalues,
                   device=args.device)
    logger.flush()
    _write(os.path.join(out, "optimized.xyz"), symbols, res.coords,
           f"E = {float(res.energy):.10f}")
    write_trajectory(os.path.join(out, "trajectory.xyz"), symbols,
                     res.coords_history * BOHR2ANGSTROM)
    np.savetxt(os.path.join(out, "energies.csv"), res.energy_history,
               header="energy_hartree")
    if pgrad_rows and pgrad_rows[0].size:
        names = [f"{pot.name}_p{k}" for pot in bias.potentials
                 for k in range(len(np.atleast_1d(pot.init_params())))]
        np.savetxt(os.path.join(out, "bias_param_grads.csv"),
                   np.vstack(pgrad_rows), header=" ".join(names))
    print(f"converged: {bool(res.converged)} after {res.n_iterations} steps; "
          f"E = {float(res.energy):.10f} Ha -> {out}/")

    if ((args.frequency_analysis and bool(res.converged))
            or args.force_frequency_analysis):
        _frequency_analysis(args, calc, res, z, out)
    if not args.no_symmetry_analyzer:
        _print_point_group(res.coords, z)
    _path_analyses(args, res, out)
    if args.intrinsic_reaction_coordinates is not None:
        _chain_irc(args.intrinsic_reaction_coordinates, calc, bias, res,
                   symbols, z, out)
    return 0 if bool(res.converged) else 1


def _chain_irc(spec, calc, bias, res, symbols, z, out):
    """-irc [step max method] after the optimization: the IRC from the
    optimized structure when its exact Hessian has an eigenvalue below
    -1e-6, else the downhill meta-IRC. irc_path.xyz (the backward branch
    reversed, then the forward one), irc_energies.csv and the curvature
    CSVs."""
    from multioptpy_tpu_torch.drivers.irc import IRCConfig, irc, meta_irc
    from multioptpy_tpu_torch.io.xyz import write_trajectory
    from multioptpy_tpu_torch.units import BOHR2ANGSTROM

    spec = list(spec)
    cfg = IRCConfig(step_size=float(spec[0]) if len(spec) > 0 else 0.05,
                    n_steps=int(spec[1]) if len(spec) > 1 else 200,
                    method=spec[2] if len(spec) > 2 else "lqa")
    dev = res.coords.device
    h = calc.hessian(res.coords[None], z)[0]
    if bool((torch.linalg.eigvalsh(h) < -1e-6).any()):
        irc_res = irc(calc, res.coords, z, hessian=h, config=cfg,
                      bias_engine=bias, device=dev)
    else:
        print("no imaginary mode -> meta-IRC (downhill relaxation)")
        irc_res = meta_irc(calc, res.coords, z, config=cfg, bias_engine=bias,
                           device=dev)
    both = np.concatenate([irc_res.backward_path[::-1],
                           irc_res.forward_path])
    write_trajectory(os.path.join(out, "irc_path.xyz"), symbols,
                     both * BOHR2ANGSTROM)
    np.savetxt(os.path.join(out, "irc_energies.csv"),
               np.concatenate([irc_res.backward_energies[::-1],
                               irc_res.forward_energies]),
               header="energy_hartree")
    _write_irc_curvature(out, irc_res, z, cfg.step_size)
    print(f"IRC: {len(both)} points -> {out}/irc_path.xyz")


def run_autots_cli(argv=None, stage_hook=None):
    """AutoTS pipeline: ts.xyz, irc_end_1.xyz and irc_end_2.xyz in
    `<input>_autots/`. `-cfg` takes a JSON file: the reference's v1 legacy
    format (step1_settings..step4_settings; with "skip_to_step4" the input
    is the TS guess and only steps 3 and 4 run), {"autots": {scalar fields
    of AutoTSConfig}}, or a v2 "workflow" (workflows/autots_v2.py: its step
    reports in workflow_report.json, and ts.xyz once a saddle step ran).
    `stage_hook` goes to the v2 engine."""
    p = _base_parser("multioptpy_tpu_torch AutoTS")
    p.add_argument("-cfg", "--config", default=None, help="JSON config")
    p.add_argument("-prod", "--product", default=None, help="product xyz")
    p.add_argument("-nimg", "--n_images", type=int, default=12)
    p.add_argument("-p", "--partition", type=int, default=0,
                   help="number of interpolation nodes (overrides -nimg "
                        "when > 0)")
    args = p.parse_args(argv)
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
            return _run_autots_v2(args, symbols, coords, z, calc, cfg,
                                  stage_hook)
        if any(f"step{i}_settings" in cfg for i in range(1, 5)) or \
                any(k in cfg for k in ("skip_step1", "skip_to_step4",
                                       "run_step4")):
            ts_config, flow = autots_config_from_v1(
                cfg, n_images_default=n_images)
        else:
            kw.update(cfg.get("autots", {}))
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
    if flow.get("skip_to_step4"):
        return _autots_from_ts_guess(args, symbols, coords, z, calc,
                                     ts_config)
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


def _autots_from_ts_guess(args, symbols, coords, z, calc, ts_config):
    """The v1 flow `skip_to_step4`: the input is the TS guess. Its saddle
    refinement, the exact Hessian's imaginary modes, the IRC and the
    optimization of each branch's end; ts.xyz, irc_end_1.xyz (the forward
    end) and irc_end_2.xyz in `<input>_autots/`."""
    from multioptpy_tpu_torch.analysis.vibrations import (count_imaginary,
                                                          normal_modes)
    from multioptpy_tpu_torch.drivers.irc import irc
    from multioptpy_tpu_torch.drivers.optimize import optimize
    from multioptpy_tpu_torch.workflows.autots import refine_saddle

    dev = coords.device
    res3 = refine_saddle(calc, coords, z, ts_config.saddle, device=dev)
    h_ts = calc.hessian(res3.coords[None], z)[0]
    ni = count_imaginary(normal_modes(h_ts, res3.coords, z).frequencies_cm1)
    irc_res = irc(calc, res3.coords, z, hessian=h_ts, config=ts_config.irc,
                  device=dev)
    ends = [optimize(calc, torch.as_tensor(branch[-1], device=dev), z,
                     config=ts_config.endpoint_opt, device=dev).coords
            for branch in (irc_res.forward_path, irc_res.backward_path)]
    out = _outdir(args, "_autots")
    _write(os.path.join(out, "ts.xyz"), symbols, res3.coords,
           f"E = {float(res3.energy):.10f}, n_imag = {ni}")
    _write(os.path.join(out, "irc_end_1.xyz"), symbols, ends[0])
    _write(os.path.join(out, "irc_end_2.xyz"), symbols, ends[1])
    print(f"AutoTS (skip_to_step4): TS E = {float(res3.energy):.8f} "
          f"({ni} imaginary) -> {out}/")
    return 0


def _run_autots_v2(args, symbols, coords, z, calc, cfg, stage_hook=None):
    """The v2 dynamic workflow engine on a config with a "workflow" list."""
    from multioptpy_tpu_torch.io.xyz import read_xyz
    from multioptpy_tpu_torch.units import ANGSTROM2BOHR
    from multioptpy_tpu_torch.workflows.autots_v2 import run_autots_v2

    prod = None
    if args.product:
        _, prod_ang = read_xyz(args.product)
        prod = torch.as_tensor(prod_ang * ANGSTROM2BOHR, dtype=coords.dtype,
                               device=coords.device)
    engine, reports = run_autots_v2(calc, coords, z, cfg,
                                    product_coords=prod, device=args.device,
                                    stage_hook=stage_hook)
    out = _outdir(args, "_autots")
    with open(os.path.join(out, "workflow_report.json"), "w") as f:
        json.dump(reports, f, indent=1, default=str)
    if engine.ctx.get("ts") is not None:
        _write(os.path.join(out, "ts.xyz"), symbols, engine.ctx["ts"])
    print(f"AutoTS v2: {len(reports)} steps -> {out}/")
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
                   help="energy_profile.png of the final band (needs "
                        "matplotlib)")
    p.add_argument("-idpp", "--use_idpp", action="store_true")
    p.add_argument("-cfbenm", "--use_cfb_enm", action="store_true",
                   help="flat-bottom elastic-network preprocessing of the "
                        "initial path")
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


def _cfb_enm_relax(args, path0, z):
    """-cfbenm: 20 FIRE steps of each interior image under a flat-bottom
    elastic network on the first image's bonds."""
    from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig, optimize
    from multioptpy_tpu_torch.potentials import BiasEngine, get_potential

    enm = BiasEngine([get_potential(
        "cfb_enm", reference_coords=path0[0].cpu().numpy(), element_z=z)])
    calc = _make_calculator(args)
    relaxed = [path0[0]]
    for img in path0[1:-1]:
        relaxed.append(optimize(calc, img, z, bias_engine=enm,
                                config=OptimizeConfig(method="fire",
                                                      nsteps=20),
                                device=path0.device).coords)
    relaxed.append(path0[-1])
    return torch.stack(relaxed)


def neb_job(argv=None):
    """nebmain's flags as a band run: (args, symbols, the initial path
    (I,N,3) Bohr on the flags' device, z, NEBConfig, and the keywords of
    `aneb` under -aneb, else None). Under -cfbenm the interior images are
    relaxed first."""
    from multioptpy_tpu_torch.device import resolve_device
    from multioptpy_tpu_torch.periodic import symbols_to_z

    p = _neb_parser()
    args = p.parse_args(argv)
    symbols, path0 = _neb_initial_path(args, resolve_device(args.device))
    z = np.asarray(symbols_to_z(symbols))
    if args.use_cfb_enm:
        path0 = _cfb_enm_relax(args, path0, z)
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
    if args.save_pict:
        # matplotlib is optional: without it this raises its ImportError
        from multioptpy_tpu_torch.analysis.visualization import (
            plot_energy_profile)
        plot_energy_profile(e_np, os.path.join(out, "energy_profile.png"))
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
    args = p.parse_args(argv)
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


def _md_constraints(cc):
    """-cc [value atoms ...] -> SHAKE Constraints (None without them); the
    kind follows the atom count: 2 distance, 3 angle, 4 dihedral."""
    from multioptpy_tpu_torch.constraints import Constraints

    if not cc:
        return None
    bonds, angles, dihedrals = [], [], []
    i = 0
    while i + 1 < len(cc):
        val = float(cc[i])
        atoms = num_parse(cc[i + 1])
        if len(atoms) == 2:
            bonds.append((atoms[0], atoms[1], val))
        elif len(atoms) == 3:
            angles.append((atoms[0], atoms[1], atoms[2], val))
        else:
            dihedrals.append((atoms[0], atoms[1], atoms[2], atoms[3], val))
        i += 2
    return Constraints(bonds=bonds, angles=angles, dihedrals=dihedrals)


def run_mdmain(argv=None):
    """Molecular dynamics: md_traj.xyz and md_energies.csv (potential
    energy and temperature per step) in `<input>_md/`, one pair per
    trajectory under -ntraj (suffix _k); -cmds / -pca add the embedding of
    the first trajectory. -ct runs piecewise-constant temperature chunks
    with the velocities carried across."""
    p = _base_parser("multioptpy_tpu_torch molecular dynamics")
    p.add_argument("-temp", "--temperature", type=float, default=300.0)
    p.add_argument("-dt", "--timestep", type=float, default=0.5,
                   help="time step in fs")
    p.add_argument("-thermo", "-mt", "--thermostat", default="nosehoover",
                   help="none | nosehoover | nosehooverchain | langevin | "
                        "berendsen | velocityverlet")
    p.add_argument("-time", "--md_nstep", type=int, default=None,
                   help="number of MD steps (overrides -ns)")
    p.add_argument("-ts", "--timestep_au", type=float, default=None,
                   help="time step in atomic units (overrides -dt)")
    p.add_argument("-press", "--pressure", type=float, default=101.3,
                   help="pressure in kPa (recorded only: no barostat)")
    p.add_argument("-ntraj", "--n_trajectories", type=int, default=1,
                   help="independent trajectories, run one after another")
    p.add_argument("-ct", "--change_temperature", nargs="*", default=[],
                   help="temperature schedule [step1 T1 step2 T2 ...]")
    p.add_argument("-cc", "--constraint_condition", nargs="*", default=[],
                   help="SHAKE distance/angle/dihedral constraints: "
                        "[value atoms ...]")
    p.add_argument("-pbc", "--pbc", nargs="*", default=[],
                   help="periodic cell lengths in ang")
    p.add_argument("-cmds", "--cmds", action="store_true",
                   help="CMDS embedding of the trajectory")
    p.add_argument("-pca", "--pca", action="store_true",
                   help="PCA embedding of the trajectory")
    args = p.parse_args(argv)
    if args.md_nstep is not None:
        args.NSTEP = args.md_nstep
    if args.timestep_au is not None:
        args.timestep = args.timestep_au * 2.4188843265857e-2  # a.u. -> fs
    if args.thermostat == "velocityverlet":
        args.thermostat = "none"
    symbols, coords, z = _load_system(args)
    calc = _make_calculator(args)
    bias = _make_bias(args, z)
    from multioptpy_tpu_torch.drivers.md import MDConfig, run_md
    from multioptpy_tpu_torch.io.xyz import write_trajectory
    from multioptpy_tpu_torch.units import BOHR2ANGSTROM

    cons = _md_constraints(list(args.constraint_condition))
    # -ct [t1 T1 t2 T2 ...] -> chunks at piecewise-constant temperature
    schedule = [(0, args.temperature)]
    ct = list(args.change_temperature)
    for i in range(0, len(ct) - 1, 2):
        schedule.append((int(float(ct[i])), float(ct[i + 1])))
    schedule.append((args.NSTEP, None))

    out = _outdir(args, "_md")
    all_traj, all_t = [], []
    for itraj in range(max(1, args.n_trajectories)):
        vel = None
        x = coords
        trajs, es, ts_ = [], [], []
        for (t0, temp), (t1, _) in zip(schedule, schedule[1:]):
            n = t1 - t0
            if n <= 0:
                continue
            res = run_md(calc, x, z, MDConfig(
                timestep_fs=args.timestep, n_steps=n, temperature=temp,
                thermostat=args.thermostat, seed=itraj,
                pbc_box_ang=tuple(float(v) for v in (args.pbc or []))),
                bias_engine=bias, velocities=vel, constraints=cons,
                device=args.device)
            x, vel = res.final.coords, res.final.velocities
            trajs.append(res.trajectory)
            es.append(res.energies)
            ts_.append(res.temperatures)
        traj = np.concatenate(trajs)
        suffix = f"_{itraj}" if args.n_trajectories > 1 else ""
        write_trajectory(os.path.join(out, f"md_traj{suffix}.xyz"), symbols,
                         traj * BOHR2ANGSTROM)
        np.savetxt(os.path.join(out, f"md_energies{suffix}.csv"),
                   np.stack([np.concatenate(es), np.concatenate(ts_)], 1),
                   header="potential_hartree temperature_K")
        all_traj.append(traj)
        all_t.append(np.concatenate(ts_))
    from multioptpy_tpu_torch.analysis.pes import (cmds_path_analysis,
                                                   pca_path_analysis)
    for name, embed in (("cmds", cmds_path_analysis),
                        ("pca", pca_path_analysis)):
        if getattr(args, name):
            np.savetxt(os.path.join(out, f"{name}_traj.csv"),
                       embed(all_traj[0]).coords_2d, header=f"{name}_2d")
    print(f"MD finished: {args.NSTEP} steps x {max(1, args.n_trajectories)} "
          f"traj; <T> = {float(np.mean(all_t[0])):.1f} K -> {out}/")
    return 0


def _discover_pair(args):
    """When `input` is no file: a prefix or a directory holding a
    *_A.xyz / *_B.xyz pair (the first two *_[A-Z].xyz matches)."""
    import glob

    if os.path.isfile(args.input):
        return
    matches = sorted(m for pat in (os.path.join(args.input, "*_[A-Z].xyz"),
                                   args.input + "*_[A-Z].xyz")
                     for m in glob.glob(pat))
    if len(matches) >= 2:
        args.input = matches[0]
        if args.end_input is None:
            args.end_input = matches[1]


def run_ieipmain(argv=None):
    """Double-ended and single-ended TS searches: ts_guess.xyz in
    `<input>_ieip/`. `-em` picks the engine (eip, dimer, spring_pair, gnt,
    addf, 2pshs), as do -use_dimer, -use_spm, -gnt, -addf and -2pshs. The
    bias flags are parsed and not applied, as in the reference."""
    import math

    p = _base_parser("multioptpy_tpu_torch iEIP / double-ended methods")
    p.add_argument("-i2", "--end_input", default=None,
                   help="product xyz (required except for -addf)")
    p.add_argument("-em", "--engine", default=None,
                   help="eip | dimer | spring_pair | gnt | addf | 2pshs")
    p.add_argument("-use_dimer", "--use_dimer", action="store_true",
                   help="dimer method for the TS direction")
    p.add_argument("-dimer_sep", "--dimer_separation", type=float,
                   default=1e-4)
    p.add_argument("-dimer_trial_angle", "--dimer_trial_angle", type=float,
                   default=math.pi / 32.0)
    p.add_argument("-dimer_maxiter", "--dimer_max_iterations", type=int,
                   default=1000)
    p.add_argument("-use_spm", "--use_spm", action="store_true",
                   help="spring-pair method")
    p.add_argument("-gnt", "--use_gnt", action="store_true",
                   help="growing Newton trajectory")
    p.add_argument("-gnt_vec", "--gnt_vec", default=None,
                   help="atoms defining the GNT direction, e.g. 1,2,3 "
                        "(default: the reactant->product vector)")
    p.add_argument("-gnt_step", "--gnt_step_len", type=float, default=0.5)
    p.add_argument("-gnt_mi", "--gnt_microiter", type=int, default=25)
    p.add_argument("-addf", "--use_addf", action="store_true",
                   help="anharmonic-downward-distortion following "
                        "(single-ended, -i2 not needed)")
    p.add_argument("-addf_step", "--addf_step_size", type=float, default=0.1)
    p.add_argument("-addf_num", "--addf_step_num", type=int, default=300)
    p.add_argument("-addf_nadd", "--number_of_add", type=int, default=5)
    p.add_argument("-2pshs", "--use_2pshs", action="store_true",
                   help="two-point scaled hypersphere search")
    p.add_argument("-2pshs_step", "--twoPshs_step_size", type=float,
                   default=0.05)
    p.add_argument("-2pshs_num", "--twoPshs_step_num", type=int, default=300)
    args = p.parse_args(argv)
    _discover_pair(args)
    symbols, coords, z = _load_system(args)
    calc = _make_calculator(args)
    from multioptpy_tpu_torch.io.xyz import read_xyz
    from multioptpy_tpu_torch.units import ANGSTROM2BOHR

    engine = args.engine
    if engine is None:
        engine = ("addf" if args.use_addf else "gnt" if args.use_gnt
                  else "2pshs" if args.use_2pshs
                  else "dimer" if args.use_dimer
                  else "spring_pair" if args.use_spm else "eip")
    out = _outdir(args, "_ieip")
    end = None
    if args.end_input:
        _, end_ang = read_xyz(args.end_input)
        end = torch.as_tensor(end_ang * ANGSTROM2BOHR, dtype=coords.dtype,
                              device=coords.device)

    if engine == "addf":
        # multi-channel ADD following with a saddle refinement of each
        # crossing; without a refined saddle, the best raw crossing
        from multioptpy_tpu_torch.drivers.addf import ADDFConfig, addf_explore
        ts_list, channels = addf_explore(calc, coords, z, ADDFConfig(
            n_channels=args.number_of_add, r_step=args.addf_step_size,
            n_spheres=args.addf_step_num), device=args.device)
        if ts_list:
            ts_guess, ts_e = ts_list[0].coords, ts_list[0].energy
        elif not channels:
            raise SystemExit(
                "addf: no ADD channels explored (check -addf_nadd > 0 and "
                "that the system has vibrational modes)")
        else:
            # genuine crossings (lowest first) before channels abandoned
            # at a repulsive wall
            crossed = [c for c in channels if c.crossed_ts]
            best = (min(crossed, key=lambda c: c.ts_energy) if crossed
                    else max(channels, key=lambda c: c.ts_energy))
            ts_guess, ts_e = best.ts_guess, float(best.ts_energy)
    elif engine == "gnt":
        from multioptpy_tpu_torch.drivers.newton_traj import (
            GNTConfig, newton_trajectory)
        direction = None
        if args.gnt_vec:
            direction = torch.zeros_like(coords)
            direction[[a - 1 for a in num_parse(args.gnt_vec)]] = 1.0
        elif end is None:
            raise SystemExit("gnt needs -i2 or -gnt_vec")
        res = newton_trajectory(
            calc, coords, z, direction=direction, product_coords=end,
            config=GNTConfig(step_size=args.gnt_step_len,
                             n_corrector=args.gnt_microiter),
            device=args.device)
        ts_guess, ts_e = res.ts_guess, float(res.ts_energy)
    elif engine == "2pshs":
        from multioptpy_tpu_torch.drivers.twopshs import (TwoPSHSConfig,
                                                          twopshs)
        if end is None:
            raise SystemExit("2pshs needs -i2")
        res = twopshs(calc, coords, end, z, TwoPSHSConfig(
            r_step=args.twoPshs_step_size, n_spheres=args.twoPshs_step_num),
            device=args.device)
        ts_guess, ts_e = res.ts_guess, float(res.ts_energy)
    else:
        from multioptpy_tpu_torch.drivers.ieip import IEIPConfig, ieip
        if end is None:
            raise SystemExit(f"{engine} needs -i2 (a product geometry)")
        ikw = {"engine": engine, "n_steps": args.NSTEP}
        if args.BETA != 1.0:
            ikw["pull_strength"] = IEIPConfig().pull_strength * args.BETA
        if args.dimer_separation not in (None, 1e-4):
            ikw["dimer_separation"] = args.dimer_separation
        if engine == "dimer":
            # -dimer_maxiter caps the loop; -dimer_trial_angle scales the
            # rotation step relative to the default pi/32
            if args.dimer_max_iterations:
                ikw["n_steps"] = int(args.dimer_max_iterations)
            ikw["dimer_rot_step"] = (0.5 * float(args.dimer_trial_angle)
                                     / (math.pi / 32.0))
        res = ieip(calc, coords, end, z, IEIPConfig(**ikw),
                   device=args.device)
        ts_guess, ts_e = res.ts_guess, float(res.ts_energy)

    _write(os.path.join(out, "ts_guess.xyz"), symbols, ts_guess,
           f"E = {ts_e:.10f}")
    print(f"iEIP ({engine}): TS guess E = {ts_e:.8f} -> {out}/")
    return 0


def run_confsearch(argv=None, stage_hook=None):
    """Conformer search: conformers.xyz (energy-sorted) and EQ_energy.csv
    in `<input>_confsearch/`. `stage_hook` goes to `conformer_search`."""
    p = _base_parser("multioptpy_tpu_torch conformer search")
    p.add_argument("-bf", "--base_force", type=float, default=100.0,
                   help="AFIR kick strength [kJ/mol]")
    p.add_argument("-ms", "-nsample", "--max_samples", type=int, default=50,
                   help="max sampling rounds")
    p.add_argument("-bsize", "--batch_size", type=int, default=16)
    p.add_argument("-nl", "--number_of_lowest", type=int, default=5,
                   help="stop after this many rounds without a lowest-"
                        "energy-list update")
    p.add_argument("-nr", "--number_of_rank", type=int, default=10,
                   help="length of the watched lowest-energy list")
    p.add_argument("-tgta", "--target_atoms", nargs="*", default=None,
                   help="restrict AFIR kicks to these atoms, e.g. 1-3,7")
    p.add_argument("-st", "--sampling_temperature", type=float,
                   default=298.15,
                   help="Boltzmann seed-selection temperature [K]")
    p.add_argument("-nost", "--no_stochastic", action="store_true",
                   help="always kick from the initial EQ")
    p.add_argument("-pbc", "--preserve_bond_connectivity",
                   action="store_true",
                   help="reject conformers whose bond connectivity differs "
                        "from the seed")
    p.add_argument("-tabu", "--tabu_search", action="store_true",
                   help="frequency-penalized seed selection")
    p.add_argument("-alpha", "--tabu_alpha", type=float, default=0.5,
                   help="tabu visit-count penalty coefficient")
    args = p.parse_args(argv)
    symbols, coords, z = _load_system(args)
    calc = _make_calculator(args)
    from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig
    from multioptpy_tpu_torch.io.xyz import write_trajectory
    from multioptpy_tpu_torch.units import BOHR2ANGSTROM
    from multioptpy_tpu_torch.workflows.confsearch import (ConfSearchConfig,
                                                           conformer_search)

    tgt = None
    if args.target_atoms:
        tgt = tuple(num_parse(args.target_atoms[0]))
    kw = {}
    if args.eigh_impl:
        kw["opt"] = OptimizeConfig(method="rfo_fsb",
                                   eigh_impl=args.eigh_impl)
    res = conformer_search(calc, coords, z, ConfSearchConfig(
        n_rounds=args.max_samples, batch_size=args.batch_size,
        base_gamma=args.base_force,
        temperature=args.sampling_temperature,
        preserve_bonds=args.preserve_bond_connectivity,
        tabu_weight=args.tabu_alpha if args.tabu_search else 0.0,
        target_atoms=tgt, stochastic=not args.no_stochastic,
        number_of_rank=args.number_of_rank,
        number_of_lowest=args.number_of_lowest, **kw),
        device=args.device, stage_hook=stage_hook)
    out = _outdir(args, "_confsearch")
    write_trajectory(os.path.join(out, "conformers.xyz"), symbols,
                     res.conformers * BOHR2ANGSTROM,
                     [f"E = {e:.10f}" for e in res.energies])
    np.savetxt(os.path.join(out, "EQ_energy.csv"), res.energies,
               header="energy_hartree")
    print(f"{len(res.energies)} unique conformers "
          f"({res.n_generated} candidates) -> {out}/")
    print(f"rejected: {res.n_rejected_bonds} for bond connectivity, "
          f"{res.n_nonfinite} non-finite")
    return 0


def run_relaxedscan(argv=None):
    """Relaxed PES scan: scan.xyz with scan_profile.csv (-sk/-sa/-sr) or
    energy_profile.csv (-scan triples) in `<input>_scan/`."""
    p = _base_parser("multioptpy_tpu_torch relaxed scan")
    p.add_argument("-sk", "--scan_kind", default="bond")
    p.add_argument("-sa", "--scan_atoms", default=None,
                   help="e.g. 1,2 for a bond")
    p.add_argument("-sr", "--scan_range", default=None,
                   help="start,stop,npoints")
    p.add_argument("-scan", "--scan_tgt", nargs="*", default=None,
                   help="repeated [kind atoms start,stop] triples, e.g. "
                        "-scan bond 1,2 1.0,1.8 angle 1,2,3 100,120")
    p.add_argument("-nsample", "--number_of_samples", type=int, default=10,
                   help="scan points")
    p.add_argument("-fo", "--first_only", action="store_true",
                   help="seed every point from the input structure")
    args = p.parse_args(argv)
    symbols, coords, z = _load_system(args)
    calc = _make_calculator(args)
    from multioptpy_tpu_torch.io.xyz import write_trajectory
    from multioptpy_tpu_torch.units import BOHR2ANGSTROM
    from multioptpy_tpu_torch.workflows import relaxed_scan
    from multioptpy_tpu_torch.workflows.relaxed_scan import relaxed_scan_multi

    if args.scan_tgt:
        spec = list(args.scan_tgt)
        if len(spec) % 3:
            raise SystemExit("-scan expects repeated [kind atoms v1,v2] "
                             "triples")
        targets = []
        for i in range(0, len(spec), 3):
            v1, v2 = spec[i + 2].split(",")
            targets.append((spec[i], num_parse(spec[i + 1]),
                            float(v1), float(v2)))
        res = relaxed_scan_multi(calc, coords, z, targets,
                                 args.number_of_samples,
                                 config=_opt_config(args),
                                 first_only=args.first_only,
                                 device=args.device)
        out = _outdir(args, "_scan")
        write_trajectory(os.path.join(out, "scan.xyz"), symbols,
                         res.geometries * BOHR2ANGSTROM,
                         [f"E = {e:.10f}" for e in res.energies])
        header = ",".join(t[0] for t in targets) + ",energy"
        np.savetxt(os.path.join(out, "energy_profile.csv"),
                   np.column_stack([res.values, res.energies]),
                   header=header, delimiter=",")
        print(f"{len(res.energies)} scan points ({len(targets)} targets) "
              f"-> {out}/")
        return 0
    if not (args.scan_atoms and args.scan_range):
        raise SystemExit("give either -scan triples or -sa/-sr")
    start, stop, npts = args.scan_range.split(",")
    res = relaxed_scan(calc, coords, z, args.scan_kind,
                       num_parse(args.scan_atoms), float(start), float(stop),
                       int(npts), config=_opt_config(args),
                       device=args.device)
    out = _outdir(args, "_scan")
    write_trajectory(os.path.join(out, "scan.xyz"), symbols,
                     res.geometries * BOHR2ANGSTROM,
                     [f"{v:.4f} -> E = {e:.10f}"
                      for v, e in zip(res.values, res.energies)])
    np.savetxt(os.path.join(out, "scan_profile.csv"),
               np.stack([res.values, res.energies], 1),
               header="value energy_hartree")
    print(f"scan done ({int(npts)} points) -> {out}/")
    return 0


def run_orientsearch(argv=None):
    """Orientation sampling of a mobile fragment: orientations.xyz
    (energy-sorted) in `<input>_orient/`."""
    p = _base_parser("multioptpy_tpu_torch orientation search")
    p.add_argument("-part", "--fragment", required=True,
                   help="atoms of the mobile fragment, e.g. 5-9")
    p.add_argument("-nsample", "--n_samples", type=int, default=16)
    p.add_argument("-dist", "--distance", type=float, default=None,
                   help="fragment-center separation [Angstrom] before "
                        "orientation sampling")
    args = p.parse_args(argv)
    symbols, coords, z = _load_system(args)
    calc = _make_calculator(args)
    from multioptpy_tpu_torch.io.xyz import write_trajectory
    from multioptpy_tpu_torch.units import BOHR2ANGSTROM
    from multioptpy_tpu_torch.workflows.orientsearch import orientation_search

    res = orientation_search(calc, coords, z, num_parse(args.fragment),
                             n_samples=args.n_samples,
                             config=_opt_config(args),
                             distance_ang=args.distance, device=args.device)
    out = _outdir(args, "_orient")
    write_trajectory(os.path.join(out, "orientations.xyz"), symbols,
                     res.geometries * BOHR2ANGSTROM,
                     [f"E = {e:.10f}" for e in res.energies])
    print(f"{len(res.energies)} orientations -> {out}/")
    return 0


def run_mapper_cli(argv=None, stage_hook=None):
    """Reaction-network mapping: network.json in `<input>_mapper/`. `-cfg`
    takes the reference's format (mapper_settings plus the stepN_settings
    of each task's AutoTS) or {"mapper": {scalar fields of MapperConfig}};
    the command-line flags win. `stage_hook` goes to `map_network`."""
    p = _base_parser("multioptpy_tpu_torch reaction network mapper")
    p.add_argument("-cfg", "--config", default=None)
    p.add_argument("-maxnodes", "--max_nodes", type=int, default=10)
    p.add_argument("--resume", nargs="?", const="", default=None,
                   help="restart from a persisted network JSON (default: "
                        "<out>/network.json)")
    p.add_argument("--temperature", type=float, default=None,
                   help="Boltzmann temperature [K]")
    p.add_argument("--rmsd_threshold", type=float, default=None)
    p.add_argument("--max_iter", type=int, default=None,
                   help="max exploration tasks")
    p.add_argument("--afir_gamma", type=float, default=None,
                   help="AFIR gamma [kJ/mol]")
    p.add_argument("--max_pairs", type=int, default=None)
    p.add_argument("--dist_lower", type=float, default=None)
    p.add_argument("--dist_upper", type=float, default=None)
    p.add_argument("--rng_seed", type=int, default=None)
    p.add_argument("--active_atoms", nargs="*", type=int, default=None,
                   help="restrict AFIR pairs to these 1-indexed atoms")
    p.add_argument("--negative_gamma", action="store_true",
                   help="also push fragments apart (negative gamma)")
    p.add_argument("--exclude_nodes", nargs="*", type=int, default=None,
                   help="EQ node ids never explored further")
    p.add_argument("--exclude_bond_rearrangement", action="store_true",
                   help="auto-exclude EQs whose bond topology differs "
                        "from the seed (EQ0)")
    p.add_argument("--use_rcmc", action="store_true",
                   help="kinetics-driven RCMC priority queue")
    p.add_argument("--rcmc_temperature", type=float, default=None)
    p.add_argument("--rcmc_time", type=float, default=None,
                   help="RCMC reaction time [s]")
    p.add_argument("--rcmc_start_node", type=int, default=None)
    args = p.parse_args(argv)
    symbols, coords, z = _load_system(args)
    calc = _make_calculator(args)
    from multioptpy_tpu_torch.workflows.mapper import (MapperConfig,
                                                       map_network,
                                                       mapper_config_from_v1)

    overrides = dict(
        max_nodes=args.max_nodes,
        temperature_k=(args.rcmc_temperature if args.use_rcmc
                       and args.rcmc_temperature is not None
                       else args.temperature),
        rmsd_threshold_ang=args.rmsd_threshold,
        max_explorations=args.max_iter, afir_gamma=args.afir_gamma,
        max_pairs_per_node=args.max_pairs,
        dist_lower_ang=args.dist_lower, dist_upper_ang=args.dist_upper,
        seed=args.rng_seed,
        active_atoms=tuple(args.active_atoms) if args.active_atoms else None,
        include_negative_gamma=args.negative_gamma or None,
        excluded_node_ids=(tuple(args.exclude_nodes)
                           if args.exclude_nodes else None),
        exclude_bond_rearrangement=args.exclude_bond_rearrangement or None,
        queue="rcmc" if args.use_rcmc else None,
        rcmc_reaction_time_s=args.rcmc_time,
        rcmc_start_node=args.rcmc_start_node)
    cfg_json = {}
    if args.config:
        with open(args.config) as f:
            cfg_json = json.load(f)
    if "mapper_settings" in cfg_json or \
            any(f"step{i}_settings" in cfg_json for i in range(1, 5)):
        mcfg = mapper_config_from_v1(cfg_json, **overrides)
    else:
        kw = dict(cfg_json.get("mapper", {}))
        kw.update({k: v for k, v in overrides.items() if v is not None})
        mcfg = MapperConfig(**kw)
    out = _outdir(args, "_mapper")
    resume = args.resume
    if resume == "":
        resume = os.path.join(out, "network.json")
    res = map_network(calc, coords, z, mcfg, resume=resume,
                      device=args.device, stage_hook=stage_hook)
    res.save(os.path.join(out, "network.json"), symbols)
    print(f"network: {len(res.nodes)} EQ nodes, {len(res.edges)} TS edges "
          f"-> {out}/network.json")
    print(f"skipped tasks: {sum(res.skipped.values())} {res.skipped}")
    return 0


COMMANDS = {
    "optmain": run_optmain,
    "nebmain": run_nebmain,
    "ircmain": run_ircmain,
    "run_autots": run_autots_cli,
    "confsearch": run_confsearch,
    "relaxedscan": run_relaxedscan,
    "orientsearch": run_orientsearch,
    "run_mapper": run_mapper_cli,
    "mdmain": run_mdmain,
    "ieipmain": run_ieipmain,
}


def main(argv=None):
    """`python -m multioptpy_tpu_torch <command> ...` dispatch."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m multioptpy_tpu_torch <command> [args]\n"
              f"commands: {' '.join(COMMANDS)}")
        return 0 if argv else 2
    cmd = argv.pop(0)
    if cmd not in COMMANDS:
        print(f"error: unknown command '{cmd}' "
              f"(choose from {', '.join(COMMANDS)})", file=sys.stderr)
        return 2
    return COMMANDS[cmd](argv)
