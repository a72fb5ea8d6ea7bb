"""MD, every bias potential and the double-ended searches on the flagship's
Diels-Alder system, with their CPU reruns.

`mdmain` and `ieipmain` (through `cli.main`, as a user calls them), the 36
bias potentials in a `BiasEngine`, an optimization under all of them, and
`meta_irc` / `modekill`, each held to a rerun on the CPU through the
kernel's algorithm (`eigh_impl="kernel"`, the Jacobi kernel's plain
version). The `dynamics_and_double_ended` phase of `chip_smoke.py` runs
these on the card; with `device="cpu"` and small depths they rehearse
on the CPU, e.g.

    python3 -c "from multioptpy_tpu_torch import dynamics_paths as d; \\
        from multioptpy_tpu_torch.io.fixtures import diels_alder_reactant \\
        as r; x, z = r(); print(d.potentials_check(x, z, 'cpu'))"
"""

import contextlib
import io
import os
import time

import numpy as np
import torch

from multioptpy_tpu_torch import cli
from multioptpy_tpu_torch.calculators.sqm import SQM2
from multioptpy_tpu_torch.drivers import addf, ieip, md, newton_traj, twopshs
from multioptpy_tpu_torch.drivers.irc import IRCConfig, meta_irc, modekill
from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig, optimize
from multioptpy_tpu_torch.geometry import masses_from_z
from multioptpy_tpu_torch.io.xyz import read_trajectory, write_xyz
from multioptpy_tpu_torch.ops import hosteval
from multioptpy_tpu_torch.periodic import z_to_symbol
from multioptpy_tpu_torch.potentials import BiasEngine, get_potential
from multioptpy_tpu_torch.reaction_paths import CPU_RERUN_BAND
from multioptpy_tpu_torch.units import AMU2AU, BOHR2ANGSTROM, KB_HARTREE

MD_TEMPERATURE = 300.0
MD_DT_FS = 0.5
MD_CMP_STEPS = 5
# the depths of the dynamics phase of chip_smoke.py, cut when the
# workflows phase came so that the script stays inside its time limit on
# the slowest host seen (from: MD runs 50 steps, the Nose-Hoover run 200;
# ieipmain -ns 60, -dimer_maxiter 30, -gnt_mi 8, -2pshs_num 5). The NVE
# run keeps its 50 steps (its drift check spans 25 fs); the card-vs-CPU
# checks compare the first steps or iterations, which the cuts keep
MD_STEPS = 30
MD_MAIN_STEPS = 100
NVE_STEPS = 50
IEIP_STEPS = 30
DIMER_ITERATIONS = 15
GNT_ITERATIONS = 4
PSHS_SPHERES = 3
# the Diels-Alder numbering: 1-4 the diene carbons, 5-10 their hydrogens,
# 11-13 the dienophile carbons, 14 its oxygen, 15-18 its hydrogens
_BIAS_FLAGS = ["-kp", "0.05", "1.47", "2,3", "-ka", "0.02", "120", "1,2,3",
               "-kda", "0.01", "0", "1,2,3,4", "-wp", "5", "1-10", "11-18",
               "1.0,2.0,4.5,6.0", "-brp", "2", "2", "4.0", "2.5", "1,4",
               "11,12", "-metad", "bond", "2", "0.2", "1,11"]


def md_runs(n_steps=MD_STEPS, main_steps=MD_MAIN_STEPS, nve_steps=NVE_STEPS):
    """(label, mdmain flags, thermostat held to the CPU or None)."""
    thermo = lambda t, n=n_steps: ["-thermo", t, "-time", str(n)]  # noqa
    return [
        (f"nosehoover -time {main_steps}", thermo("nosehoover", main_steps),
         "nosehoover"),
        ("none", thermo("none", nve_steps), "none"),
        ("nosehooverchain", thermo("nosehooverchain"), "nosehooverchain"),
        ("berendsen", thermo("berendsen"), "berendsen"),
        ("langevin", thermo("langevin"), "langevin"),
        ("-cc SHAKE C2-C3", thermo("nosehoover") + ["-cc", "1.47", "2,3"],
         None),
        (f"-ct {n_steps // 2} 500",
         thermo("berendsen") + ["-ct", str(n_steps // 2), "500"], None),
        ("-ntraj 2", thermo("nosehoover", n_steps // 2) + ["-ntraj", "2"],
         None),
        ("bias -kp -ka -kda -wp -brp -metad", thermo("nosehoover")
         + _BIAS_FLAGS, None),
    ]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def write_structure(path, coords_bohr, z):
    """One xyz file (Angstrom) from Bohr coordinates (N, 3)."""
    c = (coords_bohr.detach().cpu().numpy()
         if isinstance(coords_bohr, torch.Tensor) else np.asarray(coords_bohr))
    write_xyz(path, [z_to_symbol(int(k)) for k in z], c * BOHR2ANGSTROM)
    return str(path)


def _quiet_main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"{argv[0]} exited {rc}: {argv}")
    return buf.getvalue()


def mdmain_run(xyz, flags, device, out):
    """`mdmain xyz -calc sqm2 -temp 300 -dt 0.5 flags` into `out`: seconds,
    the first trajectory's energies (potential, temperature) and frames
    (Bohr)."""
    argv = ["mdmain", xyz, "-calc", "sqm2", "-temp", str(MD_TEMPERATURE),
            "-dt", str(MD_DT_FS), *flags, "-out", out, "--device", device]
    t0 = time.perf_counter()
    _quiet_main(argv)
    _sync(device)
    seconds = time.perf_counter() - t0
    suffix = "_0" if "-ntraj" in flags else ""
    energies = np.loadtxt(os.path.join(out, f"md_energies{suffix}.csv"),
                          ndmin=2)
    _, frames, _ = read_trajectory(os.path.join(out, f"md_traj{suffix}.xyz"))
    return {"seconds": seconds, "energies": energies,
            "frames": np.asarray(frames) / BOHR2ANGSTROM}


def total_energy_drift(energies, n_atoms):
    """max |E_pot + KE - (E_pot + KE)_0| over the rows of md_energies.csv,
    KE = dof k_B T / 2 with dof = 3N - 3."""
    e_tot = energies[:, 0] + 0.5 * (3 * n_atoms - 3) * KB_HARTREE \
        * energies[:, 1]
    return float(np.abs(e_tot - e_tot[0]).max())


def draws_of_seed(z, n_atoms, n_noise, device, seed=0,
                  temperature=MD_TEMPERATURE, dtype=torch.float64):
    """The initial velocities and the first `n_noise` Langevin draws that
    `run_md` takes from a generator seeded with `seed` on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    m = (masses_from_z(np.asarray(z)) * AMU2AU).to(dtype=dtype,
                                                   device=device)
    v0 = md.maxwell_boltzmann(gen, m, temperature, dtype)
    # one draw a step, as run_md takes them: a generator's stream depends
    # on the sizes of its calls
    noise = [torch.randn((n_atoms, 3), generator=gen, dtype=dtype,
                         device=device) for _ in range(n_noise)]
    return v0, torch.stack(noise) if noise else None


def md_cpu_rerun(coords, z, thermostat, velocities, noise=None,
                 n_steps=MD_CMP_STEPS):
    """The first `n_steps` of an mdmain run on the CPU (the kernel's
    algorithm), from the card's initial velocities (and Langevin draws)."""
    cfg = md.MDConfig(timestep_fs=MD_DT_FS, n_steps=n_steps,
                      temperature=MD_TEMPERATURE, thermostat=thermostat)
    res = md.run_md(SQM2(eigh_impl="kernel", device="cpu"),
                    torch.as_tensor(np.asarray(coords)), z, cfg,
                    velocities=torch.as_tensor(velocities.cpu().numpy()),
                    noise=None if noise is None else noise.cpu(),
                    device="cpu")
    return res.energies, res.trajectory


def device_profile(fn, reps=1):
    """Device ms and launches per call of fn() on the card, from
    torch.profiler tracing the card alone, summed over the raw trace (the
    profiler's aggregated tables take seconds to build for a call of tens
    of thousands of launches): {device_ms, launches, k1_launches} per
    call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_ns, launches, k1 = 0, 0, 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            dev_ns += ev.duration_ns()
            launches += 1
            k1 += "jacobi_" in ev.name()
    return {"device_ms": dev_ns / reps / 1e6, "launches": launches / reps,
            "k1_launches": k1 / reps}


def timed_and_profiled(fn, reps=1):
    """(result, {wall_ms, device_ms, launches, k1_launches, idle_share})
    of fn() on the card: the host-clock time of one unprofiled call after
    the one whose result is returned, and device_profile's numbers."""
    result = fn()
    _sync("cuda")
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync("cuda")
    out = {"wall_ms": (time.perf_counter() - t0) / reps * 1e3}
    out.update(device_profile(fn, reps))
    out["idle_share"] = 1.0 - out["device_ms"] / out["wall_ms"]
    return result, out


def md_step_profile(coords, z, thermostat, device, bias_flags=(), cc=(),
                    reps=2):
    """A warm MD step of SQM2 on `device` (the card), under mdmain's bias
    flags and -cc constraints when given: host ms, device ms, launches, K1
    launches and idle share per step."""
    bias = None
    if bias_flags:
        args = cli._base_parser("x").parse_args(["x.xyz", *bias_flags])
        bias = cli._make_bias(args, z)
    calc = SQM2(device=device)
    cfg = md.MDConfig(timestep_fs=MD_DT_FS, n_steps=0,
                      temperature=MD_TEMPERATURE, thermostat=thermostat)
    x = torch.as_tensor(np.asarray(coords), device=device)
    cons = cli._md_constraints(list(cc))
    state = md.run_md(calc, x, z, cfg, bias_engine=bias, constraints=cons,
                      device=device).final
    targets = None if cons is None else cons.targets(x[None])
    step = md.make_md_step(calc, z, cfg, bias, cons, targets)
    state = step(state)
    _, prof = timed_and_profiled(lambda: step(state), reps)
    return {"step_ms": prof["wall_ms"], "device_ms_per_step":
            prof["device_ms"], "launches_per_step": prof["launches"],
            "jacobi_launches_per_step": prof["k1_launches"],
            "device_idle_share": prof["idle_share"]}


def nve_check(coords, z, velocities, energies, device, n_fd=4):
    """Energy conservation of the mdmain NVE run (`energies`, its
    md_energies.csv rows at MD_DT_FS): the same start and velocities at
    half the time step over the same time, whose drift a second-order
    integrator with forces consistent with the energy cuts about fourfold;
    and central differences (h = 1e-4 Bohr) of the SQM2 energy along
    `n_fd` random directions at the run's last frame against its
    gradient."""
    n_atoms = len(z)
    n_steps = 2 * len(energies)
    calc = SQM2(device=device)
    x = torch.as_tensor(np.asarray(coords), device=device)
    t0 = time.perf_counter()
    half = md.run_md(calc, x, z, md.MDConfig(
        timestep_fs=MD_DT_FS / 2, n_steps=n_steps,
        temperature=MD_TEMPERATURE, thermostat="none"),
        velocities=velocities, device=device)
    _sync(device)
    seconds = time.perf_counter() - t0
    drift = total_energy_drift(energies, n_atoms)
    drift_half = total_energy_drift(np.stack([half.energies,
                                              half.temperatures], 1),
                                    n_atoms)
    xf = torch.as_tensor(half.trajectory[-1], device=device)
    _, g = hosteval.energy_and_gradient(calc, xf[None], z, None)
    rng = np.random.default_rng(0)
    fd_err, h = 0.0, 1e-4
    for _ in range(n_fd):
        d = torch.as_tensor(rng.standard_normal(xf.shape), device=device)
        d = d / torch.linalg.vector_norm(d)
        e = calc.energy(torch.stack([xf + h * d, xf - h * d]), z)
        fd = float((e[0] - e[1]) / (2 * h))
        fd_err = max(fd_err, abs(fd - float((g[0] * d).sum())))
    return {"drift_Ha": drift, "half_step_drift_Ha": drift_half,
            "drift_ratio": drift / max(drift_half, 1e-300),
            "half_step_run_s": seconds,
            "max_abs_fd_minus_gradient": fd_err}


def potential_configs(coords, z):
    """A valid configuration of every registered potential for the
    Diels-Alder system (18 atoms), name -> config."""
    z = np.asarray(z)
    all_atoms = list(range(1, len(z) + 1))
    diene, dienophile = [1, 2, 3, 4], [11, 12, 13, 14]
    return {
        "afir": dict(gamma=100.0, fragm_1=diene, fragm_2=dienophile,
                     element_z=z),
        "keep": dict(spring_const=0.1, distance=1.5, atom_pair=[2, 3]),
        "keep_v2": dict(spring_const=0.05, distance=3.0, fragm_1=diene,
                        fragm_2=dienophile),
        "keep_aniso": dict(spring_consts=[0.02, 0.03, 0.04],
                           distances=[0.3, 0.2, 3.0], atom_pair=[1, 11]),
        "keep_anharmonic": dict(spring_const=0.2, well_depth=0.1,
                                distance=1.4, atom_pair=[1, 2]),
        "keep_angle": dict(spring_const=0.05, angle=118.0, atoms=[1, 2, 3]),
        "keep_angle_v2": dict(spring_const=0.05, angle=70.0, fragm_1=[1],
                              fragm_2=[2, 3], fragm_3=[11, 12]),
        "keep_dihedral": dict(spring_const=0.02, angle=10.0,
                              atoms=[1, 2, 3, 4]),
        "keep_dihedral_v2": dict(spring_const=0.02, angle=-30.0,
                                 fragm_1=[1], fragm_2=[2], fragm_3=[3],
                                 fragm_4=[11, 12]),
        "keep_dihedral_cos": dict(potential_const=0.01, angle=20.0,
                                  multiplicity=2, fragm_1=[1], fragm_2=[2],
                                  fragm_3=[3, 4], fragm_4=[11, 12]),
        "keep_out_of_plane": dict(spring_const=0.02, angle=5.0,
                                  atoms=[5, 1, 2, 6]),
        "keep_out_of_plane_v2": dict(spring_const=0.02, angle=-5.0,
                                     fragm_1=[11], fragm_2=[12, 13],
                                     fragm_3=[14], fragm_4=[15, 16]),
        "well": dict(wall_energy=10.0, limits=[1.0, 2.0, 2.5, 3.0],
                     fragm_1=diene, fragm_2=dienophile),
        "well_vp": dict(wall_energy=10.0, limits=[0.5, 1.0, 2.0, 3.0],
                        point=[0.7, 1.2, 1.6], atoms=all_atoms),
        "well_wall": dict(wall_energy=10.0, limits=[-2.0, -1.0, 2.0, 3.0],
                          axis="z", atoms=all_atoms),
        "well_around": dict(wall_energy=10.0, limits=[0.5, 1.0, 2.0, 3.0],
                            center_fragm=diene, atoms=list(range(5, 19))),
        "void_point": dict(spring_const=0.01, distance=1.0, order=2.0,
                           point=[0.7, 1.2, 1.6], atom=[14]),
        "lj_repulsive_scale": dict(well_scale=1.0, dist_scale=0.9,
                                   fragm_1=diene, fragm_2=dienophile,
                                   element_z=z),
        "lj_repulsive_value": dict(well_value_kjmol=2.0, dist_value_ang=2.5,
                                   fragm_1=diene, fragm_2=dienophile,
                                   element_z=z),
        "lj_repulsive_v2": dict(well_scale=1.0, dist_scale=0.9, exp_a=10.0,
                                exp_b=5.0, fragm_1=diene,
                                fragm_2=dienophile, element_z=z),
        "lj_repulsive_gaussian": dict(well_depth=2.0, dist=2.5,
                                      gau_well_depth=1.0, gau_dist=2.8,
                                      gau_range=1.0, fragm_1=diene,
                                      fragm_2=dienophile, element_z=z),
        "cone": dict(well_value=2.0, dist_value=2.5, cone_angle=30.0,
                     center=2, three_atoms=[1, 3, 7], target=[15, 16],
                     element_z=z),
        "lj_repulsive_v2_probe": dict(well=1.0, dist=1.0, length_ang=1.5,
                                      const_rep=1.0, const_attr=1.0,
                                      order_rep=12.0, order_attr=6.0,
                                      center=[2, 3], target=dienophile,
                                      element_z=z, mode="scale"),
        "mechano_force": dict(force_pn=300.0, atoms_1=[1, 2],
                              atoms_2=[3, 4]),
        "mechano_force_v2": dict(force_pn=300.0, atom_pair=[1, 11]),
        "electrostatic_fragment": dict(charge_scale=0.01, fragm_1=diene,
                                       fragm_2=dienophile, element_z=z),
        "electrostatic_atom_pair": dict(charge_scale=0.01, atoms=dienophile,
                                        element_z=z),
        "value_range": dict(upper_const=2.0, lower_const=2.0,
                            upper_distance=4.0, lower_distance=2.0,
                            fragm_1=diene, fragm_2=dienophile),
        "gaussian_metadyn": dict(height_kjmol=2.0, width_ang=0.2,
                                 atom_pair=[1, 11]),
        "universal": dict(const=5.0, atoms=diene + dienophile),
        "flux": dict(const=[0.001, 0.001, 0.002], order=[2.0, 2.0, 2.0],
                     direction=[0.7, 1.2, 1.6], atoms=[14]),
        "nanoreactor": dict(inner_wall_ang=3.0, outer_wall_ang=4.0,
                            contraction_time=100.0, expansion_time=100.0,
                            contraction_k=1e-4, expansion_k=1e-4,
                            element_z=z),
        "idpp_bias": dict(target_coords=np.asarray(coords) * 1.02,
                          strength=0.5),
        "cfb_enm": dict(reference_coords=np.asarray(coords) * 1.05,
                        element_z=z, k=0.1, tolerance=0.02),
        "asym_ellipsoid": dict(atoms=[(1, 6), (13, 14)], offtgt=[[6], [14]],
                               eps=[1.0, 1.0],
                               sig=[[1.5, 1.2, 1.4, 1.1, 1.3, 1.0],
                                    [1.1, 1.3, 1.0, 1.2, 1.4, 1.5]],
                               dist=[3.5, 3.5], element_z=z),
        "spacer": dict(target=all_atoms, n_particles=8, sigma_ang=2.5,
                       depth_kjmol=1.0, cavity_scaling=2.0, element_z=z,
                       n_relax=100),
    }


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def potentials(coords, z):
    """Every registered potential in its Diels-Alder configuration, the
    metadynamics one with three hills deposited."""
    pots = []
    for name, cfg in potential_configs(coords, z).items():
        pot = get_potential(name, **cfg)
        if name == "gaussian_metadyn":
            for cv in (4.0, 4.4, 4.8):
                pot.deposit(cv)
        pots.append(pot)
    return pots


def potentials_check(coords, z, device):
    """Each potential alone in a BiasEngine on `device` and on the CPU:
    energy, gradient and Hessian at the Diels-Alder geometry; name ->
    {energy, rel_e, rel_g, rel_h, seconds}."""
    x_dev = torch.as_tensor(np.asarray(coords), device=device)[None]
    x_cpu = torch.as_tensor(np.asarray(coords))[None]
    out = {}
    for pot in potentials(coords, z):
        engine = BiasEngine([pot])
        t0 = time.perf_counter()
        e, g = engine.energy_and_gradient(x_dev)
        h = engine.hessian(x_dev)
        _sync(device)
        seconds = time.perf_counter() - t0
        e_c, g_c = engine.energy_and_gradient(x_cpu)
        h_c = engine.hessian(x_cpu)
        out[pot.name] = {"energy": float(e_c[0]),
                         "rel_e": _rel(e.cpu().numpy(), e_c.numpy()),
                         "rel_g": _rel(g.cpu().numpy(), g_c.numpy()),
                         "rel_h": _rel(h.cpu().numpy(), h_c.numpy()),
                         "seconds": seconds}
    return out


def all_potentials_gradient(coords, z, device):
    """Energy and gradient of all 36 potentials at once in one BiasEngine
    on `device` (the bias's share of each step of biased_optimization)."""
    engine = BiasEngine(potentials(coords, z))
    return engine.energy_and_gradient(
        torch.as_tensor(np.asarray(coords), device=device)[None])


def biased_optimization(coords, z, device, n_steps=20):
    """`optimize` with optmain's defaults (rfo_fsb, an exact initial
    Hessian) of the Diels-Alder reactant under all 36 potentials at once,
    on `device`: seconds and energies."""
    impl = "auto" if torch.device(device).type == "cuda" else "kernel"
    calc = SQM2(eigh_impl=impl, device=device)
    engine = BiasEngine(potentials(coords, z))
    t0 = time.perf_counter()
    res = optimize(calc, coords, z, bias_engine=engine,
                   config=OptimizeConfig(nsteps=n_steps), device=device)
    _sync(device)
    return {"seconds": time.perf_counter() - t0,
            "energies": res.energy_history, "steps": res.n_iterations}


def relaxed_minima(reactant, product, z, device, n_steps=100):
    """The flagship's IRC endpoints relaxed to minima on `device` (rfo_fsb
    from an exact Hessian, optmain's thresholds): the sphere searches
    start from equilibrium structures, whose Hessian is their harmonic
    reference, and an IRC stops short of one. Returns {reactant, product,
    energies, steps}."""
    impl = "auto" if torch.device(device).type == "cuda" else "kernel"
    calc = SQM2(eigh_impl=impl, device=device)
    out = {"energies": [], "steps": []}
    for name, x in (("reactant", reactant), ("product", product)):
        res = optimize(calc, torch.as_tensor(np.asarray(x)), z,
                       config=OptimizeConfig(nsteps=n_steps,
                                             init_hessian="exact"),
                       device=device)
        out[name] = res.coords.detach().cpu().numpy()
        out["energies"].append(float(res.energy))
        out["steps"].append(res.n_iterations)
    return out


def ieip_runs(n_steps=IEIP_STEPS):
    """(label, engine, ieipmain flags, start, end or None, check): start
    and end name the flagship's IRC endpoints ("reactant", "product") or
    their relaxed minima ("reactant_min", "product_min"). 2PSHS grows its
    spheres from the product's minimum, the shallower one, toward the
    reactant's; ADDF follows the reactant minimum's two softest channels,
    which leave the surface within a sphere, and the product minimum's,
    where one turns over and addf_explore refines the crossing. check is
    "first_iterations" (ieip_first_iterations on the card and the CPU) or
    "saddle" (saddle_check of the refined point: the product minimum's
    softest curvatures sit below 1e-5 Ha/Bohr^2, where two CPU
    eigensolvers already disagree on the first sphere by an O(1) Ha)."""
    first = "first_iterations"
    return [("eip", "eip", ["-em", "eip", "-ns", str(n_steps)],
             "reactant", "product", first),
            ("spring_pair", "spring_pair", ["-use_spm", "-ns", str(n_steps)],
             "reactant", "product", first),
            ("dimer", "dimer", ["-use_dimer", "-dimer_maxiter",
                                str(DIMER_ITERATIONS)],
             "reactant", "product", first),
            ("gnt", "gnt", ["-gnt", "-gnt_step", "0.4", "-gnt_mi",
                            str(GNT_ITERATIONS)],
             "reactant", "product", first),
            ("2pshs", "2pshs", ["-2pshs", "-2pshs_step", "0.1",
                                "-2pshs_num", str(PSHS_SPHERES)],
             "product_min", "reactant_min", first),
            ("addf reactant", "addf", ["-addf", "-addf_nadd", "2",
                                       "-addf_num", "10"],
             "reactant_min", None, first),
            ("addf product", "addf", ["-addf", "-addf_nadd", "2",
                                      "-addf_num", "10"],
             "product_min", None, "saddle")]


def saddle_check(coords, energy, z, device):
    """The imaginary modes of the SQM2 Hessian at `coords` on `device`, and
    |energy - the CPU's energy there| (the kernel's algorithm)."""
    from multioptpy_tpu_torch.analysis.vibrations import (count_imaginary,
                                                          normal_modes)

    x = torch.as_tensor(np.asarray(coords), device=device)
    h = hosteval.hessian(SQM2(device=device), x[None], z)[0]
    n_imag = int(count_imaginary(normal_modes(h, x, z).frequencies_cm1))
    e_cpu = float(SQM2(eigh_impl="kernel", device="cpu").energy(
        torch.as_tensor(np.asarray(coords))[None], z)[0])
    return {"n_imaginary": n_imag, "abs_e_diff_cpu_vs_card":
            abs(e_cpu - energy)}


def ieipmain_run(start_xyz, end_xyz, flags, device, out):
    """`ieipmain start [-i2 end] -sqm2 flags` into `out`: seconds, the TS
    guess energy and geometry (Bohr)."""
    argv = ["ieipmain", start_xyz,
            *(["-i2", end_xyz] if end_xyz is not None else []),
            "-sqm2", *flags, "-out", out, "--device", device]
    t0 = time.perf_counter()
    _quiet_main(argv)
    _sync(device)
    seconds = time.perf_counter() - t0
    _, frames, comments = read_trajectory(os.path.join(out, "ts_guess.xyz"))
    return {"seconds": seconds,
            "ts_energy": float(comments[0].split("=")[1]),
            "ts_guess": np.asarray(frames[0]) / BOHR2ANGSTROM}


def ieip_first_iterations(engine, start, end, z, device, eigh_impl=None):
    """The first iterations of an ieipmain run through its driver, in the
    configuration ieipmain builds, cut short: energies (N,). eip and
    spring_pair: 3 steps; dimer: 2; gnt: one step of 8 corrector
    iterations; 2pshs: the first sphere's first 5 relaxation steps (FIRE
    starts from rest on each sphere, so they are the run's own); addf: each
    channel's first sphere after one relaxation step. eigh_impl defaults
    to the kernel ("auto" on the card, its plain version on the CPU)."""
    impl = eigh_impl or ("auto" if torch.device(device).type == "cuda"
                         else "kernel")
    calc = SQM2(eigh_impl=impl, device=device)
    x0 = torch.as_tensor(np.asarray(start), device=device)
    x1 = None if end is None else torch.as_tensor(np.asarray(end),
                                                  device=device)
    if engine in ("eip", "spring_pair"):
        res = ieip.ieip(calc, x0, x1, z, ieip.IEIPConfig(engine=engine,
                                                         n_steps=3),
                        device=device)
    elif engine == "dimer":
        res = ieip.ieip(calc, x0, x1, z, ieip.IEIPConfig(
            engine="dimer", n_steps=2, dimer_rot_step=0.5), device=device)
    elif engine == "gnt":
        res = newton_traj.newton_trajectory(
            calc, x0, z, product_coords=x1, config=newton_traj.GNTConfig(
                step_size=0.4, n_corrector=8, n_steps=1), device=device)
    elif engine == "2pshs":
        res = twopshs.twopshs(calc, x0, x1, z, twopshs.TwoPSHSConfig(
            r_step=0.1, n_spheres=1, n_relax=5), device=device)
        return np.asarray(res.energies)
    else:
        chans = addf.addf_search(calc, x0, z, addf.ADDFConfig(
            n_channels=2, r_step=0.1, n_spheres=1, n_relax=1),
            device=device)
        return np.asarray([c.energies[-1] for c in chans])
    return np.asarray([float(res.ts_energy)])


def first_iterations_diff(engine, a, b):
    """max |a - b| of two ieip_first_iterations results; ADDF's channels
    2k and 2k+1 follow +/- one mode, whose sign is each eigensolver's own,
    so each pair is compared unordered."""
    a, b = np.asarray(a), np.asarray(b)
    if engine != "addf":
        return float(np.abs(a - b).max())
    worst = 0.0
    for k in range(0, len(a), 2):
        pa, pb = a[k:k + 2], b[k:k + 2]
        worst = max(worst, min(np.abs(pa - pb).max(),
                               np.abs(pa - pb[::-1]).max()))
    return float(worst)


def meta_irc_run(start, z, device, n_steps):
    impl = "auto" if torch.device(device).type == "cuda" else CPU_RERUN_BAND
    t0 = time.perf_counter()
    res = meta_irc(SQM2(eigh_impl=impl, device=device),
                   torch.as_tensor(np.asarray(start), device=device), z,
                   IRCConfig(method="lqa", n_steps=n_steps), device=device)
    _sync(device)
    return {"seconds": time.perf_counter() - t0,
            "energies": res.forward_energies, "start_energy": res.ts_energy}


def second_order_saddle_bias(ts, z, pair=(2, 3), spring_const=-1.0):
    """A `keep` restraint with a negative spring constant on the C2-C3 bond
    at its length in the TS: the TS stays stationary (the restraint's
    gradient vanishes at r0) and the bond's stretch turns downhill, so the
    TS is a second-order saddle of the biased surface. Returns (engine,
    number of imaginary modes there, on the CPU)."""
    from multioptpy_tpu_torch.analysis.vibrations import (count_imaginary,
                                                          normal_modes)

    x = torch.as_tensor(np.asarray(ts))
    r0 = float(torch.linalg.vector_norm(x[pair[0] - 1] - x[pair[1] - 1]))
    engine = BiasEngine([get_potential(
        "keep", spring_const=spring_const, distance=r0 * BOHR2ANGSTROM,
        atom_pair=list(pair))])
    h = hosteval.hessian(SQM2(device="cpu"), x[None], z, engine)[0]
    return engine, int(count_imaginary(normal_modes(h, x, z).frequencies_cm1))


def modekill_run(start, z, device, keep_order, max_rounds, opt_steps,
                 bias_engine=None):
    impl = "auto" if torch.device(device).type == "cuda" else CPU_RERUN_BAND
    calc = SQM2(eigh_impl=impl, device=device)
    t0 = time.perf_counter()
    coords, n_imag = modekill(
        calc, torch.as_tensor(np.asarray(start), device=device), z,
        keep_order=keep_order, max_rounds=max_rounds, bias_engine=bias_engine,
        opt_config=OptimizeConfig(method="rfo_bofill",
                                  saddle_order=keep_order, nsteps=opt_steps,
                                  fc_count=5, init_hessian="exact"),
        device=device)
    _sync(device)
    return {"seconds": time.perf_counter() - t0, "n_imaginary": n_imag,
            "coords": coords.cpu().numpy(),
            "energy": float(calc.energy(coords[None], z)[0]
                            + (0.0 if bias_engine is None else
                               bias_engine.total_energy(coords[None])[0]))}
