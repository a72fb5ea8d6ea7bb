"""The reaction-path entry points on real systems, with their CPU reruns.

`nebmain` and `ircmain` (through `cli.main`, as a user calls them), GPNEB
and the Hessian tools on the Diels-Alder system of the flagship and on the
aldol pair, each held to a rerun on the CPU through the kernel's algorithm
(`eigh_impl="kernel"`, the Jacobi kernel's plain version). The
`reaction_paths` phase of `chip_smoke.py` runs these on the card; with
`device="cpu"` and small depths they rehearse here:

    python3 -c "from multioptpy_tpu_torch import reaction_paths as r; \\
        pair = r.relaxed_aldol_pair('cpu'); \\
        print(r.aldol_neb(r.aldol_runs()[0], pair, 'cpu', n_steps=3))"
"""

import contextlib
import io
import os
import tempfile
import time

import numpy as np
import torch

from multioptpy_tpu_torch import cli
from multioptpy_tpu_torch.calculators.sqm import SQM2
from multioptpy_tpu_torch.drivers.neb import OPTIMIZERS, VARIANTS, aneb, neb
from multioptpy_tpu_torch.io.xyz import read_trajectory, write_xyz
from multioptpy_tpu_torch.periodic import z_to_symbol
from multioptpy_tpu_torch.units import BOHR2ANGSTROM

ALDOL_IMAGES = 12
# iterations of each aldol band (cut from 20 to keep chip_smoke.py inside
# its time limit: every band still redistributes twice, and -aneb 1 5 runs
# past the 7 iterations its CPU rerun compares)
ALDOL_STEPS = 10
# the band eigensolver of every CPU rerun that diagonalizes hundreds of
# bands a call (an exact Hessian: the IRC, method, meta-IRC and ModeKill
# runs, the workflows' relaxations): the kernel's plain version took 4-67 s
# of the host's CPU a rerun, LAPACK about a second. K1's band is held to
# LAPACK's on the card itself (workflow_paths.band_check); the reruns'
# steps keep the kernel's algorithm
CPU_RERUN_BAND = "xla"
IRC_METHODS = ("lqa", "euler", "rk4", "dvv", "hpc")
# every model-Hessian kind and suffix (hessian/model.py)
MODEL_KINDS = ("lindh", "lindh2007", "fischer", "schlegel", "swart", "gfn0",
               "gfnff", "morse", "lindh_d2", "lindhd3", "lindh2007d2",
               "lindh2007d3", "lindh2007d4", "lindh2007d3_raw", "fischerd3",
               "fischerd3old", "swartd4", "schlegel_sr", "gfnff_sr",
               "lindh_ts", "lindh2007d3_ts", "fischerd3old_ts", "morse_d2")


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
    """cli.main with its per-iteration lines kept off the terminal."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def nebmain(r_xyz, p_xyz, flags, n_images, n_steps, device, out):
    """`nebmain r -i2 p -sqm2 -nimg n -ns steps flags` into `out`: seconds,
    the per-iteration band energies (energy_plot.csv; the final band's
    alone under -aneb) and the final band's energies."""
    argv = ["nebmain", r_xyz, "-i2", p_xyz, "-sqm2", "-nimg", str(n_images),
            "-ns", str(n_steps), "-out", out, "--device", device, *flags]
    t0 = time.perf_counter()
    rc, _ = _quiet_main(argv)
    _sync(device)
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"nebmain exited {rc}: {argv}")
    rows = np.loadtxt(os.path.join(out, "energy_plot.csv"), delimiter=",",
                      ndmin=2)
    _, frames, comments = read_trajectory(os.path.join(out, "neb_path.xyz"))
    final = np.array([float(c.split("=")[1]) for c in comments])
    return {"seconds": seconds, "iterations": rows, "final": final,
            "n_images": len(frames)}


def neb_cpu_rerun(r_xyz, p_xyz, flags, n_images, n_steps):
    """The same band on the CPU through the library, the kernel's
    algorithm on SQM2's band: NEBResult."""
    _, _, path0, z, cfg, aneb_kw = cli.neb_job([
        r_xyz, "-i2", p_xyz, "-sqm2", "-nimg", str(n_images), "-ns",
        str(n_steps), "--device", "cpu", *flags])
    calc = SQM2(eigh_impl="kernel", device="cpu")
    if aneb_kw is not None:
        return aneb(calc, path0, z, cfg, device="cpu", **aneb_kw)
    return neb(calc, path0, z, cfg, device="cpu")


def aldol_runs():
    """(label, nebmain flags) of the breadth runs on the aldol pair: the 15
    force laws with FIRE, the 10 other band clocks with CI-NEB, IDPP, the
    spline climbing image, -aneb, per-image trust radii and the 11
    redistribution schemes every 5 iterations."""
    runs = [(f"-nebv {v}", ["-nebv", v]) for v in VARIANTS]
    runs += [(f"-nebopt {o}", ["-nebopt", o]) for o in OPTIMIZERS
             if o != "fire"]
    runs += [("-idpp", ["-idpp"]), ("-ci 5 5", ["-ci", "5", "5"]),
             ("-aneb 1 5", ["-aneb", "1", "5"]), ("-pitr", ["-pitr"])]
    runs += [(f"{flag} 5", [flag, "5"]) for flag, _, _ in cli.REDISTRIBUTION_FLAGS]
    runs.append(("-adsg 5,5,3", ["-adsg", "5,5,3"]))
    return runs


def relaxed_aldol_pair(device, nsteps=150):
    """The aldol reactant and adduct relaxed on SQM2 (rfo_fsb): numpy (N, 3)
    Bohr each, and z. Relaxed, the pair has a barrier inside the band
    (0.2 Ha at its eighth of 12 linear images); the raw fixtures fall
    downhill all the way."""
    from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig, optimize
    from multioptpy_tpu_torch.io.fixtures import aldol_adduct, aldol_reactant

    calc = SQM2(device=device)
    (r, z), (p, _) = aldol_reactant(), aldol_adduct()
    out = [optimize(calc, x, z, config=OptimizeConfig(
        method="rfo_fsb", nsteps=nsteps), device=device).coords
        .reshape(-1, 3).detach().cpu().numpy() for x in (r, p)]
    return out[0], out[1], z


def aldol_pair(workdir, pair):
    """The pair (reactant, adduct, z) as xyz files in `workdir`."""
    r, p, z = pair
    return (write_structure(os.path.join(workdir, "aldol_r.xyz"), r, z),
            write_structure(os.path.join(workdir, "aldol_p.xyz"), p, z))


def aldol_neb(run, pair, device, n_steps=ALDOL_STEPS, n_cmp=2, aneb_cmp=7,
              workdir=None):
    """One breadth run between `pair` (`relaxed_aldol_pair`) on `device`
    and its CPU rerun over the first `n_cmp` iterations: the numbers the
    phase prints. Under -aneb, whose log keeps only the final band, both
    sides stop after `aneb_cmp` iterations (past -aneb 1 5's first growth,
    so the inserted images and the restarted clock are held too) and
    their final bands are compared."""
    label, flags = run
    adaptive = "-aneb" in flags
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        r_xyz, p_xyz = aldol_pair(tmp, pair)
        res = nebmain(r_xyz, p_xyz, flags, ALDOL_IMAGES, n_steps, device,
                      os.path.join(tmp, "run"))
        if adaptive:
            n_cmp = aneb_cmp
            card = nebmain(r_xyz, p_xyz, flags, ALDOL_IMAGES, n_cmp, device,
                           os.path.join(tmp, "prefix"))["final"]
        else:
            card = res["iterations"][:n_cmp]
        t0 = time.perf_counter()
        cpu = neb_cpu_rerun(r_xyz, p_xyz, flags, ALDOL_IMAGES, n_cmp)
        cpu_s = time.perf_counter() - t0
    want = (cpu.energies.numpy() if adaptive
            else np.asarray(cpu.energy_history))
    energies = res["final"] if adaptive else res["iterations"]
    diff = (float(np.abs(card - want).max()) if card.shape == want.shape
            else float("inf"))
    return {"run": label, "n_images_final": res["n_images"],
            "iterations": n_steps, "compared_iterations": n_cmp,
            "compared_images": int(card.shape[-1]),
            "ms_per_iteration": res["seconds"] / n_steps * 1e3,
            "run_s": res["seconds"], "cpu_rerun_s": cpu_s,
            "finite": bool(np.isfinite(energies).all()),
            "e_max_final": float(res["final"].max()),
            "max_abs_e_diff_cpu_vs_card": diff}


def full_width_neb(reactant, product, z, device, n_steps=100, n_cmp=2,
                   workdir=None):
    """nebmain -sqm2 -nimg 16 -aconv -ns 100 between the flagship's IRC
    endpoints (the default CI-NEB with FIRE), and its first `n_cmp`
    iterations rerun on the CPU."""
    flags = ["-aconv"]
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        r_xyz = write_structure(os.path.join(tmp, "r.xyz"), reactant, z)
        p_xyz = write_structure(os.path.join(tmp, "p.xyz"), product, z)
        res = nebmain(r_xyz, p_xyz, flags, 16, n_steps, device,
                      os.path.join(tmp, "run"))
        t0 = time.perf_counter()
        cpu = neb_cpu_rerun(r_xyz, p_xyz, flags, 16, n_cmp)
        cpu_s = time.perf_counter() - t0
    rows = res["iterations"]
    final = res["final"]
    return {"iterations": len(rows),
            "ms_per_iteration": res["seconds"] / len(rows) * 1e3,
            "run_s": res["seconds"], "cpu_rerun_s": cpu_s,
            "finite": bool(np.isfinite(rows).all()
                           and np.isfinite(final).all()),
            "ts_index": int(np.argmax(final)),
            "interior_maximum": 0 < int(np.argmax(final)) < len(final) - 1,
            "energies_final": final.tolist(),
            "max_abs_e_diff_cpu_vs_card": float(np.abs(
                rows[:n_cmp] - np.asarray(cpu.energy_history)).max())}


def gpneb_run(pair, device, n_outer=2):
    """`gpneb` (a library call: nebmain has no flag for it) on the aldol
    band of 12 images between `pair`, and the same on the CPU: the final
    band's energies and path apart."""
    from multioptpy_tpu_torch.drivers.gpneb import GPNEBConfig, gpneb
    from multioptpy_tpu_torch.drivers.neb import interpolate_linear

    r, p, z = pair
    path0 = interpolate_linear(torch.as_tensor(r), torch.as_tensor(p),
                               ALDOL_IMAGES)
    cfg = GPNEBConfig(n_outer=n_outer)
    impl = "pallas" if torch.device(device).type == "cuda" else "kernel"
    t0 = time.perf_counter()
    res = gpneb(SQM2(eigh_impl=impl, device=device), path0.to(device), z,
                cfg, device=device)
    _sync(device)
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = gpneb(SQM2(eigh_impl="kernel", device="cpu"), path0, z, cfg,
                device="cpu")
    cpu_s = time.perf_counter() - t0
    e = res.energies.detach().cpu().numpy()
    return {"run": "gpneb", "n_outer": n_outer,
            "n_true_evaluations": res.n_true_evaluations,
            "ms_per_outer_round": seconds / n_outer * 1e3, "run_s": seconds,
            "cpu_rerun_s": cpu_s, "finite": bool(np.isfinite(e).all()),
            "max_abs_e_diff_cpu_vs_card": float(np.abs(
                e - cpu.energies.numpy()).max()),
            "max_abs_path_diff_cpu_vs_card": float(
                (res.path.detach().cpu() - cpu.path).abs().max())}


def irc_runs(ts_coords, z, device, n_steps=15, methods=IRC_METHODS,
             launch_counter=None, workdir=None):
    """ircmain -sqm2 -im m -ns n from the flagship's TS for each method, and
    each one's first 3 energies rerun on the CPU (2 steps and the energy at
    the third point, from one CPU TS Hessian), the CPU's band through
    `CPU_RERUN_BAND`. `launch_counter()`, if given, is read after each card
    run (the K1 launches by shape)."""
    from multioptpy_tpu_torch.drivers.irc import IRCConfig, irc
    from multioptpy_tpu_torch.ops import hosteval

    cpu_calc = SQM2(eigh_impl=CPU_RERUN_BAND, device="cpu")
    ts_cpu = torch.as_tensor(np.asarray(
        ts_coords.detach().cpu() if isinstance(ts_coords, torch.Tensor)
        else ts_coords))
    rows = []
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        ts_xyz = write_structure(os.path.join(tmp, "ts.xyz"), ts_cpu, z)
        # the CPU side reads the same rounded geometry as the card
        _, frames, _ = read_trajectory(ts_xyz)
        ts_read = torch.as_tensor(frames[0] / BOHR2ANGSTROM)
        e_ts = float(hosteval.energy(cpu_calc, ts_read[None], z)[0])
        t0 = time.perf_counter()
        h_ts = hosteval.hessian(cpu_calc, ts_read[None], z)[0]
        hess_s = time.perf_counter() - t0
        for method in methods:
            out = os.path.join(tmp, method)
            argv = ["ircmain", ts_xyz, "-sqm2", "-im", method, "-ns",
                    str(n_steps), "-out", out, "--device", device]
            t0 = time.perf_counter()
            rc, _ = _quiet_main(argv)
            _sync(device)
            seconds = time.perf_counter() - t0
            if rc != 0:
                raise RuntimeError(f"ircmain exited {rc}: {argv}")
            launches = launch_counter() if launch_counter else None
            e_card = np.loadtxt(os.path.join(out, "irc_energies.csv"),
                                ndmin=2)
            t0 = time.perf_counter()
            cpu = irc(cpu_calc, ts_read, z, hessian=h_ts,
                      config=IRCConfig(method=method, n_steps=2),
                      device="cpu")
            third = hosteval.energy(cpu_calc, torch.as_tensor(np.stack(
                [cpu.forward_path[1], cpu.backward_path[1]])), z).numpy()
            cpu_s = time.perf_counter() - t0
            e_cpu = np.stack([np.append(cpu.forward_energies, third[0]),
                              np.append(cpu.backward_energies, third[1])], 1)
            # the imaginary mode's sign (each eigensolver's) may swap them
            if abs(e_cpu[0, 0] - e_card[0, 0]) > abs(e_cpu[0, 1]
                                                     - e_card[0, 0]):
                e_cpu = e_cpu[:, ::-1]
            n = min(3, len(e_card))
            rows.append({
                "method": method, "steps": len(e_card),
                "ms_per_step": seconds / len(e_card) * 1e3,
                "run_s": seconds, "cpu_rerun_s": cpu_s,
                "cpu_ts_hessian_s": hess_s, "ts_energy": e_ts,
                "energies_first3": e_card[:3].tolist(),
                "energies_last": e_card[-1].tolist(),
                "finite": bool(np.isfinite(e_card).all()),
                "descends": bool((e_card < e_ts).all()
                                 and (e_card[-1] < e_card[0]).all()),
                "max_abs_e_diff_cpu_vs_card": float(np.abs(
                    e_card[:n] - e_cpu[:n]).max()),
                "k1_launches_by_shape": launches})
    return rows


def hessian_tools(coords, z, device, kinds=MODEL_KINDS, optmain_steps=5,
                  workdir=None):
    """Every model-Hessian kind, o1numhess (given probe directions) and
    o1numhess_full on `device` against the CPU, and one
    `optmain -sqm2 -modelhess` run: relative gaps and the run's
    energies."""
    from multioptpy_tpu_torch.hessian.model import model_hessian
    from multioptpy_tpu_torch.hessian.o1numhess import (o1numhess,
                                                        o1numhess_full)

    x_cpu = torch.as_tensor(np.asarray(coords))
    x_dev = x_cpu.to(device)
    rng = np.random.default_rng(3)
    grad = torch.as_tensor(0.02 * rng.standard_normal(x_cpu.shape))

    def rel(a, b):
        a = a.detach().cpu()
        return float((a - b).abs().max() / b.abs().max())

    out = {"model_kinds": {}}
    t0 = time.perf_counter()
    for kind in kinds:
        got = model_hessian(x_dev[None], z, kind=kind,
                            gradient=grad[None].to(device))
        want = model_hessian(x_cpu[None], z, kind=kind, gradient=grad[None])
        out["model_kinds"][kind] = rel(got, want)
    _sync(device)
    out["model_kinds_s"] = time.perf_counter() - t0
    impl = "pallas" if torch.device(device).type == "cuda" else "kernel"
    calc = SQM2(eigh_impl=impl, device=device)
    cpu_calc = SQM2(eigh_impl="kernel", device="cpu")
    dirs = rng.standard_normal((6, x_cpu.numel()))
    t0 = time.perf_counter()
    got = o1numhess(calc, x_dev, z, directions=dirs)
    _sync(device)
    out["o1numhess_s"] = time.perf_counter() - t0
    out["o1numhess_rel_diff"] = rel(got, o1numhess(cpu_calc, x_cpu, z,
                                                   directions=dirs))
    t0 = time.perf_counter()
    got = o1numhess_full(calc, x_dev, z)
    _sync(device)
    out["o1numhess_full_s"] = time.perf_counter() - t0
    out["o1numhess_full_rel_diff"] = rel(got, o1numhess_full(cpu_calc, x_cpu,
                                                             z))
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        inp = write_structure(os.path.join(tmp, "reactant.xyz"), x_cpu, z)
        argv = ["optmain", inp, "-sqm2", "-modelhess", "-ns",
                str(optmain_steps), "-out", os.path.join(tmp, "opt"),
                "--device", device]
        t0 = time.perf_counter()
        rc, _ = _quiet_main(argv)
        _sync(device)
        out["optmain_modelhess_s"] = time.perf_counter() - t0
        e = np.loadtxt(os.path.join(tmp, "opt", "energies.csv"), ndmin=1)
    out["optmain_modelhess_rc"] = rc
    out["optmain_modelhess_energies"] = e.tolist()
    out["optmain_modelhess_finite"] = bool(np.isfinite(e).all()
                                           and len(e) > 1)
    return out
