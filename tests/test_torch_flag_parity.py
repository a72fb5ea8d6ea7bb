"""Port parity: the command-line flag surface of multioptpy_tpu_torch
against the JAX package's.

Each of the ten commands' parsers is captured in both packages and
compared action by action (option strings, dest, nargs, type, default,
choices, const, required and the action's class): the port's only extra
options are `--device` and `--eigh_impl`. Then the flags that act: `-srb`
on `optmain -calc sqm`, `-d` (with and without `-delta`) on optmain,
relaxedscan and orientsearch (the configuration each hands its driver,
and runs), `-diis` on relaxedscan and orientsearch,
`optmain -irc` from a saddle (IRC) and from a minimum (meta-IRC),
`run_autots` with a v1 config that sets `skip_to_step4`; and the flags
both packages parse and apply to nothing (ROADMAP Queue 3, F10): `-beta`
on optmain and the shared constraint, guard and wrapper flags on mdmain
and ircmain, whose runs with and without them write the same files in
both packages. Bounds: 1e-10 Ha on energies, 1e-9 Angstrom on
coordinates, unless a test states another with its reason.
"""

import argparse
import json

import numpy as np
import pytest
import torch

from multioptpy_tpu import __main__ as ref_main
from multioptpy_tpu_torch import __main__ as port_main
from multioptpy_tpu_torch import cli
from multioptpy_tpu_torch.calculators.model_surfaces import (MB_MIN_A,
                                                             MB_TS_AB)
from multioptpy_tpu_torch.io.xyz import read_trajectory

torch.set_num_threads(1)

_B2A = 0.52917721067

# the port's options of its own, with why the reference has none
PORT_ONLY = {
    ("--device",): "the card (default) or the CPU; the reference runs "
                   "where JAX_PLATFORMS points",
    ("--eigh_impl",): "the eigensolver of the RS-RFO step and the SQM band "
                      "(the Jacobi kernel or torch.linalg.eigh)",
}


class _Captured(Exception):
    pass


def _parser_of(fn, monkeypatch):
    """The ArgumentParser that `fn` builds, caught as it parses."""
    def grab(self, *a, **k):
        raise _Captured(self)
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_known_args", grab)
        with pytest.raises(_Captured) as exc:
            fn(["input.xyz"])
    return exc.value.args[0]


def _actions(parser):
    return {tuple(a.option_strings) or (a.dest,):
            {"dest": a.dest, "nargs": a.nargs, "type": a.type,
             "default": a.default, "choices": a.choices, "const": a.const,
             "required": a.required, "action": type(a)}
            for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


@pytest.mark.parametrize("cmd", sorted(ref_main.COMMANDS))
def test_parser_matches_the_reference(cmd, monkeypatch):
    ref = _actions(_parser_of(ref_main.COMMANDS[cmd], monkeypatch))
    got = _actions(_parser_of(cli.COMMANDS[cmd], monkeypatch))
    assert sorted(set(ref) - set(got)) == []
    assert sorted(set(got) - set(ref)) == sorted(PORT_ONLY)
    for opts, want in ref.items():
        assert got[opts] == want, opts


def _read(path):
    _, frames, comments = read_trajectory(str(path))
    return frames, comments


def _one_frame(path):
    lines = path.read_text().splitlines()
    return lines[1], np.array([ln.split()[1:] for ln in lines[2:]], float)


def _both(cmd, args, tmp_path, capsys, tag=""):
    """`cmd args` in both packages into tmp_path/ref{tag} and
    tmp_path/port{tag}: the exit statuses and last stdout lines must
    agree; returns the two directories."""
    ref_dir, got_dir = tmp_path / f"ref{tag}", tmp_path / f"port{tag}"
    rc_ref = ref_main.main([cmd, *args, "-out", str(ref_dir)])
    ref_line = capsys.readouterr().out.strip().splitlines()[-1]
    rc = port_main.main([cmd, *args, "-out", str(got_dir), "--device",
                         "cpu"])
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert rc == rc_ref
    assert got_line.replace(str(got_dir), str(ref_dir)) == ref_line
    return ref_dir, got_dir


def _same_optimization(ref_dir, got_dir):
    (c_ref, x_ref), (c_got, x_got) = (_one_frame(d / "optimized.xyz")
                                      for d in (ref_dir, got_dir))
    assert float(c_got.split("=")[1]) == pytest.approx(
        float(c_ref.split("=")[1]), rel=0, abs=1e-10)
    np.testing.assert_allclose(x_got, x_ref, rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.loadtxt(got_dir / "energies.csv"),
                               np.loadtxt(ref_dir / "energies.csv"), rtol=0,
                               atol=1e-10)


_HCN = "3\nHCN\nH 0.0 0.0 -1.62\nC 0.0 0.0 -0.55\nN 0.0 0.0 0.63\n"


def test_srb_on_sqm_matches_the_reference(tmp_path, capsys):
    """`optmain -calc sqm -srb` on HCN+ (a cation: the reference's f32
    Fermi count limits closed shells to ~1e-7 Ha, ROADMAP F1), 3 steps:
    the reference's energies and geometry, and not those of the run
    without -srb (its SRB term here is ~1e-3 Ha)."""
    inp = tmp_path / "hcn.xyz"
    inp.write_text(_HCN)
    args = [str(inp), "-calc", "sqm", "-c", "1", "-m", "2", "-ns", "3",
            "-nosymm"]
    ref_dir, got_dir = _both("optmain", [*args, "-srb"], tmp_path, capsys)
    _same_optimization(ref_dir, got_dir)
    assert port_main.main(["optmain", *args, "-out", str(tmp_path / "bare"),
                           "--device", "cpu"]) in (0, 1)
    capsys.readouterr()
    e_srb = np.loadtxt(got_dir / "energies.csv")
    e_bare = np.loadtxt(tmp_path / "bare" / "energies.csv")
    assert abs(e_srb[0] - e_bare[0]) > 1e-5

    def srb(*flags):
        return cli._make_calculator(cli._base_parser("t").parse_args(
            [str(inp), *flags, "--device", "cpu"])).srb
    # only -calc sqm takes the flag; SQM2 carries its SRB term always
    assert (srb("-calc", "sqm", "-srb"), srb("-calc", "sqm")) == (True, False)
    assert srb("-sqm1", "-srb") is False
    assert srb("-calc", "sqm2", "-srb") is srb("-calc", "sqm2") is True


_AR4 = ("4\nAr4\nAr 0.0 0.0 0.0\nAr 3.76 0.05 0.0\n"
        "Ar 1.88 3.26 0.1\nAr 1.88 1.09 3.07\n")
_STEP_SCALES = {"-d x": ["-d", "x"], "-d 0.5": ["-d", "0.5"],
                "-d 0.5 -delta 0.7": ["-d", "0.5", "-delta", "0.7"]}


@pytest.mark.parametrize("scale", sorted(_STEP_SCALES))
def test_optmain_step_scale_flags_match_the_reference(scale, tmp_path,
                                                      capsys):
    """-d on optmain with a first-order method (cg on Ar4, LJ, 4 steps):
    the reference's energies and geometry."""
    inp = tmp_path / "ar4.xyz"
    inp.write_text(_AR4)
    args = [str(inp), "-opt", "cg", "-ns", "4", "-nosymm"]
    ref_dir, got_dir = _both("optmain", [*args, *_STEP_SCALES[scale]],
                             tmp_path, capsys)
    _same_optimization(ref_dir, got_dir)


_STEP_FLAGS = {**_STEP_SCALES, "-diis gdiis": ["-diis", "gdiis"],
               "-diis kdiis -delta 0.3": ["-diis", "kdiis", "-delta", "0.3"]}
# (delta, diis_variant) each set gives: "x" keeps the default, a value
# applies while -delta is 1.0, and -delta wins over -d
_STEP_CONFIG = {"-d x": (1.0, None), "-d 0.5": (0.5, None),
                "-d 0.5 -delta 0.7": (0.7, None),
                "-diis gdiis": (1.0, "gdiis"),
                "-diis kdiis -delta 0.3": (0.3, "kdiis")}
# where each command hands its optimizer configuration on, per package
_CONFIG_SINKS = {
    "optmain": ("drivers.optimize", "optimize", []),
    "relaxedscan": ("workflows", "relaxed_scan", ["-sa", "1,2", "-sr",
                                                  "3.6,4.0,3"]),
    "orientsearch": ("workflows.orientsearch", "orientation_search",
                     ["-part", "3,4"]),
}


@pytest.mark.parametrize("flags", sorted(_STEP_FLAGS))
@pytest.mark.parametrize("cmd", sorted(_CONFIG_SINKS))
def test_step_flags_reach_the_same_optimizer_config(cmd, flags, tmp_path,
                                                    monkeypatch):
    """-d, -delta and -diis give the same OptimizeConfig, field by field,
    in both packages' optmain, relaxedscan and orientsearch: each
    command's configuration is caught where it is handed to its driver."""
    import dataclasses
    import importlib

    inp = tmp_path / "ar4.xyz"
    inp.write_text(_AR4)
    where, name, extra = _CONFIG_SINKS[cmd]
    got = {}
    for pkg, main, dev in (("multioptpy_tpu", ref_main.main, []),
                           ("multioptpy_tpu_torch", port_main.main,
                            ["--device", "cpu"])):
        def sink(*a, **k):
            raise _Captured(k["config"])
        monkeypatch.setattr(importlib.import_module(f"{pkg}.{where}"), name,
                            sink)
        with pytest.raises(_Captured) as exc:
            main([cmd, str(inp), *extra, *_STEP_FLAGS[flags], "-out",
                  str(tmp_path / pkg), *dev])
        got[pkg] = dataclasses.asdict(exc.value.args[0])
    assert got["multioptpy_tpu_torch"] == got["multioptpy_tpu"]
    assert (got["multioptpy_tpu"]["delta"],
            got["multioptpy_tpu"]["diis_variant"]) == _STEP_CONFIG[flags]


_AR3 = "3\nAr3\nAr 0.0 0.0 0.0\nAr 3.76 0.05 0.0\nAr 1.88 3.26 0.1\n"
_ORIENT = ["-part", "3", "-nsample", "2", "-dist", "4.0"]
_WORKFLOW_FLAGS = {
    "relaxedscan -diis gdiis": ("relaxedscan", _AR4,
                                ["-sa", "1,2", "-sr", "3.6,4.0,3", "-ns",
                                 "15", "-diis", "gdiis"]),
    "orientsearch -diis gdiis": ("orientsearch", _AR3, [*_ORIENT, "-diis",
                                                        "gdiis"]),
    "orientsearch -opt sd -d 0.5 -delta 0.7": (
        "orientsearch", _AR3, [*_ORIENT, "-opt", "sd", "-d", "0.5",
                               "-delta", "0.7"]),
}


@pytest.mark.parametrize("case", sorted(_WORKFLOW_FLAGS))
def test_workflow_optimizer_flags_match_the_reference(case, tmp_path,
                                                      capsys):
    """-diis, -delta and -d act on each point's optimization: relaxedscan
    on Ar4 (LJ, 15 steps a point) and orientsearch on Ar3 with the third
    atom as the mobile fragment (its 100-step batched relaxations; on Ar4
    a GDIIS relaxation moves by 7e-5 Angstrom when the input moves by
    1e-13, on Ar3 by 2e-10). The reference's geometries and energies
    (1e-9 Angstrom, 1e-10 Ha)."""
    cmd, xyz, flags = _WORKFLOW_FLAGS[case]
    inp = tmp_path / "ar.xyz"
    inp.write_text(xyz)
    ref_dir, got_dir = _both(cmd, [str(inp), *flags], tmp_path, capsys)
    name = "scan.xyz" if cmd == "relaxedscan" else "orientations.xyz"
    (f_ref, c_ref), (f_got, c_got) = (_read(d / name)
                                      for d in (ref_dir, got_dir))
    np.testing.assert_allclose(f_got, f_ref, rtol=0, atol=1e-9)
    np.testing.assert_allclose([float(c.split("=")[-1]) for c in c_got],
                               [float(c.split("=")[-1]) for c in c_ref],
                               rtol=0, atol=1e-10)


def _mb_point(tmp_path, name, xy):
    path = tmp_path / name
    path.write_text(f"1\nmb\nH {xy[0] * _B2A:.16f} {xy[1] * _B2A:.16f} "
                    "0.0\n")
    return str(path)


@pytest.mark.parametrize("start", ["saddle", "minimum"])
def test_optmain_irc_chain_matches_the_reference(start, tmp_path, capsys):
    """optmain -irc 0.05 12 lqa on Muller-Brown: from near the AB saddle
    (-order 1: the exact Hessian has a negative eigenvalue, -49 Ha/Bohr^2,
    so the chain takes the IRC) and from near minimum A (all eigenvalues
    at or above zero: the meta-IRC). The same irc_path.xyz,
    irc_energies.csv and curvature CSVs; the imaginary mode's sign is each
    eigensolver's, so the path may run the other way."""
    xy = ((MB_TS_AB[0] + 0.01, MB_TS_AB[1] - 0.01) if start == "saddle"
          else (MB_MIN_A[0] + 0.02, MB_MIN_A[1] + 0.02))
    inp = _mb_point(tmp_path, "start.xyz", xy)
    args = [inp, "-calc", "muller_brown", "-ns", "6", "-nosymm", "-irc",
            "0.05", "12", "lqa"]
    if start == "saddle":
        args += ["-opt", "rfo_bofill", "-order", "1"]
    ref_dir, got_dir = _both("optmain", args, tmp_path, capsys)
    _same_optimization(ref_dir, got_dir)
    f_ref, _ = _read(ref_dir / "irc_path.xyz")
    f_got, _ = _read(got_dir / "irc_path.xyz")
    e_ref = np.loadtxt(ref_dir / "irc_energies.csv")
    e_got = np.loadtxt(got_dir / "irc_energies.csv")
    assert f_got.shape == f_ref.shape and len(e_got) == len(e_ref)
    swap = start == "saddle" and abs(e_got[0] - e_ref[0]) > 1e-9
    if swap:
        f_got, e_got = f_got[::-1], e_got[::-1]
    np.testing.assert_allclose(e_got, e_ref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(f_got, f_ref, rtol=0, atol=1e-9)
    names = sorted(p.name for p in ref_dir.iterdir() if "curvature" in p.name
                   or "bending" in p.name)
    assert names == sorted(p.name for p in got_dir.iterdir()
                           if "curvature" in p.name or "bending" in p.name)
    assert bool(names) == (start == "saddle")
    for name in names:
        other = (name.replace("forward", "@").replace("backward", "forward")
                 .replace("@", "backward") if swap else name)
        want = np.loadtxt(ref_dir / name, delimiter=",", skiprows=1)
        got = np.loadtxt(got_dir / other, delimiter=",", skiprows=1)
        np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=1e-8,
                                   atol=1e-9, err_msg=name)


def test_run_autots_skip_to_step4_matches_the_reference(tmp_path, capsys):
    """A v1 config with skip_to_step4 takes the input as the TS guess (the
    Muller-Brown AB saddle moved by (0.05, -0.04)): the reference's
    refined TS, imaginary-mode count and optimized IRC ends (1e-9
    Angstrom; the ends may trade places with the imaginary mode's
    sign)."""
    cfg = tmp_path / "v1.json"
    cfg.write_text(json.dumps({
        "skip_to_step4": True,
        "step3_settings": {"opt_method": ["rsirfo_bofill"],
                           "calc_exact_hess": 3, "max_trust_radius": 0.1},
        "step4_settings": {"intrinsic_reaction_coordinates": ["0.08", "60",
                                                              "lqa"]}}))
    inp = _mb_point(tmp_path, "guess.xyz",
                    (MB_TS_AB[0] + 0.05, MB_TS_AB[1] - 0.04))
    ref_dir, got_dir = _both("run_autots", [inp, "-calc", "muller_brown",
                                            "-cfg", str(cfg)],
                             tmp_path, capsys)
    (c_ref, ts_ref), (c_got, ts_got) = (_one_frame(d / "ts.xyz")
                                        for d in (ref_dir, got_dir))
    assert c_got == c_ref and c_ref.endswith("n_imag = 1")
    np.testing.assert_allclose(ts_got, ts_ref, rtol=0, atol=1e-9)
    ends_ref = [_one_frame(ref_dir / f"irc_end_{k}.xyz")[1] for k in (1, 2)]
    ends_got = [_one_frame(got_dir / f"irc_end_{k}.xyz")[1] for k in (1, 2)]
    if np.abs(ends_got[0] - ends_ref[0]).max() > 1e-6:
        ends_got = ends_got[::-1]
    for got, want in zip(ends_got, ends_ref):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert np.abs(ends_ref[0] - ends_ref[1]).max() > 0.1


def test_optmain_beta_is_applied_to_nothing(tmp_path, capsys):
    """optmain parses -beta and, as the reference, applies it to nothing:
    runs with and without it write the same files in both packages."""
    inp = tmp_path / "ar4.xyz"
    inp.write_text(_AR4)
    args = [str(inp), "-ns", "3", "-nosymm"]
    dirs = {}
    for tag, extra in (("", []), ("_beta", ["-beta", "3.0"])):
        dirs[tag] = _both("optmain", [*args, *extra], tmp_path, capsys, tag)
        _same_optimization(*dirs[tag])
    for k in range(2):
        for name in ("optimized.xyz", "trajectory.xyz", "energies.csv"):
            assert (dirs["_beta"][k] / name).read_text() == \
                (dirs[""][k] / name).read_text(), name


# every shared flag that mdmain and ircmain parse and apply to nothing
_F10_FLAGS = ["-fix", "1", "-pc", "bond", "1,2", "-gi", "bond", "1,2",
              "-dc", "3", "-sc", "9.0", "lt", "1,2", "-gfix", "1,2", "-of",
              "1", "2", "-negeigval", "-mi", "2", "-beta", "2.0", "-mf",
              "seam"]


@pytest.mark.parametrize("cmd", ["mdmain", "ircmain"])
def test_f10_flags_applied_to_nothing(cmd, tmp_path, capsys):
    """ROADMAP Queue 3, F10: mdmain (Ar4, LJ, 6 steps without a
    thermostat) and ircmain (the Muller-Brown AB saddle, 6 LQA steps)
    parse optmain's constraint, guard and wrapper flags and -beta and
    apply them to nothing, in both packages: the runs with them write the
    same files as the runs without."""
    if cmd == "mdmain":
        inp = tmp_path / "ar4.xyz"
        inp.write_text(_AR4)
        args = [str(inp), "-time", "6", "-thermo", "none"]
        files = ("md_traj.xyz", "md_energies.csv")
    else:
        args = [_mb_point(tmp_path, "ts.xyz", MB_TS_AB), "-calc",
                "muller_brown", "-ns", "6"]
        files = ("irc_forward.xyz", "irc_backward.xyz", "irc_energies.csv")
    for main, tag in ((ref_main.main, "ref"), (port_main.main, "port")):
        dev = [] if tag == "ref" else ["--device", "cpu"]
        for sub, extra in (("", []), ("_f10", _F10_FLAGS)):
            assert main([cmd, *args, *extra, "-out",
                         str(tmp_path / f"{tag}{sub}"), *dev]) == 0
        capsys.readouterr()
        for name in files:
            assert (tmp_path / f"{tag}_f10" / name).read_text() == \
                (tmp_path / tag / name).read_text(), (tag, name)
