"""Port parity: `python -m multioptpy_tpu_torch` against the JAX package's
CLI: run_autots on Muller-Brown (also with a v1 config that asks for IDPP
and a spline redistribution, and with a v2 workflow), optmain on H2O+
(also with the bare -modelhess), nebmain on an Ar5 band, ircmain on
Muller-Brown with each integrator, and confsearch, relaxedscan,
orientsearch and run_mapper on Ar clusters (Lennard-Jones) write the same
files; every command of the reference dispatches; a flag of neither
package exits with status 2 through argparse in both; the device
defaults to the card. The n-octane fixture matches the reference's."""

import json

import numpy as np
import pytest
import torch

from multioptpy_tpu import __main__ as ref_main
from multioptpy_tpu_torch import __main__ as port_main
from multioptpy_tpu_torch.calculators.model_surfaces import MB_MIN_A, MB_MIN_C

torch.set_num_threads(1)

_B2A = 0.52917721067


def _mb_inputs(tmp_path):
    for name, (x, y) in (("react.xyz", MB_MIN_A), ("prod.xyz", MB_MIN_C)):
        (tmp_path / name).write_text(
            f"1\nmb\nH {x * _B2A:.16f} {y * _B2A:.16f} 0.0\n")
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"autots": {"n_images": 10, "top_n_candidates": 1}}))
    return [str(tmp_path / "react.xyz"), "-prod", str(tmp_path / "prod.xyz"),
            "-calc", "muller_brown", "-cfg", str(tmp_path / "cfg.json")]


def test_run_autots_writes_the_reference_ts(tmp_path, capsys):
    args = _mb_inputs(tmp_path)
    assert ref_main.main(["run_autots", *args, "-out",
                          str(tmp_path / "ref")]) == 0
    ref_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_main.main(["run_autots", *args, "-out",
                           str(tmp_path / "port"), "--device", "cpu"]) == 0
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert got_line.replace("/port/", "/ref/") == ref_line
    for name in ("ts.xyz", "irc_end_1.xyz", "irc_end_2.xyz"):
        ref = (tmp_path / "ref" / name).read_text().splitlines()
        got = (tmp_path / "port" / name).read_text().splitlines()
        assert got[:2] == ref[:2], name
        np.testing.assert_allclose(
            np.array(got[2].split()[1:], float),
            np.array(ref[2].split()[1:], float), rtol=0, atol=1e-8)


def test_optmain_writes_the_reference_geometry(tmp_path, capsys):
    inp = tmp_path / "h2o.xyz"
    inp.write_text("3\nwater\nO 0.0 0.0 0.1173\nH 0.0 0.80 -0.4692\n"
                   "H 0.0 -0.7572 -0.45\n")
    args = [str(inp), "-calc", "sqm2", "-c", "1", "-m", "2", "-ns", "4"]
    ref_main.main(["optmain", *args, "-out", str(tmp_path / "ref"),
                   "-nosymm"])
    capsys.readouterr()
    rc = port_main.main(["optmain", *args, "-out", str(tmp_path / "port"),
                         "--device", "cpu"])
    assert rc in (0, 1)
    ref = (tmp_path / "ref" / "optimized.xyz").read_text().splitlines()
    got = (tmp_path / "port" / "optimized.xyz").read_text().splitlines()
    e_ref, e_got = (float(x[1].split("=")[1]) for x in (ref, got))
    assert e_got == pytest.approx(e_ref, rel=1e-10)
    np.testing.assert_allclose(
        np.array([ln.split()[1:] for ln in got[2:]], float),
        np.array([ln.split()[1:] for ln in ref[2:]], float), rtol=0,
        atol=1e-8)
    np.testing.assert_allclose(
        np.loadtxt(tmp_path / "port" / "energies.csv"),
        np.loadtxt(tmp_path / "ref" / "energies.csv"), rtol=1e-10)


def test_unported_commands_and_flags_exit_2(tmp_path, capsys):
    args = _mb_inputs(tmp_path)
    # every command of the reference dispatches
    assert set(ref_main.COMMANDS) == set(port_main.COMMANDS)
    for name in ref_main.COMMANDS:
        assert port_main.COMMANDS[name].__name__ == \
            ref_main.COMMANDS[name].__name__
    # a flag of neither package: argparse's own exit, in both
    for main, extra in ((ref_main.main, []),
                        (port_main.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as exc:
            main(["run_autots", *args, "-freq", *extra])
        assert exc.value.code == 2
        assert "unrecognized arguments: -freq" in capsys.readouterr().err
    assert port_main.main(["unknown"]) == 2


def test_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main.main(["run_autots", *_mb_inputs(tmp_path)])


def test_flagship_sweep_check_defaults_to_the_card():
    """`python3 -m multioptpy_tpu_torch.flagship` runs on the card unless
    asked for the CPU."""
    from multioptpy_tpu_torch import flagship

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship.main([])


_AR4 = ("4\nAr4\nAr 1.05 1.1 1.5\nAr 1.2 -1.6 -0.9\nAr -1.7 1.4 -1.2\n"
        "Ar -1.3 -1.2 1.1\n")

_FLAG_SETS = [
    ["-opt", "fire", "rfo_fsb"],
    ["-opt", "rfo_fsb", "-diis", "gediis"],
    ["-opt", "cg", "-delta", "0.5"],
    ["-fix", "1", "-pc", "bond", "2,3", "angle", "1,2,4"],
    ["-pc", "fbond", "1,2", "3,4", "atoms_pair", "1,3"],
    ["-gfix", "1,2"],
    ["-sc", "3.6", "lt", "1,2", "-dc", "8"],
    ["-opt", "rsprfo_bofill", "-order", "1", "-fc", "2", "-negeigval"],
]


@pytest.mark.parametrize("flags", _FLAG_SETS,
                         ids=[" ".join(f) for f in _FLAG_SETS])
def test_optmain_flags_match_the_reference(flags, tmp_path, capsys):
    """optmain's engine flags on the reference's default backend (LJ), 4
    steps of an Ar4 cluster: the same geometry and energies (1e-10 Ha,
    1e-8 Angstrom) and the same exit status."""
    inp = tmp_path / "ar4.xyz"
    inp.write_text(_AR4)
    args = [str(inp), "-ns", "4", *flags]
    rc_ref = ref_main.main(["optmain", *args, "-out", str(tmp_path / "ref"),
                            "-nosymm"])
    capsys.readouterr()
    rc = port_main.main(["optmain", *args, "-out", str(tmp_path / "port"),
                         "--device", "cpu"])
    assert rc == rc_ref
    ref = (tmp_path / "ref" / "optimized.xyz").read_text().splitlines()
    got = (tmp_path / "port" / "optimized.xyz").read_text().splitlines()
    e_ref, e_got = (float(x[1].split("=")[1]) for x in (ref, got))
    assert e_got == pytest.approx(e_ref, rel=0, abs=1e-10)
    np.testing.assert_allclose(
        np.array([ln.split()[1:] for ln in got[2:]], float),
        np.array([ln.split()[1:] for ln in ref[2:]], float), rtol=0,
        atol=1e-8)
    np.testing.assert_allclose(
        np.loadtxt(tmp_path / "port" / "energies.csv"),
        np.loadtxt(tmp_path / "ref" / "energies.csv"), rtol=0, atol=1e-10)


def _read_frames(path):
    from multioptpy_tpu_torch.io.xyz import read_trajectory

    _, frames, comments = read_trajectory(str(path))
    return frames, comments


_AR5_ANG = np.array([[0.0, 0.0, 0.0], [7.1, 0.0, 0.0], [3.55, 6.15, 0.0],
                     [3.55, 2.05, 5.8], [3.55, 2.05, -5.8]]) * _B2A
_NEB_CSVS = ("path_length.csv", "energy_plot.csv", "bias_force_rms.csv",
             "orthogonality.csv", "perp_rms_gradient.csv",
             "perp_max_gradient.csv")


def _ar5_pair(tmp_path):
    end = _AR5_ANG.copy()
    end[4] = np.array([3.55, -6.0, -3.0]) * _B2A
    for name, c in (("a.xyz", _AR5_ANG), ("b.xyz", end)):
        (tmp_path / name).write_text(
            "5\nAr5\n" + "".join(f"Ar {x:.12f} {y:.12f} {w:.12f}\n"
                                  for x, y, w in c))
    return str(tmp_path / "a.xyz"), str(tmp_path / "b.xyz")


def _compare_neb_outputs(ref_dir, got_dir, csvs=_NEB_CSVS):
    f_ref, c_ref = _read_frames(ref_dir / "neb_path.xyz")
    f_got, c_got = _read_frames(got_dir / "neb_path.xyz")
    np.testing.assert_allclose(f_got, f_ref, rtol=0, atol=1e-9)
    e_ref = np.array([float(c.split("=")[1]) for c in c_ref])
    e_got = np.array([float(c.split("=")[1]) for c in c_got])
    np.testing.assert_allclose(e_got, e_ref, rtol=0, atol=1e-10)
    for name in csvs:
        want = np.loadtxt(ref_dir / name, delimiter=",", ndmin=2)
        got = np.loadtxt(got_dir / name, delimiter=",", ndmin=2)
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=2e-10,
                                   err_msg=name)


_NEB_FLAG_SETS = [
    ["-lup", "-sdneb", "-k", "0.02", "-pitr", "-ad", "2"],
    ["-idpp", "-ci", "2", "3", "-adrpred", "2", "-cineb", "2", "-aconv"],
    ["-dmf", "-lbfgs", "-fe", "0", "-adsg", "3,5,2"],
    ["-qsmv2", "-afneb", "-nd", "0.4"],
    ["-cg", "dy", "-nebv", "ewbneb", "-adg", "3"],
]


@pytest.mark.parametrize("flags", _NEB_FLAG_SETS,
                         ids=[" ".join(f) for f in _NEB_FLAG_SETS])
def test_nebmain_matches_the_reference(flags, tmp_path, capsys):
    """6 iterations of an Ar5 band (LJ) under each flag set: the same band,
    energies and per-iteration CSVs as the JAX package's nebmain (1e-9
    Angstrom, 1e-10 Ha; the CSVs 1e-8 relative or 2e-10 absolute: qsm2's
    tangents, propagated image by image through 13 images, part the
    orthogonality by 4e-9 and the largest force by 9.4e-11 Ha/Bohr)."""
    a, b = _ar5_pair(tmp_path)
    args = [a, "-i2", b, "-nimg", "6", "-ns", "6", "-calc", "lj", *flags]
    assert ref_main.main(["nebmain", *args, "-out",
                          str(tmp_path / "ref")]) == 0
    ref_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_main.main(["nebmain", *args, "-out", str(tmp_path / "port"),
                           "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == ref_line
    _compare_neb_outputs(tmp_path / "ref", tmp_path / "port")


def test_nebmain_aneb_folder_and_trajectory_inputs(tmp_path, capsys):
    """-aneb writes the final energies only; a folder of *_N.xyz images and
    a trajectory are initial paths, as in the reference."""
    from multioptpy_tpu_torch.io.xyz import format_xyz

    a, b = _ar5_pair(tmp_path)
    args = [a, "-i2", b, "-nimg", "6", "-ns", "7", "-calc", "lj", "-aneb",
            "1", "3"]
    assert ref_main.main(["nebmain", *args, "-out",
                          str(tmp_path / "ref")]) == 0
    assert port_main.main(["nebmain", *args, "-out", str(tmp_path / "port"),
                           "--device", "cpu"]) == 0
    capsys.readouterr()
    _compare_neb_outputs(tmp_path / "ref", tmp_path / "port", csvs=())
    frames, _ = _read_frames(tmp_path / "ref" / "neb_path.xyz")
    d = tmp_path / "imgs"
    d.mkdir()
    traj = ""
    for i, f in enumerate(frames):
        (d / f"img_{i}.xyz").write_text(format_xyz(["Ar"] * 5, f))
        traj += format_xyz(["Ar"] * 5, f, f"frame {i}")
    (tmp_path / "traj.xyz").write_text(traj)
    for src in (str(d), str(tmp_path / "traj.xyz")):
        tag = "dir" if src == str(d) else "traj"
        args = [src, "-calc", "lj", "-ns", "3"]
        assert ref_main.main(["nebmain", *args, "-out",
                              str(tmp_path / f"r_{tag}")]) == 0
        assert port_main.main(["nebmain", *args, "-out",
                               str(tmp_path / f"p_{tag}"), "--device",
                               "cpu"]) == 0
        capsys.readouterr()
        _compare_neb_outputs(tmp_path / f"r_{tag}", tmp_path / f"p_{tag}")


def test_neb_job_is_what_nebmain_runs(tmp_path):
    """`cli.neb_job` turns nebmain's flags into the band run: the initial
    path on the flags' device, the NEBConfig and -aneb's keywords; the
    calculator of the flags takes the library's default band eigh."""
    from multioptpy_tpu_torch import cli

    a, b = _ar5_pair(tmp_path)
    args, symbols, path0, z, cfg, aneb_kw = cli.neb_job(
        [a, "-i2", b, "-nimg", "6", "-ns", "4", "-sqm2", "-ads", "2",
         "-aneb", "1", "3", "--device", "cpu"])
    assert symbols == ["Ar"] * 5 and list(z) == [18] * 5
    assert path0.shape == (6, 5, 3) and path0.device.type == "cpu"
    assert (cfg.n_steps, cfg.redistribute, cfg.redistribute_every) == (
        4, "spline", 2)
    assert aneb_kw == {"interpolation_num": 1, "frequency": 3}
    assert cli.neb_job([a, "-i2", b, "--device", "cpu"])[-1] is None
    assert cli._make_calculator(args).eigh_impl == "auto"


def test_nebmain_flags_outside_the_slice_exit_2(tmp_path, capsys):
    """nebmain parses the shared -fix and, as the reference, applies it to
    nothing (ROADMAP Queue 3, F10): `-fix 1` gives the band of the run
    without it, in both packages, and the port's band is the reference's.
    A flag of neither package (-freq) exits with status 2 in both."""
    a, b = _ar5_pair(tmp_path)
    args = [a, "-i2", b, "-nimg", "4", "-ns", "3", "-calc", "lj"]
    for main, tag, extra in ((ref_main.main, "ref", []),
                             (port_main.main, "port", ["--device", "cpu"])):
        for sub, flags in (("", []), ("_fix", ["-fix", "1"])):
            assert main(["nebmain", *args, *flags, *extra, "-out",
                         str(tmp_path / f"{tag}{sub}")]) == 0
        for name in ("neb_path.xyz", *_NEB_CSVS):
            assert (tmp_path / f"{tag}_fix" / name).read_text() == \
                (tmp_path / tag / name).read_text(), (tag, name)
        with pytest.raises(SystemExit) as exc:
            main(["nebmain", *args, "-freq", *extra])
        assert exc.value.code == 2
    capsys.readouterr()
    _compare_neb_outputs(tmp_path / "ref", tmp_path / "port")


def test_nebmain_spng_plots_or_raises_without_matplotlib(tmp_path, capsys,
                                                         monkeypatch):
    """-spng writes energy_profile.png beside energy_plot.csv; where
    matplotlib is absent (the card's machine) the plot raises the
    ImportError that names it, as the reference's does, after the band's
    files are written."""
    import sys

    a, b = _ar5_pair(tmp_path)
    args = [a, "-i2", b, "-nimg", "4", "-ns", "2", "-calc", "lj", "-spng",
            "--device", "cpu"]
    pytest.importorskip("matplotlib")
    assert port_main.main(["nebmain", *args, "-out",
                           str(tmp_path / "port")]) == 0
    png = (tmp_path / "port" / "energy_profile.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    for mod in [m for m in sys.modules if m.startswith("matplotlib")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        port_main.main(["nebmain", *args, "-out", str(tmp_path / "bare")])
    assert (tmp_path / "bare" / "neb_path.xyz").exists()
    capsys.readouterr()


@pytest.mark.parametrize("method", ["lqa", "euler", "rk4", "dvv", "hpc"])
def test_ircmain_matches_the_reference(method, tmp_path, capsys):
    """9 steps of each integrator from the Muller-Brown AB saddle: the same
    branches, energies and curvature CSVs (1e-9 Angstrom, 1e-10 Ha)."""
    from multioptpy_tpu_torch.calculators.model_surfaces import MB_TS_AB

    inp = tmp_path / "ts.xyz"
    inp.write_text(f"1\nts\nH {MB_TS_AB[0] * _B2A:.16f} "
                   f"{MB_TS_AB[1] * _B2A:.16f} 0.0\n")
    args = [str(inp), "-calc", "muller_brown", "-im", method, "-ns", "9"]
    assert ref_main.main(["ircmain", *args, "-out",
                          str(tmp_path / "ref")]) == 0
    ref_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_main.main(["ircmain", *args, "-out", str(tmp_path / "port"),
                           "--device", "cpu"]) == 0
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert got_line.replace("/port/", "/ref/") == ref_line
    ref_dir, got_dir = tmp_path / "ref", tmp_path / "port"
    e_ref = np.loadtxt(ref_dir / "irc_energies.csv")
    e_got = np.loadtxt(got_dir / "irc_energies.csv")
    # the imaginary mode's sign (each eigensolver's) may swap the branches
    swap = abs(e_got[0, 0] - e_ref[0, 0]) > 1e-9
    names = ("forward", "backward")
    if swap:
        e_got = e_got[:, ::-1]
    np.testing.assert_allclose(e_got, e_ref, rtol=0, atol=1e-10)
    for k, name in enumerate(names):
        other = names[1 - k] if swap else name
        f_ref, _ = _read_frames(ref_dir / f"irc_{name}.xyz")
        f_got, _ = _read_frames(got_dir / f"irc_{other}.xyz")
        np.testing.assert_allclose(f_got, f_ref, rtol=0, atol=1e-9)
        for csv in ("irc_curvature_properties", "path_bending_angle"):
            want = np.loadtxt(ref_dir / f"{csv}_{name}.csv", delimiter=",",
                              skiprows=1)
            got = np.loadtxt(got_dir / f"{csv}_{other}.csv", delimiter=",",
                             skiprows=1)
            np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=1e-8,
                                       atol=1e-9, err_msg=csv)


def test_bare_modelhess_runs_and_matches_the_reference(tmp_path, capsys):
    """`optmain -modelhess` means fischerd3old, as in the reference; 3 steps
    on H2O+ (SQM2) from that model Hessian give the reference's energies."""
    inp = tmp_path / "h2o.xyz"
    inp.write_text("3\nwater\nO 0.0 0.0 0.1173\nH 0.0 0.80 -0.4692\n"
                   "H 0.0 -0.7572 -0.45\n")
    args = [str(inp), "-calc", "sqm2", "-c", "1", "-m", "2", "-ns", "3",
            "-modelhess"]
    ref_main.main(["optmain", *args, "-out", str(tmp_path / "ref"),
                   "-nosymm"])
    capsys.readouterr()
    rc = port_main.main(["optmain", *args, "-out", str(tmp_path / "port"),
                         "--device", "cpu"])
    assert rc in (0, 1)
    np.testing.assert_allclose(
        np.loadtxt(tmp_path / "port" / "energies.csv"),
        np.loadtxt(tmp_path / "ref" / "energies.csv"), rtol=1e-10)


def test_run_autots_v1_config_with_idpp_and_spline_runs(tmp_path, capsys):
    """A v1 config asking for an IDPP initial path and a spline
    redistribution every 3 iterations runs and writes the reference's TS."""
    args = _mb_inputs(tmp_path)[:-2]
    (tmp_path / "v1.json").write_text(json.dumps({
        "top_n_candidates": 1,
        "step2_settings": {"use_image_dependent_pair_potential": True,
                           "align_distances_spline": 3, "NSTEP": 30},
        "step4_settings": {"intrinsic_reaction_coordinates": ["0.1", "6",
                                                              "euler"]}}))
    args += ["-cfg", str(tmp_path / "v1.json")]
    assert ref_main.main(["run_autots", *args, "-out",
                          str(tmp_path / "ref")]) == 0
    ref_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_main.main(["run_autots", *args, "-out",
                           str(tmp_path / "port"), "--device", "cpu"]) == 0
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert got_line.replace("/port/", "/ref/") == ref_line
    ref = (tmp_path / "ref" / "ts.xyz").read_text().splitlines()
    got = (tmp_path / "port" / "ts.xyz").read_text().splitlines()
    assert got[:2] == ref[:2]
    np.testing.assert_allclose(np.array(got[2].split()[1:], float),
                               np.array(ref[2].split()[1:], float), rtol=0,
                               atol=1e-8)


@pytest.mark.cuda
def test_nebmain_three_iterations_on_the_card(tmp_path, capsys):
    """3 nebmain iterations of the Ar5 band on the card match the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 through chip_smoke)")
    a, b = _ar5_pair(tmp_path)
    args = [a, "-i2", b, "-nimg", "6", "-ns", "3", "-calc", "lj"]
    assert port_main.main(["nebmain", *args, "-out",
                           str(tmp_path / "cpu"), "--device", "cpu"]) == 0
    assert port_main.main(["nebmain", *args, "-out",
                           str(tmp_path / "card")]) == 0
    capsys.readouterr()
    _compare_neb_outputs(tmp_path / "cpu", tmp_path / "card")



_AR4_ANG = ("4\nAr4\nAr 0.0 0.0 0.0\nAr 3.76 0.05 0.0\n"
            "Ar 1.88 3.26 0.1\nAr 1.88 1.09 3.07\n")


def _both_cli(cmd, args, tmp_path, capsys, rc=0):
    """Run `cmd args` in both packages into tmp_path/ref and tmp_path/port;
    the last stdout lines must agree."""
    assert ref_main.main([cmd, *args, "-out", str(tmp_path / "ref")]) == rc
    ref_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_main.main([cmd, *args, "-out", str(tmp_path / "port"),
                           "--device", "cpu"]) == rc
    out = capsys.readouterr().out.strip().splitlines()
    return ref_line, out


def _same_frames(tmp_path, name, atol=1e-8):
    f_ref, c_ref = _read_frames(tmp_path / "ref" / name)
    f_got, c_got = _read_frames(tmp_path / "port" / name)
    assert f_got.shape == f_ref.shape
    np.testing.assert_allclose(f_got, f_ref, rtol=0, atol=atol)
    e_ref = np.array([float(c.split("=")[-1]) for c in c_ref])
    e_got = np.array([float(c.split("=")[-1]) for c in c_got])
    np.testing.assert_allclose(e_got, e_ref, rtol=0, atol=1e-10)


def test_confsearch_writes_the_reference_conformers(tmp_path, capsys):
    inp = tmp_path / "ar4.xyz"
    inp.write_text(_AR4_ANG)
    ref_line, out = _both_cli("confsearch", [str(inp), "-ms", "2", "-bsize",
                                             "4", "-bf", "60", "-nost"],
                              tmp_path, capsys)
    assert out[-2].replace("/port/", "/ref/") == ref_line
    assert out[-1] == "rejected: 0 for bond connectivity, 0 non-finite"
    _same_frames(tmp_path, "conformers.xyz")
    np.testing.assert_allclose(
        np.loadtxt(tmp_path / "port" / "EQ_energy.csv", ndmin=1),
        np.loadtxt(tmp_path / "ref" / "EQ_energy.csv", ndmin=1), rtol=0,
        atol=1e-10)


@pytest.mark.parametrize("flags,profile", [
    (["-sa", "1,2", "-sr", "3.6,4.0,3"], "scan_profile.csv"),
    (["-scan", "bond", "1,2", "3.6,4.0", "angle", "1,2,3", "55,62",
      "-nsample", "3", "-fo"], "energy_profile.csv"),
], ids=["-sa -sr", "-scan -fo"])
def test_relaxedscan_writes_the_reference_profile(flags, profile, tmp_path,
                                                  capsys):
    inp = tmp_path / "ar4.xyz"
    inp.write_text(_AR4_ANG)
    ref_line, out = _both_cli("relaxedscan", [str(inp), "-ns", "20", *flags],
                              tmp_path, capsys)
    assert out[-1].replace("/port/", "/ref/") == ref_line
    _same_frames(tmp_path, "scan.xyz")
    delim = "," if profile == "energy_profile.csv" else None
    np.testing.assert_allclose(
        np.loadtxt(tmp_path / "port" / profile, delimiter=delim),
        np.loadtxt(tmp_path / "ref" / profile, delimiter=delim), rtol=0,
        atol=1e-10)
    assert (tmp_path / "port" / profile).read_text().splitlines()[0] == \
        (tmp_path / "ref" / profile).read_text().splitlines()[0]


def test_orientsearch_writes_the_reference_orientations(tmp_path, capsys):
    """The 100-step batched relaxation amplifies rounding: the geometries
    are held to 1e-8 Angstrom or to ten times how far the port's own
    output moves when the input is moved by 1e-13 Angstrom (the witness),
    if that is larger; the witness must stay within 1e-6 Angstrom."""
    inp = tmp_path / "ar4.xyz"
    inp.write_text(_AR4_ANG)
    flags = ["-part", "3,4", "-nsample", "4", "-dist", "4.5"]
    ref_line, out = _both_cli("orientsearch", [str(inp), *flags], tmp_path,
                              capsys)
    assert out[-1].replace("/port/", "/ref/") == ref_line
    lines = _AR4_ANG.splitlines()
    noise = np.random.default_rng(0).standard_normal((4, 3)) * 1e-13
    moved = lines[:2] + [
        "Ar " + " ".join(f"{float(v) + d:.17f}" for v, d in
                         zip(ln.split()[1:], dn))
        for ln, dn in zip(lines[2:], noise)]
    (tmp_path / "moved.xyz").write_text("\n".join(moved) + "\n")
    assert port_main.main(["orientsearch", str(tmp_path / "moved.xyz"),
                           *flags, "-out", str(tmp_path / "witness"),
                           "--device", "cpu"]) == 0
    capsys.readouterr()
    f_port, _ = _read_frames(tmp_path / "port" / "orientations.xyz")
    f_wit, _ = _read_frames(tmp_path / "witness" / "orientations.xyz")
    witness = np.abs(f_wit - f_port).max()
    assert witness <= 1e-6
    _same_frames(tmp_path, "orientations.xyz", atol=max(1e-8, 10 * witness))


def test_run_mapper_writes_the_reference_network(tmp_path, capsys):
    inp = tmp_path / "ar3.xyz"
    inp.write_text("3\nAr3\nAr 0.0 0.0 0.0\nAr 3.757 0.0 0.0\n"
                   "Ar 1.879 3.382 0.0\n")
    (tmp_path / "map.json").write_text(json.dumps({
        "mapper_settings": {"max_iterations": 1, "afir_gamma_kJmol": 30.0,
                            "dist_lower_ang": 0.5, "dist_upper_ang": 9.0},
        "step1_settings": {"NSTEP": 20},
        "step2_settings": {"NSTEP": 8},
        "step3_settings": {"NSTEP": 10},
        "step4_settings": {"intrinsic_reaction_coordinates": ["0.1", "6",
                                                              "lqa"],
                           "NSTEP": 10}}))
    args = [str(inp), "-cfg", str(tmp_path / "map.json"), "-maxnodes", "3"]
    ref_line, out = _both_cli("run_mapper", args, tmp_path, capsys)
    assert out[-2].replace("/port/", "/ref/") == ref_line
    assert out[-1] == "skipped tasks: 0 {}"
    want = json.loads((tmp_path / "ref" / "network.json").read_text())
    got = json.loads((tmp_path / "port" / "network.json").read_text())
    assert got["symbols"] == want["symbols"]
    assert len(got["nodes"]) == len(want["nodes"])
    assert len(got["edges"]) == len(want["edges"])
    for g, w in zip(got["nodes"], want["nodes"]):
        assert abs(g["energy"] - w["energy"]) <= 1e-10
        np.testing.assert_allclose(g["coords"], w["coords"], rtol=0,
                                   atol=1e-8)
    # --resume reads the persisted network back
    assert port_main.main(["run_mapper", *args, "-out",
                           str(tmp_path / "port"), "--resume", "--device",
                           "cpu", "--max_iter", "0"]) == 0
    assert capsys.readouterr().out.splitlines()[-2].startswith(
        f"network: {len(got['nodes'])} EQ nodes")


def test_run_autots_v2_workflow_writes_the_reference_report(tmp_path,
                                                            capsys):
    args = _mb_inputs(tmp_path)[:-2]
    (tmp_path / "v2.json").write_text(json.dumps({
        "workflow": [{"step": "neb", "settings_key": "neb_settings"},
                     {"step": "saddle"}, {"step": "freq"},
                     {"step": "irc", "settings_key": "irc_settings"}],
        "neb_settings": {"n_images": 10, "nsteps": 120, "k_spring": 5e-4,
                         "climbing_start": 30, "from_path": False},
        "irc_settings": {"nsteps": 40, "step_size": 0.05}}))
    ref_line, out = _both_cli("run_autots",
                              [*args, "-cfg", str(tmp_path / "v2.json")],
                              tmp_path, capsys)
    assert out[-1].replace("/port/", "/ref/") == ref_line
    want = json.loads((tmp_path / "ref" / "workflow_report.json").read_text())
    got = json.loads((tmp_path / "port" / "workflow_report.json").read_text())
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, float):
                assert abs(g[k] - v) <= 1e-10, k
            else:
                assert g[k] == v, k
    assert got[2]["n_imaginary"] == 1
    ref = (tmp_path / "ref" / "ts.xyz").read_text().splitlines()
    got_ts = (tmp_path / "port" / "ts.xyz").read_text().splitlines()
    assert got_ts[:2] == ref[:2]
    np.testing.assert_allclose(np.array(got_ts[2].split()[1:], float),
                               np.array(ref[2].split()[1:], float), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("cmd", ["confsearch", "relaxedscan",
                                 "orientsearch", "run_mapper"])
def test_workflow_commands_default_to_the_card(cmd, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    inp = tmp_path / "ar4.xyz"
    inp.write_text(_AR4_ANG)
    extra = {"relaxedscan": ["-sa", "1,2", "-sr", "3.6,4.0,2"],
             "orientsearch": ["-part", "3,4"]}.get(cmd, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main.main([cmd, str(inp), *extra])


@pytest.mark.parametrize("n", [1, 8, 32])
def test_alkane_chain_matches_the_reference_fixture(n):
    from multioptpy_tpu.io.fixtures import alkane_chain as ref_chain
    from multioptpy_tpu_torch.io.fixtures import alkane_chain

    try:
        want = ref_chain(n)
    except Exception as exc:  # the reference's n = 1 (no C-C neighbor)
        with pytest.raises(type(exc)):
            alkane_chain(n)
        return
    got = alkane_chain(n)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape == (3 * n + 2, 3)


# ---- optmain's outputs and analyses -------------------------------------

_WATER_DISTORTED = ("3\nwater\nO 0.0 0.0 0.1173\nH 0.0 0.93 -0.52\n"
                    "H 0.0 -0.70 -0.40\n")
_SLICE_FLAGS = ["-sqm2", "-c", "1", "-m", "2", "-freq", "-gi", "bond", "1,2",
                "angle", "2,1,3", "-cmds", "-pca", "-km", "-kp", "0.5",
                "1.0", "1,2"]


def _optmain_slice(tmp):
    """The water cation (F1-free) through both packages' optmain with
    -freq, -gi, -cmds, -pca, -km and a -kp bias: (ref dir, port dir, ref
    stdout, port stdout)."""
    import contextlib
    import io

    inp = tmp / "w.xyz"
    inp.write_text(_WATER_DISTORTED)
    outs = []
    for main, tag, extra in ((ref_main.main, "ref", []),
                             (port_main.main, "port", ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["optmain", str(inp), *_SLICE_FLAGS, "-out",
                         str(tmp / tag), *extra]) == 0
        outs.append(buf.getvalue())
    return tmp / "ref", tmp / "port", outs[0], outs[1]


def _table(path, **kw):
    return np.loadtxt(path, ndmin=2, **kw)


def test_optmain_writes_every_reference_file(tmp_path):
    """One run of each package (the reference's -freq costs half a minute
    of compiles, so one test holds all of it).

    The files: the same names and headers; energies, gradients and steps
    to 1e-10 relative (run_log.csv, energies.csv, bias_param_grads.csv,
    geometry_params.csv, thermochemistry.txt), the input record equal but
    for the input's path.

    The analyses: -freq's frequencies above 10 cm^-1 to 1e-6 cm^-1 (from
    Hessians of geometries 1e-12 Bohr apart), normal_modes.txt and the
    animations after flipping each port mode to the reference's sign
    (half a unit of the last printed digit); -cmds/-pca up to a sign per
    axis (1e-8); -km's spectrum (1e-6: the delay embedding of an energy
    series that converges is ill-conditioned) and verdict; the printed
    thermochemistry, imaginary-mode count and point group."""
    ref, port, out_ref, out_port = _optmain_slice(tmp_path)
    names = lambda d: sorted(p.relative_to(d).as_posix()  # noqa: E731
                             for p in d.rglob("*"))
    assert names(port) == names(ref)
    for name in ("run_log.csv", "energies.csv", "bias_param_grads.csv",
                 "geometry_params.csv", "frequencies_cm1.csv",
                 "cmds_path.csv", "pca_path.csv"):
        assert (port / name).read_text().splitlines()[0] == \
            (ref / name).read_text().splitlines()[0], name
    for name, kw in (("run_log.csv", dict(delimiter=",", skiprows=1)),
                     ("energies.csv", {}), ("bias_param_grads.csv", {}),
                     ("geometry_params.csv", dict(delimiter=","))):
        a, b = _table(ref / name, **kw), _table(port / name, **kw)
        assert a.shape == b.shape and len(a) >= 5, name
        np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-13,
                                   err_msg=name)
    got = json.loads((port / "input.json").read_text())
    want = json.loads((ref / "input.json").read_text())
    assert got.pop("input").endswith("w.xyz")
    want.pop("input")
    assert got == want
    for la, lb in zip((ref / "thermochemistry.txt").read_text().split("\n"),
                      (port / "thermochemistry.txt").read_text().split("\n")):
        if la:
            ka, va = la.split(": ")
            kb, vb = lb.split(": ")
            tol = 1e-12 if ka == "entropy" else 1e-10
            assert kb == ka and abs(float(vb) - float(va)) <= tol, ka

    fa = np.loadtxt(ref / "frequencies_cm1.csv")
    fb = np.loadtxt(port / "frequencies_cm1.csv")
    vib = np.abs(fa) > 10.0
    np.testing.assert_array_equal(np.abs(fb) > 10.0, vib)
    np.testing.assert_allclose(fb[vib], fa[vib], rtol=0, atol=1e-6)

    def modes(text):
        return [ln.split() for ln in text.splitlines()]

    a = modes((ref / "normal_modes.txt").read_text())
    b = modes((port / "normal_modes.txt").read_text())
    assert [r[:1] for r in a] == [r[:1] for r in b]
    disp_a = np.array([[float(v) for v in r[1:]] for r in a
                       if r and len(r[0]) <= 2 and r[0].isalpha()])
    disp_b = np.array([[float(v) for v in r[1:]] for r in b
                       if r and len(r[0]) <= 2 and r[0].isalpha()])
    sign = np.sign(np.sum(disp_a * disp_b, axis=0))
    sign = np.repeat(np.sign(sign.reshape(-1, 3).sum(1)), 3)
    np.testing.assert_allclose(disp_b * sign, disp_a, rtol=0, atol=5.01e-5)
    anims = sorted((ref / "vibration_animation").iterdir())
    assert [p.name for p in anims] == sorted(
        p.name for p in (port / "vibration_animation").iterdir())
    for pa in anims:
        la = pa.read_text().splitlines()
        lb = (port / "vibration_animation" / pa.name).read_text() \
            .splitlines()
        assert [x for x in la if x.startswith("Mode")] == \
            [x for x in lb if x.startswith("Mode")]
        xa = np.array([[float(v) for v in x.split()[1:]] for x in la
                       if len(x.split()) == 4])
        xb = np.array([[float(v) for v in x.split()[1:]] for x in lb
                       if len(x.split()) == 4])
        eq = np.abs(xb - xa).max() <= 5.01e-7
        # an opposite sign mirrors each frame through the geometry
        assert eq or np.abs(xb - xa).max() < 0.5, pa.name
    for name in ("cmds_path.csv", "pca_path.csv"):
        a, b = np.loadtxt(ref / name), np.loadtxt(port / name)
        s = np.sign(np.sum(a * b, axis=0))
        np.testing.assert_allclose(b * s, a, rtol=0, atol=1e-8, err_msg=name)

    def koopman(text):
        import re
        nums = re.findall(r"[-+]?\d+\.\d*(?:e[-+]?\d+)?[-+]\d+\.\d*"
                          r"(?:e[-+]?\d+)?j|[-+]?\d+\.\d*(?:e[-+]?\d+)?",
                          text.split("decay_rates")[0])
        return (np.sort_complex(np.array([complex(n) for n in nums])),
                "converging=True" in text)

    ka, ca = koopman((ref / "koopman.txt").read_text())
    kb, cb = koopman((port / "koopman.txt").read_text())
    assert ca == cb and len(ka) == len(kb) == 4
    np.testing.assert_allclose(kb, ka, rtol=0, atol=1e-6)

    def lines(out, *keys):
        return [ln for ln in out.splitlines() if ln.strip().startswith(keys)]

    assert lines(out_port, "point group", "imaginary modes") == \
        lines(out_ref, "point group", "imaginary modes")
    assert "point group: SymmetryResult(point_group='C2v'" in out_port
    for la, lb in zip(lines(out_ref, "zpe", "enthalpy", "gibbs"),
                      lines(out_port, "zpe", "enthalpy", "gibbs")):
        assert abs(float(la.split()[-1]) - float(lb.split()[-1])) <= 1e-10


_CU4 = ("4\nCu4\nCu 0.0 0.0 0.0\nCu 2.6 0.1 0.0\nCu 1.2 2.3 0.1\n"
        "Cu 1.3 0.8 2.2\n")
_WRAPPER_FLAGS = [
    ["-calc", "emt", "-oniom", "1,2", "lj"],
    ["-calc", "emt", "-oniom", "1,2", "lj", "-mi", "2"],
    ["-calc", "emt", "-mf", "seam", "1", "2"],
    ["-calc", "emt", "-of", "1,2", "3,4", "-kp", "0.1", "2.5", "1,3"],
]


@pytest.mark.parametrize("flags", _WRAPPER_FLAGS,
                         ids=[" ".join(f) for f in _WRAPPER_FLAGS])
def test_optmain_calculator_wrappers_match_the_reference(flags, tmp_path,
                                                         capsys):
    """-oniom (EMT high layer, LJ low; with -mi microiterations), -mf (a
    seam between two states of one backend) and -of (fragment-averaged
    gradients, with a bias: bias_param_grads.csv) on a Cu4 cluster, 5
    RS-RFO steps from a Lindh model Hessian: the same geometry (1e-8 Angstrom), energies (1e-10 relative)
    and bias parameter gradients."""
    inp = tmp_path / "cu4.xyz"
    inp.write_text(_CU4)
    # a model Hessian start: a composite's exact Hessian is seminumerical
    # in the port (ROADMAP Queue 3, D3)
    args = [str(inp), *flags, "-ns", "5", "-nosymm", "-mh", "lindh"]
    rc_ref = ref_main.main(["optmain", *args, "-out", str(tmp_path / "ref")])
    rc = port_main.main(["optmain", *args, "-out", str(tmp_path / "port"),
                         "--device", "cpu"])
    capsys.readouterr()
    assert rc == rc_ref
    for name in ("energies.csv", "bias_param_grads.csv"):
        if (tmp_path / "ref" / name).exists():
            np.testing.assert_allclose(
                np.loadtxt(tmp_path / "port" / name),
                np.loadtxt(tmp_path / "ref" / name), rtol=1e-10, atol=1e-14)
    got, want = (np.array([ln.split()[1:] for ln in
                           (tmp_path / d / "optimized.xyz").read_text()
                           .splitlines()[2:]], float)
                 for d in ("port", "ref"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)
    assert ("-kp" in flags) == (tmp_path / "port"
                                / "bias_param_grads.csv").exists()


def test_d2_symmetry_errors_are_narrowed(tmp_path, capsys, monkeypatch):
    """D2: a degenerate input's error (ValueError, numpy's LinAlgError) is
    reported and the run goes on; any other error of the point-group
    analysis propagates, where the reference skips every exception."""
    from multioptpy_tpu_torch.analysis import symmetry

    inp = tmp_path / "ar4.xyz"
    inp.write_text(_AR4)
    args = ["optmain", str(inp), "-ns", "1", "--device", "cpu"]
    for exc in (ValueError("coincident atoms"),
                np.linalg.LinAlgError("eigh")):
        monkeypatch.setattr(symmetry, "analyze_symmetry",
                            lambda c, z, e=exc: (_ for _ in ()).throw(e))
        port_main.main(args + ["-out", str(tmp_path / "a")])
        assert "symmetry analysis skipped: " in capsys.readouterr().out
    monkeypatch.setattr(symmetry, "analyze_symmetry",
                        lambda c, z: (_ for _ in ()).throw(
                            RuntimeError("CUDA error: an illegal access")))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main.main(args + ["-out", str(tmp_path / "b")])


def test_f8_optmain_parses_pbc_and_applies_none(tmp_path, capsys):
    """F8: the reference's optmain accepts -pbc a b c and applies it to
    nothing; so does the port (the same result with and without it)."""
    inp = tmp_path / "ar4.xyz"
    inp.write_text(_AR4)
    for tag, extra in (("plain", []), ("pbc", ["-pbc", "5", "5", "5"])):
        port_main.main(["optmain", str(inp), "-ns", "3", "-nosymm", *extra,
                        "-out", str(tmp_path / tag), "--device", "cpu"])
    capsys.readouterr()
    assert (tmp_path / "pbc" / "optimized.xyz").read_text() == \
        (tmp_path / "plain" / "optimized.xyz").read_text()
