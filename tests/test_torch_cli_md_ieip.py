"""Port parity: `python -m multioptpy_tpu_torch mdmain` and `ieipmain`
against the JAX package's CLI, and the bias flags of the shared parser.

* The parsers, flag by flag: every option string of the reference's
  mdmain and ieipmain and every bias flag exists in the port with the
  same destination, arity and default, and the same argv parses to the
  same values.
* Every bias flag builds the same potentials with the same parameters, the
  whole set gives the same energy and gradient, and groups of the wrong
  size fail with the reference's message.
* mdmain on Ar4 (Lennard-Jones) with a thermostat, the -ct schedule, a
  SHAKE bond, a periodic box, bias flags, -ntraj 2, -cmds and -pca writes
  the same files (1e-10 Ha, 1e-9 Angstrom) from the same initial
  velocities, which the test hands to both packages in place of their
  generators' draws.
* ieipmain on Muller-Brown with each engine writes the same TS guess.
* nebmain -cfbenm relaxes the same initial band.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu import __main__ as ref_main
from multioptpy_tpu import cli as ref_cli
from multioptpy_tpu.drivers import md as ref_md
from multioptpy_tpu_torch import __main__ as port_main
from multioptpy_tpu_torch import cli
from multioptpy_tpu_torch.calculators.model_surfaces import MB_MIN_A, MB_MIN_C
from multioptpy_tpu_torch.drivers import md

torch.set_num_threads(1)

_B2A = 0.52917721067
_AR4 = ("4\nAr4\nAr 1.05 1.1 1.5\nAr 1.2 -1.6 -0.9\nAr -1.7 1.4 -1.2\n"
        "Ar -1.3 -1.2 1.1\n")
_MOL = ("6\nmol\nC 0.0 0.0 0.0\nO 1.22 0.1 -0.05\nN -0.2 1.32 0.16\n"
        "H -0.95 -0.48 0.64\nH 0.32 -0.58 -0.95\nC 1.64 1.38 0.74\n")

BIAS_FLAGS = ("-ma -kp -kpv2 -akp -ka -kav2 -kda -kdav2 -kdac -kopa -kopav2 "
              "-wp -wwp -awp -vpp -vpwp -rp -rpv2 -rpg -cp -fp -up -nrp "
              "-lmefp -lmefpv2 -esp -espap -brp -aerp -aerpv2 -smp "
              "-metad").split()

# one group of each bias flag for the 6-atom molecule above
_BIAS_ARGV = [
    "-ma", "150", "1,2", "4,5", "-kp", "0.5", "1.0", "1,2",
    "-kpv2", "0.3", "1.5", "1,2", "4,5", "-akp", "0.1", "0.4", "1.6", "2,3",
    "-ka", "0.2", "100", "1,2,3", "-kav2", "0.2", "80", "1", "2,3", "4,5",
    "-kda", "0.1", "30", "1,2,3,4", "-kdav2", "0.1", "-40", "1", "2", "3",
    "4,5", "-kdac", "0.05", "2", "20", "1", "2", "3,6", "4,5",
    "-kopa", "0.1", "10", "2,1,3,4", "-kopav2", "0.1", "-5", "2,6", "1",
    "3", "4,5", "-wp", "50", "1,2", "4,5", "0.3,0.6,0.8,1.0",
    "-wwp", "50", "x", "0.0,0.2,0.8,1.4", "1-6",
    "-awp", "50", "1", "0.4,0.8,1.0,1.3", "2-6",
    "-vpp", "0.3", "0.8", "0.5,0.5,0.5", "1,2", "4",
    "-vpwp", "50", "0.2,0.1,0.0", "0.3,0.6,1.0,1.3", "1-6",
    "-rp", "1.0", "0.8", "1,2", "4,5", "scale",
    "-rpv2", "1.0", "1.0", "1.0", "1.0", "1.0", "12", "6", "1,2", "3-6",
    "value", "-rpg", "5", "1.4", "3", "1.2", "1.0", "1,2", "4,5",
    "-cp", "5", "2.5", "60", "1", "2,3,4", "5,6",
    "-fp", "0.01,0.02,0.03", "2,2,4", "0.5,-0.5,1.0", "1,6",
    "-up", "10", "1-4", "-nrp", "0.6", "1.2", "100", "100", "0.01", "0.02",
    "-lmefp", "500", "1,2", "3,4", "-lmefpv2", "500", "1,4",
    "-esp", "1.0", "1,2", "4,5", "-espap", "0.5", "1,2,3,6",
    "-brp", "5", "4", "1.2", "0.9", "1,2", "4,5",
    "-aerp", "1.0", "1.5,1.2,1.4,1.1,1.3,1.0", "1.0", "1,2", "4",
    "-aerpv2", "0.8", "1.1,1.3,1.0,1.2,1.4,1.5", "1.2", "3,6", "none",
    "-smp", "1.0", "2.0", "1.5", "4", "1-6",
    "-metad", "bond", "5", "0.3", "1,2"]


class _Parsed(Exception):
    pass


def _parser_of(monkeypatch, run):
    """The ArgumentParser that `run` builds, caught at its parse call."""
    caught = {}

    def grab(self, *a, **k):
        caught["p"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        m.setattr(argparse.ArgumentParser, "parse_known_args", grab)
        with pytest.raises(_Parsed):
            run(["x.xyz"])
    return caught["p"]


def _options(parser):
    return {s: a for a in parser._actions for s in a.option_strings}


@pytest.mark.parametrize("command", ["mdmain", "ieipmain"])
def test_parsers_have_no_gap(command, monkeypatch):
    """Every flag the reference's command adds to its base parser, and
    every bias flag, is in the port's command with the same dest, nargs
    and default."""
    run_ref = getattr(ref_cli, f"run_{command}")
    run_got = getattr(cli, f"run_{command}")
    ref_opts = _options(_parser_of(monkeypatch, run_ref))
    got_opts = _options(_parser_of(monkeypatch, run_got))
    base = set(_options(ref_cli._base_parser("x")))
    own = [s for s in ref_opts if s not in base]
    wanted = own + BIAS_FLAGS + (["-beta"] if command == "ieipmain" else [])
    missing = [s for s in wanted if s not in got_opts]
    assert missing == []
    for s in wanted:
        r, g = ref_opts[s], got_opts[s]
        assert (g.dest, g.nargs, g.default, g.const) == (
            r.dest, r.nargs, r.default, r.const), s
        assert type(g) is type(r), s


def test_bias_flags_build_the_reference_potentials(tmp_path):
    inp = tmp_path / "mol.xyz"
    inp.write_text(_MOL)
    argv = [str(inp), *_BIAS_ARGV]
    ref_args = ref_cli._base_parser("x").parse_args(argv)
    args = cli._base_parser("x").parse_args(argv + ["--device", "cpu"])
    for flag in BIAS_FLAGS:
        dest = ref_cli._base_parser("x")._option_string_actions[flag].dest
        assert getattr(args, dest) == getattr(ref_args, dest), flag
    _, coords, z = cli._load_system(args)
    ref = ref_cli._make_bias(ref_args, jnp.asarray(z))
    got = cli._make_bias(args, z)
    assert [p.name for p in got.potentials] == [p.name
                                                for p in ref.potentials]
    assert len(got) == len(BIAS_FLAGS)
    for p, rp in zip(got.potentials, ref.potentials):
        np.testing.assert_array_equal(p.init_params(), rp.init_params())
    # energy and gradient of the whole set but the three relaxed models
    # (held one by one in test_torch_bias_potentials.py)
    keep = [i for i, p in enumerate(got.potentials)
            if p.name not in ("asym_ellipsoid", "spacer")]
    ref_sub = type(ref)([ref.potentials[i] for i in keep])
    got_sub = type(got)([got.potentials[i] for i in keep])
    e, g = got_sub.energy_and_gradient(coords[None])
    re, rg = jax.jit(ref_sub.energy_and_gradient)(
        jnp.asarray(coords.numpy()))
    assert e[0].item() == pytest.approx(float(re), rel=1e-10)
    np.testing.assert_allclose(g[0].numpy(), np.asarray(rg), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(rg)).max())


@pytest.mark.parametrize("bad", [
    ["-kpv2", "0.3", "1.5", "1,2"],
    ["-rpg", "5", "1.4", "3"],
    ["-aerp", "1.0", "1.5,1.2,1.4,1.1,1.3,1.0"],
    ["-smp", "1.0", "2.0"],
    ["-metad", "angle", "5", "0.3", "1,2"],
])
def test_bias_groups_of_the_wrong_size_fail_alike(bad, tmp_path):
    inp = tmp_path / "mol.xyz"
    inp.write_text(_MOL)
    z = np.array([6, 8, 7, 1, 1, 6])
    ref_args = ref_cli._base_parser("x").parse_args([str(inp), *bad])
    args = cli._base_parser("x").parse_args([str(inp), *bad])
    with pytest.raises(SystemExit) as want:
        ref_cli._make_bias(ref_args, jnp.asarray(z))
    with pytest.raises(SystemExit) as got:
        cli._make_bias(args, z)
    assert str(got.value) == str(want.value)


def _velocity_feed(monkeypatch, n_atoms=4):
    """Both packages' maxwell_boltzmann return the same numpy draws, in
    call order (one call per trajectory's first chunk)."""
    rng = np.random.default_rng(17)
    draws = [rng.standard_normal((n_atoms, 3)) for _ in range(4)]
    calls = {"ref": 0, "port": 0}

    def ref_mb(key, masses, temperature, dtype=jnp.float64):
        d = draws[calls["ref"]]
        calls["ref"] += 1
        sigma = np.sqrt(md.KB_HARTREE * temperature / np.asarray(masses))
        return jnp.asarray(sigma[:, None] * d, dtype)

    def port_mb(key, masses, temperature, dtype=torch.float64):
        d = draws[calls["port"]]
        calls["port"] += 1
        sigma = torch.sqrt(md.KB_HARTREE * temperature / masses)[:, None]
        return sigma * torch.as_tensor(d, dtype=dtype, device=masses.device)

    monkeypatch.setattr(ref_md, "maxwell_boltzmann", ref_mb)
    monkeypatch.setattr(md, "maxwell_boltzmann", port_mb)


def _xyz_frames(path):
    lines = path.read_text().splitlines()
    n = int(lines[0])
    out = []
    for k in range(0, len(lines), n + 2):
        out.append([[float(v) for v in ln.split()[1:]]
                    for ln in lines[k + 2:k + 2 + n]])
    return np.asarray(out)


def test_mdmain_writes_the_reference_trajectories(tmp_path, capsys,
                                                  monkeypatch):
    _velocity_feed(monkeypatch)
    inp = tmp_path / "ar4.xyz"
    inp.write_text(_AR4)
    args = [str(inp), "-calc", "lj", "-time", "12", "-dt", "2.0",
            "-thermo", "nosehooverchain", "-temp", "60", "-ct", "6", "150",
            "-cc", "3.0", "1,2", "-pbc", "30", "30", "30",
            "-kp", "0.05", "3.2", "3,4", "-metad", "bond", "2", "0.2", "1,3",
            "-ntraj", "2", "-cmds", "-pca"]
    assert ref_main.main(["mdmain", *args, "-out",
                          str(tmp_path / "ref")]) == 0
    ref_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_main.main(["mdmain", *args, "-out", str(tmp_path / "port"),
                           "--device", "cpu"]) == 0
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert got_line.replace("/port/", "/ref/") == ref_line
    for k in range(2):
        e_ref = np.loadtxt(tmp_path / "ref" / f"md_energies_{k}.csv")
        e_got = np.loadtxt(tmp_path / "port" / f"md_energies_{k}.csv")
        assert e_got.shape == e_ref.shape == (12, 2)
        np.testing.assert_allclose(e_got[:, 0], e_ref[:, 0], rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(e_got[:, 1], e_ref[:, 1], rtol=1e-9)
        np.testing.assert_allclose(
            _xyz_frames(tmp_path / "port" / f"md_traj_{k}.xyz"),
            _xyz_frames(tmp_path / "ref" / f"md_traj_{k}.xyz"), rtol=0,
            atol=1e-9)
    for name in ("cmds_traj.csv", "pca_traj.csv"):
        a = np.loadtxt(tmp_path / "port" / name)
        b = np.loadtxt(tmp_path / "ref" / name)
        np.testing.assert_allclose(np.abs(a), np.abs(b), rtol=0, atol=1e-8)


def _mb_pair(tmp_path):
    for name, (x, y) in (("mb_A.xyz", MB_MIN_A), ("mb_B.xyz", MB_MIN_C)):
        (tmp_path / name).write_text(
            f"1\nmb\nH {x * _B2A:.16f} {y * _B2A:.16f} 0.0\n")
    return str(tmp_path / "mb")


@pytest.mark.parametrize("engine", [
    ["-em", "eip", "-ns", "40"],
    ["-use_spm", "-ns", "40", "-beta", "1.5"],
    ["-use_dimer", "-dimer_maxiter", "30", "-dimer_sep", "0.01"],
    ["-gnt", "-gnt_step", "0.1", "-gnt_mi", "10"],
    ["-2pshs", "-2pshs_step", "0.15", "-2pshs_num", "20"],
    ["-addf", "-addf_nadd", "2", "-addf_num", "10", "-addf_step", "0.2"],
], ids=["eip", "spm-beta", "dimer", "gnt", "2pshs", "addf"])
def test_ieipmain_writes_the_reference_ts_guess(engine, tmp_path, capsys):
    """The *_A.xyz / *_B.xyz pair found from a prefix, as in the
    reference; the same TS guess (1e-9 Angstrom) and energy line."""
    prefix = _mb_pair(tmp_path)
    args = [prefix, "-calc", "muller_brown", *engine]
    assert ref_main.main(["ieipmain", *args, "-out",
                          str(tmp_path / "ref")]) == 0
    ref_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_main.main(["ieipmain", *args, "-out",
                           str(tmp_path / "port"), "--device", "cpu"]) == 0
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert got_line.replace("/port/", "/ref/") == ref_line
    ref = (tmp_path / "ref" / "ts_guess.xyz").read_text().splitlines()
    got = (tmp_path / "port" / "ts_guess.xyz").read_text().splitlines()
    assert got[1] == ref[1]
    np.testing.assert_allclose(np.array(got[2].split()[1:], float),
                               np.array(ref[2].split()[1:], float), rtol=0,
                               atol=1e-9)


def test_nebmain_cfbenm_relaxes_the_reference_band(tmp_path, capsys):
    a, b = tmp_path / "a.xyz", tmp_path / "b.xyz"
    a.write_text(_AR4)
    b.write_text(_AR4.replace("Ar -1.3 -1.2 1.1", "Ar 1.6 1.9 -1.4"))
    args = [str(a), "-i2", str(b), "-nimg", "5", "-ns", "2", "-calc", "lj",
            "-cfbenm"]
    assert ref_main.main(["nebmain", *args, "-out",
                          str(tmp_path / "ref")]) == 0
    assert port_main.main(["nebmain", *args, "-out", str(tmp_path / "port"),
                           "--device", "cpu"]) == 0
    capsys.readouterr()
    np.testing.assert_allclose(
        _xyz_frames(tmp_path / "port" / "neb_path.xyz"),
        _xyz_frames(tmp_path / "ref" / "neb_path.xyz"), rtol=0, atol=1e-9)


@pytest.mark.parametrize("command", ["mdmain", "ieipmain"])
def test_new_commands_default_to_the_card(command, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    prefix = _mb_pair(tmp_path)
    pair = ["-i2", prefix + "_B.xyz"] if command == "ieipmain" else []
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main.main([command, prefix + "_A.xyz", *pair, "-calc",
                        "muller_brown"])


def test_f7_ieipmain_parses_bias_flags_and_applies_none(tmp_path, capsys):
    """ROADMAP F7: in both packages ieipmain's shared parser takes the bias
    flags, and the command passes no bias to its engines, so a void-point
    well changes nothing."""
    prefix = _mb_pair(tmp_path)
    args = [prefix, "-calc", "muller_brown", "-em", "eip", "-ns", "20"]
    well = ["-vpp", "0.5", "0.3", "0,0,0", "1", "2"]
    lines = []
    for main, tag, extra in ((ref_main.main, "ref", []),
                             (port_main.main, "port", ["--device", "cpu"])):
        for k, bias in enumerate(([], well)):
            out = tmp_path / f"{tag}{k}"
            assert main(["ieipmain", *args, *bias, "-out", str(out),
                         *extra]) == 0
            lines.append((out / "ts_guess.xyz").read_text().splitlines()[1:])
    capsys.readouterr()
    assert lines[0] == lines[1] == lines[2] == lines[3]
