"""Port parity: `python -m multioptpy_tpu_torch` against the JAX package's
CLI: run_autots on Muller-Brown and optmain on H2O+ write the same files;
commands and flags outside the port exit with status 2 naming their
ROADMAP item; the device defaults to the card."""

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
    assert port_main.main(["nebmain", *args]) == 2
    assert "ROADMAP Queue 1 item" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        port_main.main(["run_autots", *args, "-freq", "--device", "cpu"])
    assert exc.value.code == 2
    assert "item 18" in capsys.readouterr().err
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
