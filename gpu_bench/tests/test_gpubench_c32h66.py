"""The configuration `c32h66_sqm2_f64` and its cell `c32h66.opt1`: the
molecule is `alkane_chain(32)` bit for bit, the cell reports its metrics,
its mix is deterministic from the seed, the eigensolver's route at the
cell's shapes, and the configuration end to end through `run.run_cell` on
the CPU with its molecule swapped for propane (the 98-atom job's 588
displaced gradients are the card's work). On a card, the cell's float32
control fails and the program passes."""

import json
import shutil

import numpy as np
import pytest
import torch

from gpu_bench import generate, run

CELL = "c32h66.opt1"
SEED = 2 ** 31 + 4321


def test_the_molecule_is_alkane_chain_32(root):
    from multioptpy_tpu_torch.io.fixtures import alkane_chain

    _, cell, cfg, _ = run.load_cell(root, CELL)
    assert cell["config"] == cfg["name"] == "c32h66_sqm2_f64"
    x, z = alkane_chain(32)
    xc, zc = generate.base_geometry(cfg)
    assert xc.dtype == x.dtype and np.array_equal(xc, x)
    assert np.array_equal(zc, z) and len(z) == 98
    assert cfg["band_order"] == 4 * len(z) == 392
    assert cfg["optimizer"]["nsteps"] == 60


def test_the_cell_reports_setup_and_step_ms(root):
    spec, cell, _, mix = run.load_cell(root, CELL)
    assert mix["kind"] == "optimize" and cell["chips"] == 1
    reported = {m["name"] for m in run.cell_metrics(spec, cell, False)}
    assert {"setup_s", "step_ms"} <= reported
    assert "struct_steps_per_s" not in reported
    traced = {m["name"] for m in run.cell_metrics(spec, cell, True)}
    assert traced == {"hessian_host_ms.large"} | {f"{s}.single" for s in (
        "launches_per_step", "calc_ms_per_step", "eigh_roofline",
        "device_idle_pct", "step_host_ms", "calc_host_ms", "eigh_host_ms",
        "host_syncs_per_step")}


def test_the_mix_is_deterministic_from_the_seed(root):
    _, _, cfg, mix = run.load_cell(root, CELL)
    a = generate.Traffic(cfg, mix, SEED)
    b = generate.Traffic(cfg, mix, SEED)
    c = generate.Traffic(cfg, mix, 7)
    for j in (0, 1, 16, -1):
        assert a.job(j).shape == (98, 3)
        np.testing.assert_array_equal(a.job(j), b.job(j))
        assert not np.allclose(a.job(j), c.job(j)) or j < 0
    np.testing.assert_array_equal(a.job(-1), c.job(-1))   # warm-up


@pytest.mark.parametrize("b, d, route", [
    (588, 392, "cusolver"),     # the exact Hessian's band and Loewdin
    (1, 392, "cusolver"),       # a step's band and Loewdin
    (1, 294, "cusolver"),       # the RS-RFO step
    (588, 99, "k1"),            # the exact Hessian's EEQ, padded to 100
    (1, 99, "cusolver"),        # a step's EEQ
])
def test_the_route_at_the_cells_shapes(b, d, route):
    from multioptpy_tpu_torch.ops.eigh64 import eigh_route

    assert eigh_route("cuda", torch.float64, d, b, False) == route


def _propane_root(root, tmp_path):
    """A copy of the benchmark in which the configuration's molecule is
    propane (its band order with it); nothing else changes."""
    from multioptpy_tpu_torch.io.fixtures import alkane_chain

    shutil.copytree(root / "gpu_bench", tmp_path / "gpu_bench",
                    ignore=shutil.ignore_patterns("tests", ".cache",
                                                  "__pycache__"))
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    path = tmp_path / "gpu_bench/configs/c32h66_sqm2_f64.json"
    cfg = json.loads(path.read_text())
    x, z = alkane_chain(3)
    cfg.update(band_order=4 * len(z),
               molecule={"name": "propane", "z": [int(v) for v in z],
                         "coords_bohr": x.tolist()})
    path.write_text(json.dumps(cfg))
    return tmp_path


def test_the_configuration_runs_on_the_cpu_with_propane(root, tmp_path):
    torch.set_num_threads(2)
    toy = _propane_root(root, tmp_path)
    result, lines = run.run_cell(toy, CELL, SEED, 0.01, 0, device="cpu")
    assert result["correct"] is True and result["failed"] == 0
    spec, cell, _, _ = run.load_cell(root, CELL)
    assert sorted(result["metrics"]) == sorted(
        m["name"] for m in run.cell_metrics(spec, cell, False))
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]
    assert lines[-1].startswith("check ")


@pytest.mark.cuda
def test_control_fails_and_the_program_passes(cuda_card, root):
    res, _ = run.run_cell(root, CELL, SEED, 0.5, 0)
    assert res["correct"] is True and res["failed"] == 0
    ctl, _ = run.run_cell(root, CELL, SEED, 0.5, 0, dtype=torch.float32)
    assert ctl["correct"] is False
    fails = [k for k, c in ctl["checks"].items() if c["value"] > c["limit"]]
    assert {"energy_gap", "gradient_gap"} <= set(fails)
