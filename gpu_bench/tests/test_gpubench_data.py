"""The data files: BENCHMARK.json against the benchmark's contract, each
configuration, and each traffic mix's determinism from its seed."""

import json
import re

import numpy as np
import pytest

from gpu_bench import check, generate, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def spec(root):
    return json.loads((root / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_keeps_the_contract(spec, root):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (root / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(spec["paths"]) <= 16 and len(spec["command"]) <= 32
    assert all(_line(w) for w in spec["command"])
    assert 1 <= spec["run_seconds"] <= 51
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(spec["paths"][0] + "/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    used, pairs = set(), set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        assert (root / spec["paths"][0] / "traffic"
                / f"{w['traffic']}.json").exists()
    assert used == names
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m["workloads"]) <= set(
            e2e[m["moves"]].get("workloads", cells))
        run.reader(root, spec, m["name"])      # every metric has a reader
    for cell in cells:
        reported = {m["name"] for m in run.cell_metrics(
            spec, {"name": cell}, False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert run.cell_metrics(spec, {"name": cell}, True)


def test_configs_load(spec, root):
    for c in spec["configs"]:
        cfg = json.loads((root / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert set(cfg["reduced"]) <= set(cfg["source_values"])
        x, z = generate.base_geometry(cfg)
        assert x.shape == (len(z), 3) and cfg["band_order"] == 4 * len(z)
        assert set(z) <= set(range(1, 11))
        assert set(cfg["limits"]) == {"energy_gap", "gradient_gap",
                                      "hessian_gap", "step_gap"}
        from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig
        OptimizeConfig(**cfg["optimizer"])
        calc_ref, method = check.references(cfg)
        assert callable(calc_ref.model) and callable(method.job_gaps)


def _mix(root, name):
    return json.loads((root / "gpu_bench" / "traffic"
                       / f"{name}.json").read_text())


@pytest.mark.parametrize("cell", ["da.opt1", "octane.conf16", "octane.opt1",
                                  "da.orient16"])
def test_each_mix_is_deterministic_from_its_seed(root, cell):
    _, _, cfg, mix = run.load_cell(root, cell)
    a = generate.Traffic(cfg, mix, 2 ** 31 + 11)
    b = generate.Traffic(cfg, mix, 2 ** 31 + 11)
    c = generate.Traffic(cfg, mix, 5)
    for j in (0, 1, 17, -1):
        np.testing.assert_array_equal(a.job(j), b.job(j))
        assert not np.allclose(a.job(j), c.job(j)) or j < 0
    np.testing.assert_array_equal(a.job(-1), c.job(-1))   # warm-up


def _dists(x):
    return np.linalg.norm(x[..., :, None, :] - x[..., None, :, :], axis=-1)


def test_single_jobs_are_the_same_work_under_every_seed(root):
    _, _, cfg, mix = run.load_cell(root, "da.opt1")
    a = generate.Traffic(cfg, mix, 1)
    b = generate.Traffic(cfg, mix, 3_000_000_000)
    for j in range(3):
        # the same start turned: every interatomic distance kept
        np.testing.assert_allclose(_dists(a.job(j)), _dists(b.job(j)),
                                   atol=1e-12)
    assert not np.allclose(_dists(a.job(0)), _dists(a.job(1)))


def test_orientations_keep_the_fragments_rigid_and_apart(root):
    _, _, cfg, mix = run.load_cell(root, "da.orient16")
    x, _ = generate.base_geometry(cfg)
    starts = generate.Traffic(cfg, mix, 99).job(0)
    assert starts.shape == (16,) + x.shape
    frag = np.asarray(cfg["mobile_fragment"]) - 1
    rest = np.setdiff1d(np.arange(len(x)), frag)
    for s in starts:
        np.testing.assert_array_equal(s[rest], x[rest])
        np.testing.assert_allclose(_dists(s[frag]), _dists(x[frag]),
                                   atol=1e-12)
