"""The harness end to end on the CPU, at a toy size: a configuration,
traffic mixes, a traffic kind and a reference added as new files run with
no edit to a file that is there,
the result line keeps its schema, each planted fault turns `correct`
false, and nothing imports JAX or the JAX package."""

import ast
import importlib
import json
import shutil
import subprocess
import sys

import pytest
import torch

from gpu_bench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "multioptpy_tpu"}


def _toy_root(root, tmp_path):
    """A copy of BENCHMARK.json and the benchmark's data, plus a toy
    configuration (ethane) and two toy mixes as new files, and their cells
    as new entries."""
    shutil.copytree(root / "gpu_bench", tmp_path / "gpu_bench",
                    ignore=shutil.ignore_patterns("tests", ".cache",
                                                  "__pycache__"))
    base = json.loads((root / "gpu_bench/configs/da_sqm2_f64.json")
                      .read_text())
    from multioptpy_tpu_torch.io.fixtures import alkane_chain
    x, z = alkane_chain(2)
    toy = dict(base, name="toy_ethane", band_order=4 * len(z),
               optimizer=dict(base["optimizer"], nsteps=6),
               molecule={"name": "ethane", "z": [int(v) for v in z],
                         "coords_bohr": x.tolist()})
    (tmp_path / "gpu_bench/configs/toy_ethane.json").write_text(
        json.dumps(toy))
    traffic = tmp_path / "gpu_bench/traffic"
    (traffic / "toy_opt.json").write_text(json.dumps(
        {"kind": "optimize", "pool_seed": 3, "pool_size": 2}))
    (traffic / "toy_batch.json").write_text(json.dumps(
        {"kind": "batch", "start": "displace", "batch": 4, "steps": 3}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy_ethane", "source": "toy",
                            "file": "gpu_bench/configs/toy_ethane.json",
                            "reduced": [], "why": "toy"})
    spec["workloads"] += [
        {"name": "toy.opt", "config": "toy_ethane", "traffic": "toy_opt",
         "chips": 1, "why": "toy"},
        {"name": "toy.batch", "config": "toy_ethane",
         "traffic": "toy_batch", "chips": 1, "why": "toy"}]
    for m in spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("toy.batch" if m["name"]
                                  == "struct_steps_per_s" else "toy.opt")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


@pytest.fixture
def toy(root, tmp_path):
    torch.set_num_threads(2)
    return _toy_root(root, tmp_path)


def _run(toy, cell, seed=2 ** 31 + 5):
    return run.run_cell(toy, cell, seed, 0.01, 0, device="cpu")


@pytest.mark.parametrize("cell, metrics", [
    ("toy.opt", ["step_ms", "step_ms_p95", "setup_s"]),
    ("toy.batch", ["struct_steps_per_s", "setup_s"]),
])
def test_new_files_run_and_the_line_keeps_its_schema(toy, root, cell,
                                                     metrics):
    before = {p: p.read_bytes() for p in (root / "gpu_bench").rglob("*.json")}
    result, lines = _run(toy, cell)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert sorted(result["metrics"]) == sorted(metrics)
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count",
                                      "memory_peak_bytes"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    assert [ln.split(":")[0] for ln in lines[-5:]] == [
        f"check {k}" for k in result["checks"]]
    json.loads(json.dumps(result))
    assert before == {p: p.read_bytes()
                      for p in (root / "gpu_bench").rglob("*.json")}


KIND = """from gpu_bench.kinds import optimize as base

BATCHED = False
prepare, start, run = base.prepare, base.start, base.run
"""

CALC_REF = """from gpu_bench.reference.sqm2 import *  # noqa: F401,F403
"""

METHOD_REF = """from gpu_bench.reference.rfo import job_gaps, missing  # noqa: F401
"""

RUN_TOY = """import json, sys
from pathlib import Path
import gpu_bench
from gpu_bench import run
assert Path(gpu_bench.__file__).parent == Path.cwd() / "gpu_bench"
res, lines = run.run_cell(Path.cwd(), "toy.kind", 2 ** 31 + 9, 0.01, 0,
                          device="cpu")
print(json.dumps(res))
"""


def test_a_new_kind_and_reference_are_files_only(toy, root):
    """A traffic kind (`kinds/<kind>.py`) and a reference named by the
    configuration (`reference/<name>.py`) are found by name: the cell runs
    from a copy that adds those files and edits none."""
    g = toy / "gpu_bench"
    (g / "kinds" / "toy_single.py").write_text(KIND)
    (g / "reference" / "toy_calc.py").write_text(CALC_REF)
    (g / "reference" / "toy_method.py").write_text(METHOD_REF)
    (g / "traffic" / "toy_kind.json").write_text(json.dumps(
        {"kind": "toy_single", "pool_seed": 4, "pool_size": 2}))
    cfg = json.loads((g / "configs" / "toy_ethane.json").read_text())
    cfg.update(name="toy_kind_cfg", reference={"calculator": "toy_calc",
                                               "method": "toy_method"})
    (g / "configs" / "toy_kind_cfg.json").write_text(json.dumps(cfg))
    spec = json.loads((toy / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy_kind_cfg", "source": "toy",
                            "file": "gpu_bench/configs/toy_kind_cfg.json",
                            "reduced": [], "why": "toy"})
    spec["workloads"].append({"name": "toy.kind", "config": "toy_kind_cfg",
                              "traffic": "toy_kind", "chips": 1,
                              "why": "toy"})
    for m in spec["end_to_end"]:
        if m["name"].startswith("step_ms"):
            m["workloads"].append("toy.kind")
    (toy / "BENCHMARK.json").write_text(json.dumps(spec))
    out = subprocess.run(
        [sys.executable, "-c", RUN_TOY], cwd=toy, capture_output=True,
        text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{toy}:{root}",
             "OMP_NUM_THREADS": "2", "HOME": str(toy)})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert sorted(res["metrics"]) == ["setup_s", "step_ms", "step_ms_p95"]


def _unchanged_step(*args, **kwargs):
    return lambda state: state


def _half_batch(orig):
    def eg(self, coords, z):
        b = coords.shape[0]
        e, g = orig(self, coords[: max(b // 2, 1)], z)
        fill = lambda t: torch.cat(  # noqa: E731
            [t, t.mean(0, keepdim=True).expand(b - t.shape[0],
                                               *t.shape[1:])])
        return fill(e), fill(g)
    return eg


def _altered_step(orig):
    def step(g, h, trust, **kw):
        s, aux = orig(g, h, trust, **kw)
        return s + 1e-4 * (torch.arange(s.shape[-1]) == 0), aux
    return step


def _altered_energy(orig):
    def eg(self, coords, z):
        e, g = orig(self, coords, z)
        return e + 1e-6, g
    return eg


@pytest.mark.parametrize("cell, fault", [
    ("toy.opt", "unchanged_step"), ("toy.batch", "unchanged_step"),
    ("toy.batch", "half_batch"),
    ("toy.opt", "altered_step"), ("toy.batch", "altered_step"),
    ("toy.opt", "altered_energy"),
])
def test_a_planted_fault_turns_correct_false(toy, monkeypatch, cell, fault):
    """One cell has no exchange between chips, so that fault has no case."""
    from multioptpy_tpu_torch.calculators import sqm
    drv = importlib.import_module("multioptpy_tpu_torch.drivers.optimize")
    eg = sqm.SQM.energy_and_gradient
    if fault == "unchanged_step":
        monkeypatch.setattr(drv, "make_step_fn", _unchanged_step)
    elif fault == "half_batch":
        monkeypatch.setattr(sqm.SQM, "energy_and_gradient", _half_batch(eg))
    elif fault == "altered_step":
        monkeypatch.setattr(drv, "rs_rfo_step", _altered_step(drv.rs_rfo_step))
    else:
        monkeypatch.setattr(sqm.SQM, "energy_and_gradient",
                            _altered_energy(eg))
    result, _ = _run(toy, cell)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package(root):
    files = [p for p in (root / "gpu_bench").rglob("*.py")]
    assert files
    for p in files:
        assert not _imports(p) & FORBIDDEN, p
    for p in (root / "gpu_bench" / "reference").rglob("*.py"):
        assert not _imports(p) & (FORBIDDEN | {"multioptpy_tpu_torch"}), p
    # compared whole: the port's name begins with the JAX package's
    assert "multioptpy_tpu_torch" not in FORBIDDEN
    mods = ("gpu_bench.run", "gpu_bench.check", "gpu_bench.generate",
            "gpu_bench.spans", "gpu_bench.trace",
            "multioptpy_tpu_torch.drivers.optimize",
            "multioptpy_tpu_torch.calculators.sqm")
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "from gpu_bench.run import loaded_forbidden\n"
            "print(loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_loaded_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "multioptpy_tpu_torch_x", sys)
    assert "multioptpy_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "multioptpy_tpu.units", sys)
    assert "multioptpy_tpu" in run.loaded_forbidden()


def test_no_card_no_result(root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.run_cell(root, "da.opt1", 1, 1.0, 0)
    assert e.value.code == 2


def test_only_the_benchmark_files_give_no_result(root, tmp_path):
    """In a directory with BENCHMARK.json and the benchmark alone the
    command exits non-zero and prints no result."""
    shutil.copytree(root / "gpu_bench", tmp_path / "gpu_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "gpu_bench.run", "--workload", "da.opt1",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert out.returncode != 0
    assert out.stdout == ""
