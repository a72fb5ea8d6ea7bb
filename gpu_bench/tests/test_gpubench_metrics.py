"""Each per-layer metric's reader on a small recorded trace: one warm
Diels-Alder rfo_fsb step of the program on the H100, its device events and
the benchmark's calculator spans (`data/trace_da_step.json.gz`)."""

import gzip
import json

import pytest

from gpu_bench import run, trace

DATA = "gpu_bench/tests/data/trace_da_step.json.gz"


@pytest.fixture
def recorded(root):
    with gzip.open(root / DATA, "rt") as f:
        rec = json.load(f)
    summary = trace.summarize([tuple(e) for e in rec["events"]],
                              rec["window_s"], rec["spans_ns"],
                              rec["jobs_ns"])
    keys = ("card", "steps", "structure_steps", "gradients", "calc_s",
            "itemsize", "dims")
    return rec, dict({k: rec[k] for k in keys}, trace=summary)


def _read(root, name, run_data):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    return run.reader(root, spec, name)(name, run_data)


def test_summary_of_the_recorded_step(recorded):
    rec, data = recorded
    s = data["trace"]
    kernels = [e for e in rec["events"]
               if not e[0].startswith(trace.COPIES)]
    assert s["launches"] == len(kernels) > 1000
    assert 0 < s["busy_s"] < s["window_s"]
    assert len(s["device_ops"]) == 10 and len(s["idle_gaps"]) == 10
    assert all(g[0].split(" ")[0] in ("calculator", "driver", "harness")
               for g in s["idle_gaps"])
    assert s["device_ops"][0][1] >= s["device_ops"][-1][1]


@pytest.mark.parametrize("suffix", [".single", ".batch"])
def test_each_reader(root, recorded, suffix):
    rec, data = recorded
    launches = _read(root, "launches_per_step" + suffix, data)
    assert launches == data["trace"]["launches"]
    assert _read(root, "calc_ms_per_step" + suffix, data) == pytest.approx(
        rec["calc_s"] * 1e3)
    idle = _read(root, "device_idle_pct" + suffix, data)
    assert 50.0 < idle < 100.0
    share = _read(root, "eigh_roofline" + suffix, data)
    assert 0.0 < share < 1.0           # microseconds of work in a step


def test_a_reader_with_nothing_to_read_returns_none(root, recorded):
    _, data = recorded
    empty = dict(data, steps=0, trace=dict(data["trace"], kernel_s={},
                                           busy_s=0.0))
    for name in ("launches_per_step.single", "calc_ms_per_step.single",
                 "eigh_roofline.single", "device_idle_pct.single"):
        assert _read(root, name, empty) is None
    assert _read(root, "eigh_roofline.single",
                 dict(data, card="another card")) is None
