"""The seminumerical Hessian's span and counter on the CPU: one
`calc.hessian` span a call, with the displaced batch's gradient nested in
it and no second `calc`; `hessians` counts one a member beside the 6N
`gradients`; and the benchmark's reader `hessian_host_ms` on a Hessian
recorded under a CPU profiler."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from multioptpy_tpu_torch import logging_utils as lu
from multioptpy_tpu_torch.calculators.sqm import SQM2
from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig, optimize

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# formaldehyde, Bohr
_H2CO = np.array([[0.0, 0.0, 0.0], [2.28, 0.0, 0.0], [-1.0, 1.75, 0.0],
                  [-1.0, -1.75, 0.0]])
_Z = np.array([6, 8, 1, 1])


@pytest.fixture(autouse=True)
def _clean_process_recorder():
    lu.PROCESS.reset()
    yield
    lu.PROCESS.reset()
    assert lu._sync_state["users"] == 0


def _pair():
    x = torch.as_tensor(_H2CO)
    return torch.stack([x, x * 1.01])


def test_one_span_a_hessian_with_the_displaced_gradient_inside():
    calc = SQM2(device="cpu")
    t = lu.StageTimer()
    with lu.recording(t):
        h = calc.hessian(_pair(), _Z)
    assert h.shape == (2, 12, 12)
    names = t.by_name()
    assert names["calc.hessian"][0] == 1 and names["calc"][0] == 1
    assert t.paths["calc/calc.hessian"][0] == 1
    for child in ("calc.forward", "calc.backward"):
        assert t.paths[f"calc/calc.hessian/{child}"][0] == 1
    assert "calc/calc.hessian/calc.forward/sqm.band" in t.paths
    assert not any(p.startswith("calc/calc.hessian/calc/")
                   or p == "calc/calc.hessian/calc" for p in t.paths)
    # the span holds its children: inclusive time at least theirs
    row = t.paths["calc/calc.hessian"]
    assert row[1] >= sum(t.paths[f"calc/calc.hessian/{c}"][1]
                         for c in ("calc.forward", "calc.backward"))
    # 2 members, 6N = 24 displaced structures each
    assert t.counters["gradients"] == 2 * 24
    assert t.counters["hessians"] == 2
    assert ("sqm.band", "cpu", 48, 16, "float64") in t.eigh_calls


def test_the_span_leaves_the_hessian_as_it_was():
    calc = SQM2(device="cpu")
    x = _pair()
    t = lu.StageTimer()
    with lu.recording(t):
        h_rec = calc.hessian(x, _Z)
    h = calc.hessian(x, _Z)
    assert torch.equal(h, h_rec)
    # the central difference of the analytic gradient, written out
    step = 1e-4
    flat = x.reshape(2, 1, 12)
    eye = torch.eye(12, dtype=x.dtype) * step
    g = calc.energy_and_gradient(
        torch.cat([flat + eye, flat - eye], 1).reshape(48, 4, 3), _Z)[1]
    g = g.reshape(2, 2, 12, 12)
    d = (g[:, 0] - g[:, 1]) / (2.0 * step)
    assert torch.equal(h, 0.5 * (d + d.mT))


def test_hessians_count_once_a_member_and_a_job_starts_inside_init():
    calc = SQM2(device="cpu")
    t = lu.StageTimer()
    with lu.recording(t):
        calc.hessian(_pair(), _Z)
        calc.numerical_hessian(_pair()[:1], _Z, step=1e-4)
    assert t.counters["hessians"] == 3
    assert t.counters["gradients"] == 3 * 24
    assert t.by_name()["calc.hessian"][0] == 2

    t2 = lu.StageTimer()
    res = optimize(SQM2(device="cpu"), torch.as_tensor(_H2CO), _Z,
                   config=OptimizeConfig(nsteps=2, init_hessian="auto"),
                   timer=t2, device="cpu")
    assert res.n_iterations == 2
    spans = [p for p in t2.paths if p.endswith("/calc.hessian")]
    assert len(spans) == 1 and spans[0].startswith("job/init/")
    assert t2.paths[spans[0]][0] == 1
    assert t2.counters["hessians"] == 1
    # the start, two steps, and the Hessian's 24 displaced structures
    assert t2.counters["gradients"] == 3 + 24


def _reader():
    from gpu_bench import run

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = "hessian_host_ms.large"
    read = run.reader(ROOT, spec, name)
    return lambda steps: read(name, {"steps": steps})


def test_the_reader_on_a_recorded_cpu_hessian():
    from torch.profiler import ProfilerActivity, profile

    read = _reader()
    assert read(5) is None                       # nothing recorded
    with profile(activities=[ProfilerActivity.CPU]):
        SQM2(device="cpu").hessian(_pair(), _Z)
    assert lu.current() is None                  # ends the sync counting
    incl_ns = lu.PROCESS.by_name()["calc.hessian"][1]
    assert incl_ns > 0
    assert read(4) == pytest.approx(incl_ns / 1e6 / 4)
    assert read(0) is None
