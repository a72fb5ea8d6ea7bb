"""The readers of the program's own spans and counters
(`metrics/{step_host_ms,calc_host_ms,eigh_host_ms,host_syncs_per_step,
live_member_pct}.py`) on the port's process-wide recorder filled on the
CPU: the numbers a recorder with known spans gives, a real traced
optimization, and None where the recorder is empty or absent."""

import json
import warnings

import numpy as np
import pytest
import torch

from gpu_bench import run

STEMS = ("step_host_ms", "calc_host_ms", "eigh_host_ms",
         "host_syncs_per_step")
SYNC = "called a synchronizing CUDA operation (Triggered internally)"


@pytest.fixture
def lu():
    from multioptpy_tpu_torch import logging_utils

    logging_utils.PROCESS.reset()
    yield logging_utils
    logging_utils.PROCESS.reset()


def _read(root, name, steps):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    return run.reader(root, spec, name)(name, {"steps": steps})


def _fill(lu, monkeypatch):
    """Two steps of known spans on a clock that advances 1 ms a reading.
    A span's self time is then its own extra readings (`_ticks`), plus one
    for each child span, plus one for its close: per step, `step` 13 ms,
    `step.update` 1, `step.solve` 8 and `loop` 9 (step engine, 31);
    `step.calc` 3 (no layer); `calc` 4 and `sqm.band` 5 (calculator, 9);
    the two `eigh` 6 and 5 (eigensolver, 11); `wait` 1 (no layer). One
    sync in each `eigh` and in the `wait`; members live 3 of 4, then 2,
    of the 8 structures the steps evaluated."""
    ms = 1_000_000
    clock = iter(range(0, 10_000 * ms, ms))
    monkeypatch.setattr(lu.PROCESS, "clock", lambda: next(clock))
    with lu.recording(lu.PROCESS):
        for _ in range(2):
            with lu.span("step"):
                _ticks(lu, 9)
                with lu.span("step.update"):
                    pass
                with lu.span("step.solve"):
                    _ticks(lu, 6)
                    with lu.span("eigh"):
                        _ticks(lu, 5)
                        warnings.warn(SYNC)
                with lu.span("step.calc"):
                    _ticks(lu, 1)
                    with lu.span("calc"):
                        _ticks(lu, 2)
                        with lu.span("sqm.band"):
                            _ticks(lu, 3)
                            with lu.span("eigh"):
                                _ticks(lu, 4)
                                warnings.warn(SYNC)
            with lu.span("loop"):
                _ticks(lu, 7)
                with lu.span("wait"):
                    warnings.warn(SYNC)
        lu.PROCESS.count_members(torch.tensor([False, True, False, False]))
        lu.PROCESS.count_members(torch.tensor([False, True, True, False]))
        lu.PROCESS.count("step_structures", 8)


def _ticks(lu, n):
    for _ in range(n):
        lu.PROCESS.clock()


def test_each_reader_on_known_spans(root, lu, monkeypatch):
    _fill(lu, monkeypatch)
    assert _read(root, "step_host_ms.single", 2) == pytest.approx(31.0)
    assert _read(root, "calc_host_ms.batch", 2) == pytest.approx(9.0)
    assert _read(root, "eigh_host_ms.single", 2) == pytest.approx(11.0)
    assert _read(root, "host_syncs_per_step.batch", 2) == 3.0
    assert _read(root, "live_member_pct.batch", 2) == pytest.approx(
        100.0 * 5 / 8)
    # a step that leaves frozen members out of the calculator's batch
    lu.PROCESS.counters["step_structures"] = 5
    assert _read(root, "live_member_pct.batch", 2) == pytest.approx(100.0)


def test_readers_on_a_traced_optimization(root, lu):
    from torch.profiler import ProfilerActivity, profile

    from multioptpy_tpu_torch.calculators.lj import LennardJones
    from multioptpy_tpu_torch.drivers.optimize import optimize_batch
    from multioptpy_tpu_torch.periodic import UFF_VDW_R

    r = float(UFF_VDW_R[18])
    ar4 = np.array([[0.0, 0.0, 0.0], [r * 1.05, 0.1, 0.0],
                    [r / 2, r * 0.9, 0.2], [r / 2, r * 0.3, r * 0.8]])
    x = torch.as_tensor(np.stack([ar4, ar4 * 1.02]))
    with profile(activities=[ProfilerActivity.CPU]):
        optimize_batch(LennardJones(device="cpu"), x, np.full(4, 18),
                       n_steps=3, device="cpu")
    names = lu.PROCESS.by_name()
    per_step = {s: _read(root, s + ".batch", 3) for s in STEMS}
    assert per_step["step_host_ms"] == pytest.approx(sum(
        names[n][2] for n in ("step", "step.update", "step.project",
                              "step.solve", "step.accept", "loop"))
        / 1e6 / 3)
    assert per_step["calc_host_ms"] == pytest.approx(sum(
        names[n][2] for n in ("calc", "calc.forward", "calc.backward"))
        / 1e6 / 3)
    assert per_step["eigh_host_ms"] == pytest.approx(
        names["eigh"][2] / 1e6 / 3)
    assert per_step["host_syncs_per_step"] == 0.0     # no card
    assert _read(root, "live_member_pct.batch", 3) == 100.0


def test_readers_with_nothing_to_read_return_none(root, lu, monkeypatch):
    for stem in STEMS:
        assert _read(root, stem + ".single", 5) is None
    assert _read(root, "live_member_pct.batch", 5) is None
    _fill(lu, monkeypatch)
    assert _read(root, "step_host_ms.single", 0) is None
    # a program without the recorder (the parent of the recorder's change)
    monkeypatch.delattr(lu, "PROCESS")
    for stem in STEMS:
        assert _read(root, stem + ".batch", 2) is None
    assert _read(root, "live_member_pct.batch", 2) is None
