"""The port's span recorder (`multioptpy_tpu_torch.logging_utils`) on the
CPU: self time on a fake clock, nothing recorded or allocated when off,
the process-wide recorder exactly while a torch.profiler records, the
drivers' spans and callbacks under an operator's timer (Lennard-Jones),
the calculator's and eigensolver's spans and counters on SQM2, syncs put
down to the innermost open span, live members of a lockstep batch,
`device_ops`' launches and host waits, and `profile_trace`'s Chrome trace
and `spans.csv`."""

import json
import warnings

import numpy as np
import pytest
import torch

from multioptpy_tpu_torch import logging_utils as lu
from multioptpy_tpu_torch.calculators.lj import LennardJones
from multioptpy_tpu_torch.calculators.sqm import SQM2
from multioptpy_tpu_torch.drivers.optimize import (OptimizeConfig, optimize,
                                                   optimize_batch)
from multioptpy_tpu_torch.periodic import UFF_VDW_R

torch.set_num_threads(1)

_R = float(UFF_VDW_R[18])
_AR4 = np.array([[0.0, 0.0, 0.0], [_R * 1.05, 0.1, 0.0],
                 [_R / 2, _R * 0.9, 0.2], [_R / 2, _R * 0.3, _R * 0.8]])
_Z = np.full(4, 18)
# formaldehyde, Bohr
_H2CO = np.array([[0.0, 0.0, 0.0], [2.28, 0.0, 0.0], [-1.0, 1.75, 0.0],
                  [-1.0, -1.75, 0.0]])
_SYNC = lu.SYNC_MESSAGE + " (Triggered internally at CUDAFunctions.cpp:1.)"


@pytest.fixture(autouse=True)
def _clean_process_recorder():
    lu.PROCESS.reset()
    yield
    lu.PROCESS.reset()
    assert lu._sync_state["users"] == 0


def test_nesting_and_self_time_on_a_fake_clock():
    ticks = iter([0, 10, 15, 40, 100, 130, 150, 200])
    t = lu.StageTimer(clock=lambda: next(ticks))
    with lu.recording(t):
        with lu.span("job"):                      # 0 .. 200
            with lu.span("step"):                 # 10 .. 100
                with lu.span("step.solve"):       # 15 .. 40
                    with lu.span("step.solve"):   # a span of its own name
                        pass                      # opens none
            with lu.span("loop"):                 # 130 .. 150
                pass
    assert t.paths == {"job/step/step.solve": [1, 25, 25, 0],
                       "job/step": [1, 90, 65, 0],
                       "job/loop": [1, 20, 20, 0],
                       "job": [1, 200, 90, 0]}
    assert t.events == [("job/step/step.solve", 15, 40, 1, 1),
                        ("job/step", 10, 100, 1, 1),
                        ("job/loop", 130, 150, 1, 1),
                        ("job", 0, 200, 1, 1)]
    assert t.by_name()["step.solve"] == [1, 25, 25, 0]
    assert t.report() == {}          # the stages are apart from the spans


def test_off_records_nothing_and_allocates_no_event():
    assert lu.span("step") is lu.span("calc") is lu._OFF
    assert lu.current() is None
    optimize(LennardJones(device="cpu"), torch.as_tensor(_AR4), _Z,
             config=OptimizeConfig(nsteps=2), device="cpu")
    assert lu.PROCESS.paths == {} and lu.PROCESS.events == []
    assert not lu.PROCESS.counters and not lu.PROCESS.eigh_calls
    assert lu._sync_state["users"] == 0


def test_process_recorder_records_while_the_profiler_does():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        assert lu.current() is lu.PROCESS
        with lu.span("a"):
            torch.ones(4).sum()
        assert lu._sync_state["users"] == 1
    # the first span after the profiler stopped ends the counting
    assert lu._sync_state["users"] == 1
    assert lu.span("b") is lu._OFF
    assert lu._sync_state["users"] == 0
    assert set(lu.PROCESS.paths) == {"a"}
    with pytest.warns(UserWarning, match=lu.SYNC_MESSAGE):
        warnings.warn(_SYNC)
    assert lu.PROCESS.by_name()["a"][3] == 0


def test_drivers_record_steps_loops_waits_and_callbacks():
    t = lu.StageTimer()
    res = optimize(LennardJones(device="cpu"), torch.as_tensor(_AR4), _Z,
                   config=OptimizeConfig(nsteps=8), timer=t, device="cpu")
    names = t.by_name()
    assert names["step"][0] == names["loop"][0] == res.n_iterations
    assert names["job"][0] == names["init"][0] == 1
    # the start's energy, each step's energy and converged flag
    assert names["wait"][0] == 1 + 2 * res.n_iterations
    assert {"step.update", "step.project", "step.solve", "step.calc",
            "step.accept", "calc", "eigh"} <= set(names)
    assert set(t.report()) == {"step", "host"}
    assert t.jobs == [(1, 1, 4, "rfo_fsb")]

    seen = []
    t2 = lu.StageTimer()
    x = torch.as_tensor(np.stack([_AR4, _AR4 * 1.02, _AR4 * 0.98]))
    res2 = optimize_batch(LennardJones(device="cpu"), x, _Z, n_steps=4,
                          timer=t2, callback=lambda it, s: seen.append(it),
                          device="cpu")
    names = t2.by_name()
    assert seen == [1, 2, 3, 4] == list(range(1, res2.n_iterations + 1))
    assert names["step"][0] == names["loop"][0] == 4
    assert names["wait"][0] == 1          # the energy history, once
    assert t2.counters["member_steps"] == 12
    assert t2.counters["gradients"] == 3 * 5
    assert t2.report()["step"]["count"] == 4
    assert t2.jobs == [(1, 3, 4, "rfo_fsb")]


def test_sharded_batch_records_each_shards_steps_and_calls_back():
    from multioptpy_tpu_torch.parallel.mesh import ShardedTree, ensemble_mesh

    seen = []
    t = lu.StageTimer()
    x = torch.as_tensor(np.stack([_AR4 * s for s in (1.0, 1.02, 0.98,
                                                     1.01)]))
    optimize_batch(LennardJones(device="cpu"), x, _Z, n_steps=3, timer=t,
                   mesh=ensemble_mesh(devices=["cpu"] * 2), device="cpu",
                   callback=lambda it, s: seen.append(
                       (it, isinstance(s, ShardedTree))))
    names = t.by_name()
    assert seen == [(1, True), (2, True), (3, True)]
    assert names["job"][0] == 1 and names["init"][0] == 2
    assert names["step"][0] == 2 * 3 and names["loop"][0] == 3
    assert t.counters["member_steps"] == 4 * 3
    assert t.jobs == [(1, 4, 4, "rfo_fsb")]


def test_sqm2_records_calculator_and_eigensolver_spans():
    t = lu.StageTimer()
    res = optimize(SQM2(device="cpu"), torch.as_tensor(_H2CO),
                   np.array([6, 8, 1, 1]),
                   config=OptimizeConfig(nsteps=2,
                                         init_hessian="model:lindh"),
                   timer=t, device="cpu")
    assert res.n_iterations == 2
    names = t.by_name()
    for name in ("calc", "calc.forward", "calc.backward", "sqm.eeq",
                 "sqm.hamiltonian", "sqm.loewdin", "sqm.band",
                 "sqm.classical"):
        assert names[name][0] == 3, name        # the start and two steps
    assert names["eigh"][0] == 3 * 3 + 2
    assert t.counters["gradients"] == 3
    # 4 atoms: EEQ bordered 5 x 5, 16 orbitals, RFO 12
    assert dict(t.eigh_calls) == {
        ("sqm.eeq", "cpu", 1, 5, "float64"): 3,
        ("sqm.loewdin", "cpu", 1, 16, "float64"): 3,
        ("sqm.band", "cpu", 1, 16, "float64"): 3,
        ("step.solve", "cpu", 1, 12, "float64"): 2}
    assert "job/step/step.calc/calc/calc.forward/sqm.band/eigh" in t.paths
    # SQM2's tables go to the device in `wait` spans, out of the layer
    assert ("job/step/step.calc/calc/calc.forward/sqm.classical/wait"
            in t.paths)


def test_a_sync_is_counted_in_the_innermost_open_span():
    t = lu.StageTimer()
    with lu.recording(t):
        warnings.warn(_SYNC)
        with lu.span("a"):
            warnings.warn(_SYNC)
            with lu.span("b"):
                warnings.warn(_SYNC)
                warnings.warn(_SYNC)
            with pytest.warns(UserWarning, match="another"):
                warnings.warn("another warning")
    assert t.paths["a/b"][3] == 2 and t.paths["a"][3] == 1
    assert t.counters["syncs_outside_spans"] == 1
    assert sum(r[3] for r in t.by_name().values()) == 3
    assert lu._sync_state["users"] == 0


def test_live_member_steps_of_a_batch_with_one_converged_member():
    calc = LennardJones(device="cpu")
    relaxed = optimize(calc, torch.as_tensor(_AR4), _Z, device="cpu",
                       config=OptimizeConfig(max_force=1e-9, rms_force=1e-9,
                                             nsteps=200)).coords
    x = torch.stack([relaxed] + [torch.as_tensor(_AR4 * s)
                                 for s in (1.0, 1.03, 0.97)])
    flags = []
    t = lu.StageTimer()
    optimize_batch(calc, x, _Z, n_steps=3, timer=t, device="cpu",
                   callback=lambda it, s: flags.append(s.converged.clone()))
    # the relaxed member converges on the first step, the others later
    assert flags[0].tolist() == [True, False, False, False]
    live = 4 + sum(int((~f).sum()) for f in flags[:-1])
    assert t.counters["member_steps"] == t.counters["step_structures"] == 12
    assert t.live_member_steps() == live < 12
    # live_member_pct: the live member steps over the structures evaluated
    assert 100.0 * t.live_member_steps() / t.counters[
        "step_structures"] == pytest.approx(100.0 * live / 12)


def test_span_table_puts_device_work_and_idle_down_to_spans():
    ms = 1_000_000
    t = lu.StageTimer()
    t.paths = {"job": [1, 100 * ms, 40 * ms, 0],
               "job/step": [1, 50 * ms, 40 * ms, 2],
               "job/step/eigh": [1, 10 * ms, 10 * ms, 1]}
    t.events = [("job/step/eigh", 20 * ms, 30 * ms, 1, 1),
                ("job/step", 10 * ms, 60 * ms, 1, 1),
                ("job", 0, 100 * ms, 1, 0)]
    ops = [("jacobi_block_kernel", 30 * ms, 35 * ms, 25 * ms),
           ("sytrd", 39 * ms, 45 * ms, 50 * ms),
           ("Memcpy DtoH", 80 * ms, 90 * ms, 70 * ms),
           ("orphan", 92 * ms, 93 * ms, None)]
    # the host waits 26-30 ms (in the eigh) and 70-90 ms (in the job)
    waits = [(26 * ms, 30 * ms), (70 * ms, 90 * ms)]
    rows = {r[0]: r[1:] for r in lu.span_table(t, ops, waits)}
    assert rows["job/step/eigh"] == [1, 10.0, 1, 4.0, 1, 5.0, 0.0]
    # the gap 35-39 ms falls in the step, 45-80 and 90-92 in the job
    assert rows["job/step"] == [1, 40.0, 2, 0.0, 1, 6.0, 4.0]
    assert rows["job"] == [1, 40.0, 0, 20.0, 0, 10.0, 37.0]
    assert rows["(none)"] == [0, 0.0, 0, 0.0, 1, 1.0, 0.0]


class _Ev:
    """A kineto event as `device_ops` reads it."""

    def __init__(self, name, start, end, corr, cuda=False, linked=0,
                 annotation=False):
        self._v = (name, start, end, corr, cuda, linked, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[4]
                else torch.autograd.DeviceType.CPU)

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def test_device_ops_links_launches_and_finds_the_hosts_waits():
    from types import SimpleNamespace

    events = [_Ev("cudaLaunchKernel", 10, 12, 1),
              _Ev("cudaMemcpyAsync", 20, 90, 2),
              _Ev("cudaMemcpyAsync", 30, 31, 3),
              _Ev("cudaStreamSynchronize", 40, 70, 4),
              _Ev("aten::mm", 50, 60, 5),
              _Ev("sytrd", 15, 25, 1, cuda=True),
              _Ev("Memcpy DtoH (Device -> Pageable)", 85, 88, 2, cuda=True),
              _Ev("Memcpy DtoD (Device -> Device)", 32, 33, 3, cuda=True),
              _Ev("gemm", 61, 65, 0, cuda=True, linked=5),
              _Ev("eigh", 10, 90, 0, cuda=True, annotation=True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    ops, waits = lu.device_ops(prof)
    assert ops == [("sytrd", 15, 25, 10),
                   ("Memcpy DtoD (Device -> Device)", 32, 33, 30),
                   ("gemm", 61, 65, 50),
                   ("Memcpy DtoH (Device -> Pageable)", 85, 88, 20)]
    # the synchronization and the pageable copy wait; the copy between
    # two places on the card does not
    assert waits == [(20, 90), (40, 70)]


def test_profile_trace_writes_the_spans(tmp_path):
    with lu.profile_trace(str(tmp_path)):
        optimize(LennardJones(device="cpu"), torch.as_tensor(_AR4), _Z,
                 config=OptimizeConfig(nsteps=2), device="cpu")
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("ph") == "X"}
    assert {"job", "init", "step", "step.solve", "calc", "eigh",
            "loop"} <= names
    lines = (tmp_path / "spans.csv").read_text().splitlines()
    assert lines[0] == ("span,count,host_self_ms,syncs,wait_ms,launches,"
                        "device_ms,idle_ms")
    rows = {ln.split(",")[0]: ln.split(",")[1:] for ln in lines[1:]}
    assert rows["job/step"][0] == "2" and rows["job"][0] == "1"
    counters = json.loads((tmp_path / "counters.json").read_text())
    assert counters["counters"]["member_steps"] == 2
    assert counters["live_member_steps"] == 2
    assert counters["jobs"] == [[1, 1, 4, "rfo_fsb"]]
    assert counters["eigh_calls"] == [["step.solve", "cpu", 1, 12,
                                       "float64", 2]]
    assert lu.span("x") is lu._OFF and lu._sync_state["users"] == 0
