"""Run logging, per-stage timing and the program's spans.

Counterpart of `multioptpy_tpu/logging_utils.py`: `RunLogger` collects
per-iteration scalars into `run_log.csv` and the values of tracked
internal coordinates (`-gi`) into `geometry_params.csv`;
`snapshot_config` writes `input.json`, the record of every option of a
run; `StageTimer` times the stages of a driver loop, synchronizing the
card before it closes a stage that was given a CUDA tensor;
`profile_trace` wraps `torch.profiler` and writes a Chrome trace, and the
program's spans and counters beside it.

`StageTimer` is also the port's span recorder. The drivers, the
calculators and the eigensolvers open named spans (`span`, `spanned`) at
their layer boundaries; a span opens none inside one of its own name. A
recorder keeps, per span path ("job/step/step.solve/eigh"), the count,
the inclusive and the self time (the duration less what child spans
cover) and the host synchronizations reported while the span was the
innermost open one, and beside them a bounded list of span events and a
few counters (`count`, `count_eigh`, `count_members`). Spans are timed
with `time.time_ns()`, the clock of torch.profiler's device events, and
never synchronize the card. They record into the recorder an operator
made current (`recording(timer)`; `optimize(timer=...)` and
`optimize_batch(timer=...)` do so), or else into the process-wide
`PROCESS` while a torch.profiler records; otherwise a span costs one
context-variable read and two flag checks, and records nothing.

`make_callback` takes the optimize driver's state, a batch of one: each
per-step `float()` is one host synchronization, as in the reference.
"""

from contextlib import contextmanager
import collections
import contextvars
import dataclasses
import functools
import json
import os
import time
import warnings

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

class RunLogger:
    def __init__(self, out_dir, tracked_params=None):
        """tracked_params: list of ("bond", (i, j)) / ("angle", (i, j, k))
        / ("dihedral", (i, j, k, l)) with 1-based atoms (the -gi flag)."""
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.rows = []
        self.tracked = tracked_params or []
        self.geom_rows = []

    def log_step(self, iteration, energy, max_force, rms_force, step_norm,
                 trust_radius, **extra):
        row = dict(iteration=iteration, energy=energy, max_force=max_force,
                   rms_force=rms_force, step_norm=step_norm,
                   trust_radius=trust_radius, **extra)
        self.rows.append(row)

    def log_geometry(self, coords):
        """Values of the tracked internal coordinates at coords (N, 3)."""
        if not self.tracked:
            return
        from multioptpy_tpu_torch.potentials.base import _angle, _dihedral

        c = torch.as_tensor(coords)
        vals = []
        for kind, atoms in self.tracked:
            a = [i - 1 for i in atoms]
            if kind == "bond":
                vals.append(float(torch.linalg.vector_norm(c[a[0]]
                                                           - c[a[1]])))
            elif kind == "angle":
                vals.append(float(_angle(c[a[0]], c[a[1]], c[a[2]])))
            elif kind == "dihedral":
                vals.append(float(_dihedral(c[a[0]], c[a[1]], c[a[2]],
                                            c[a[3]])))
        self.geom_rows.append(vals)

    def make_callback(self):
        """-> driver callback(it, state) feeding this logger; `state` is
        the optimize driver's, a batch of one."""

        def cb(it, state):
            g = state.gradient[0].reshape(-1)
            self.log_step(
                it, float(state.energy[0]), float(g.abs().max()),
                float(torch.sqrt((g * g).mean())),
                float(torch.linalg.vector_norm(state.move[0])),
                float(state.trust_radius[0]))
            self.log_geometry(state.coords[0])

        return cb

    def flush(self):
        """Write run_log.csv and, with tracked coordinates,
        geometry_params.csv."""
        if self.rows:
            keys = list(self.rows[0].keys())
            path = os.path.join(self.out_dir, "run_log.csv")
            with open(path, "w") as f:
                f.write(",".join(keys) + "\n")
                for r in self.rows:
                    f.write(",".join(f"{r[k]}" for k in keys) + "\n")
        if self.geom_rows:
            labels = ["_".join([k] + [str(a) for a in at])
                      for k, at in self.tracked]
            np.savetxt(os.path.join(self.out_dir, "geometry_params.csv"),
                       np.asarray(self.geom_rows), delimiter=",",
                       header=",".join(labels))
        return self.out_dir


def snapshot_config(out_dir, config, extra=None):
    """input.json: every option of a run (a dataclass or a mapping)."""
    os.makedirs(out_dir, exist_ok=True)
    data = dataclasses.asdict(config) if dataclasses.is_dataclass(config) \
        else dict(config)
    if extra:
        data.update(extra)
    path = os.path.join(out_dir, "input.json")
    with open(path, "w") as f:
        json.dump(data, f, indent=1, default=str)
    return path


# the message of torch's sync debug mode (torch.cuda.set_sync_debug_mode)
SYNC_MESSAGE = "called a synchronizing CUDA operation"
# span names that start a job and a step (the events' job id, step index)
_JOB, _STEP = "job", "step"
# the span events a recorder keeps (`dropped` counts those past it)
_MAX_EVENTS = 200_000
# a profiler range in C++ (about 1 us; torch.profiler.record_function, its
# public form, costs about 16)
_RecordFunction = getattr(torch._C._profiler, "_RecordFunctionFast",
                          torch.profiler.record_function)


class StageTimer:
    """Per-stage wall-clock timers for driver loops, and the span recorder.

        timer = StageTimer()
        with timer.stage("step", block=state.energy):
            ...
        timer.report()   # {"step": {"total_s", "count", "mean_ms"}, ...}

    Launches return before the card finishes: `stage(..., block=x)`
    synchronizes x's device before closing the timer when x is a CUDA
    tensor, so device work counts to the stage that launched it.

    As a recorder (`optimize(..., timer=timer)`, or `recording(timer)`
    around any call) it keeps, per span path, [count, inclusive ns, self
    ns, syncs] in `paths` (`by_name` sums them by span name), the spans as
    (path, start ns, end ns, job id, step index) in `events` (the first
    200,000; `dropped` counts the rest), the counters `gradients`,
    `hessians`, `step_structures` and `member_steps` in `counters`,
    eigensolver calls by (caller span, route, B, D, dtype) in
    `eigh_calls`, and (job id, B, N, method) of each job in `jobs`.
    `clock` returns ns; tests pass a fake one. One thread records into a
    recorder at a time."""

    def __init__(self, clock=time.time_ns):
        self.totals = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)
        self.clock = clock
        self._counting = 0
        self.reset()

    @contextmanager
    def stage(self, name, block=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if isinstance(block, torch.Tensor) and block.is_cuda:
                torch.cuda.synchronize(block.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self):
        return {name: {"total_s": self.totals[name],
                       "count": self.counts[name],
                       "mean_ms": 1e3 * self.totals[name]
                       / max(self.counts[name], 1)}
                for name in self.totals}

    def write_csv(self, path):
        with open(path, "w") as f:
            f.write("stage,total_s,count,mean_ms\n")
            for name, row in self.report().items():
                f.write(f"{name},{row['total_s']:.6f},{row['count']},"
                        f"{row['mean_ms']:.4f}\n")

    # ---- the span recorder ----------------------------------------------

    def reset(self):
        """Forget every span and counter (the stages stay)."""
        self.paths = {}
        self.events = []
        self.dropped = 0
        self.counters = collections.Counter()
        self.eigh_calls = collections.Counter()
        self.jobs = []
        self.job = 0
        self.step = 0
        self._stack = []
        self._frozen = {}   # (device, B) -> (B,) steps each member was frozen

    def span(self, name):
        """A span of this recorder (opened by `with`); none inside a span
        of the same name."""
        if self.innermost() == name:
            return _OFF
        return _Span(self, name)

    def innermost(self):
        """The name of the innermost open span, or None."""
        return self._stack[-1].name if self._stack else None

    def by_name(self):
        """{span name: [count, inclusive ns, self ns, syncs]}, summed over
        the paths that end in the name."""
        out = {}
        for path, (n, incl, self_ns, syncs) in self.paths.items():
            row = out.setdefault(path.rsplit("/", 1)[-1], [0, 0, 0, 0])
            row[0] += n
            row[1] += incl
            row[2] += self_ns
            row[3] += syncs
        return out

    def count(self, name, n=1):
        self.counters[name] += int(n)

    def count_eigh(self, route, a):
        """One eigensolver call on `a` (..., D, D) by `route`, under the
        span that opened the innermost `eigh` span."""
        names = [s.name for s in self._stack]
        while names and names[-1] == "eigh":
            names.pop()
        caller = names[-1] if names else ""
        b = int(np.prod(a.shape[:-2], dtype=np.int64))
        self.eigh_calls[(caller, route, b, int(a.shape[-1]),
                         str(a.dtype).replace("torch.", ""))] += 1

    def count_members(self, converged):
        """A batched step over members with these (B,) converged flags:
        B member steps, the converged ones frozen; the frozen steps add up
        on the flags' device, one launch a step, and are read once, by
        `live_member_steps`. The structures the step hands the calculator
        are counted apart, as `step_structures`."""
        b = int(converged.shape[0])
        self.counters["member_steps"] += b
        key = (converged.device, b)
        if key not in self._frozen:
            self._frozen[key] = torch.zeros(b, dtype=torch.int64,
                                            device=converged.device)
        self._frozen[key] += converged

    def live_member_steps(self):
        """Member steps of unconverged members (one host read an
        accumulator)."""
        frozen = sum(int(acc.sum()) for acc in self._frozen.values())
        return self.counters["member_steps"] - frozen

    def note_job(self, b, n, method):
        self.jobs.append((self.job, int(b), int(n), str(method)))

    def _sync(self):
        if self._stack:
            self._stack[-1].syncs += 1
        else:
            self.counters["syncs_outside_spans"] += 1

    def _start_counting(self):
        self._counting += 1
        if self._counting == 1:
            _sync_state["users"] += 1
        _install_sync_hook()

    def _stop_counting(self, all_=False):
        if self._counting:
            self._counting = 0 if all_ else self._counting - 1
            if self._counting == 0:
                _sync_state["users"] -= 1
                if _sync_state["users"] == 0:
                    _remove_sync_hook()


class _Span:
    """One open span of a recorder."""

    __slots__ = ("rec", "name", "path", "t0", "child_ns", "syncs", "rf")

    def __init__(self, rec, name):
        self.rec = rec
        self.name = name

    def __enter__(self):
        rec = self.rec
        stack = rec._stack
        self.path = (stack[-1].path + "/" + self.name if stack
                     else self.name)
        self.child_ns = 0
        self.syncs = 0
        if self.name == _STEP:
            rec.step += 1
        elif self.name == _JOB:
            rec.job += 1
            rec.step = 0
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _RecordFunction(self.name)
            self.rf.__enter__()
        else:
            self.rf = None
        stack.append(self)
        self.t0 = rec.clock()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        t1 = rec.clock()
        rec._stack.pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        dur = t1 - self.t0
        if rec._stack:
            rec._stack[-1].child_ns += dur
        row = rec.paths.get(self.path)
        if row is None:
            row = rec.paths[self.path] = [0, 0, 0, 0]
        row[0] += 1
        row[1] += dur
        row[2] += dur - self.child_ns
        row[3] += self.syncs
        if len(rec.events) < _MAX_EVENTS:
            rec.events.append((self.path, self.t0, t1, rec.job, rec.step))
        else:
            rec.dropped += 1
        return False


class _Off:
    """The span that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
# the recorder an operator made current for a call (`recording`)
_CURRENT = contextvars.ContextVar("multioptpy_tpu_torch_recorder",
                                  default=None)
# the process-wide recorder: current while a torch.profiler records and no
# operator's recorder is
PROCESS = StageTimer()


def current():
    """The recorder spans record into now, or None."""
    rec = _CURRENT.get()
    if rec is None:
        if not _autograd_profiler._is_profiler_enabled:
            if PROCESS._counting:
                PROCESS._stop_counting(all_=True)
            return None
        rec = PROCESS
        if not rec._counting:
            rec._start_counting()
    return rec


def span(name):
    """The span `name` of the current recorder, for a `with` statement; it
    yields the open span, or None when nothing records."""
    rec = current()
    if rec is None:
        return _OFF
    return rec.span(name)


def spanned(name):
    """Decorator: the function runs inside `span(name)`."""
    def deco(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return deco


def count_eigh(route, a):
    """Count one eigensolver call on `a` by `route` ("k1.block",
    "k1.warp", "k3", "cusolver", "cpu", "jacobi") with the current
    recorder."""
    rec = current()
    if rec is not None:
        rec.count_eigh(route, a)


def count_members(converged):
    rec = current()
    if rec is not None:
        rec.count_members(converged)


def count(name, n=1):
    rec = current()
    if rec is not None:
        rec.count(name, n)


def host_read(read, x):
    """read(x) inside a `wait` span: a deliberate host read of the
    drivers, the time the host waits on the card (one sync on a CUDA
    tensor)."""
    with span("wait"):
        return read(x)


def to_card(array, **kind):
    """torch.as_tensor(array, **kind) inside a `wait` span: a host table
    copied to the card from pageable memory, which waits for the work
    queued there first (one sync on the card)."""
    with span("wait"):
        return torch.as_tensor(array, **kind)


class _Recording:
    def __init__(self, rec):
        self.rec = rec

    def __enter__(self):
        self.token = _CURRENT.set(self.rec)
        self.rec._start_counting()
        return self.rec

    def __exit__(self, *exc):
        self.rec._stop_counting()
        _CURRENT.reset(self.token)
        return False


def recording(timer):
    """Make `timer` (a StageTimer) the current recorder inside a `with`
    block, and count host synchronizations into its spans; with None,
    nothing."""
    return _OFF if timer is None else _Recording(timer)


# ---- counting host synchronizations ----------------------------------------
#
# While some recorder counts, torch's sync debug mode warns at every
# implicit synchronization of the card (a device-to-host copy, a blocking
# host-to-device copy, an `.item()`; not torch.cuda.synchronize()), the
# warnings filter shows each one ("always"), and `_on_warning` puts it down
# to the innermost open span of the current recorder instead of printing it.

_sync_state = {"users": 0, "showwarning": None, "filter": None,
               "mode": None}


def _on_warning(message, category, filename, lineno, file=None, line=None):
    if issubclass(category, UserWarning) and str(message).startswith(
            SYNC_MESSAGE):
        rec = current()
        if rec is not None:
            rec._sync()
        return
    _sync_state["showwarning"](message, category, filename, lineno, file,
                               line)


def _install_sync_hook():
    """The hook, the filter and torch's warn mode, each where missing."""
    st = _sync_state
    if warnings.showwarning is not _on_warning:
        st["showwarning"] = warnings.showwarning
        warnings.showwarning = _on_warning
    if st["filter"] not in warnings.filters:
        warnings.filterwarnings("always", message=SYNC_MESSAGE,
                                category=UserWarning)
        st["filter"] = warnings.filters[0]
    if (st["mode"] is None and torch.cuda.is_available()
            and torch.cuda.is_initialized()):
        st["mode"] = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():     # "a prototype feature"
            warnings.simplefilter("ignore")
            torch.cuda.set_sync_debug_mode("warn")


def _remove_sync_hook():
    st = _sync_state
    if st["mode"] is not None:
        torch.cuda.set_sync_debug_mode(st["mode"])
        st["mode"] = None
    if warnings.showwarning is _on_warning:
        warnings.showwarning = st["showwarning"]
    if st["filter"] in warnings.filters:
        warnings.filters.remove(st["filter"])
        warnings._filters_mutated()
    st["filter"] = None


# ---- the operator's export -------------------------------------------------

_COPIES = ("Memcpy", "Memset")
# host calls of the CUDA runtime that wait for the card; a copy waits where
# its host side is pageable memory
_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
          "cudaEventSynchronize")


def device_ops(prof):
    """(ops, waits) of a finished torch.profiler run. ops: [(name, start
    ns, end ns, launch ns)] of the card's operations, by start; the launch
    time is the host start of the runtime call with the operation's
    correlation id, else of the profiled host range the operation is
    linked to, else None. waits: [(start ns, end ns)], by start, of the
    host's calls of the CUDA runtime that wait for the card: the
    synchronizations, and the copies to or from pageable host memory."""
    events = prof.profiler.kineto_results.events()
    runtime, ranges, copies, waits = {}, {}, {}, []
    for ev in events:
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            name = ev.name()
            into = runtime if name.startswith("cu") else ranges
            into.setdefault(ev.correlation_id(), ev.start_ns())
            if name.startswith(_SYNCS):
                waits.append((ev.start_ns(), ev.end_ns()))
            elif name.startswith("cudaMemcpy"):
                copies[ev.correlation_id()] = (ev.start_ns(), ev.end_ns())
    ops = []
    for ev in events:
        # a span's range as the profiler draws it on the card's timeline
        # is no operation
        if (ev.device_type() == torch.autograd.DeviceType.CUDA
                and not ev.is_user_annotation()):
            name = ev.name()
            launch = runtime.get(ev.correlation_id())
            if launch is None:
                launch = ranges.get(ev.linked_correlation_id())
            ops.append((name, ev.start_ns(), ev.end_ns(), launch))
            if "Pageable" in name and ev.correlation_id() in copies:
                waits.append(copies[ev.correlation_id()])
    ops.sort(key=lambda o: o[1])
    waits.sort()
    return ops, waits


def innermost(events, times):
    """For each of the sorted `times` (ns), the innermost recorded span
    open then (an entry of `events`), or None."""
    spans = sorted(events, key=lambda e: (e[1], -e[2]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][1] <= t:
            while stack and stack[-1][2] < spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def span_table(rec, ops, waits=()):
    """Rows per span path of a profiled window: [path, count, host self
    ms, syncs, wait ms, launches, device ms, idle ms]. A device operation
    belongs to the innermost span open at its launch, a wait (`device_ops`)
    to the one open at its start, an idle gap between device operations to
    the one open at its midpoint; those outside every span make the row
    "(none)". Copies and memsets are device time, not launches."""
    rows = {p: [p, n, self_ns / 1e6, syncs, 0.0, 0, 0.0, 0.0]
            for p, (n, _, self_ns, syncs) in rec.paths.items()}

    def row(ev):
        key = ev[0] if ev is not None else "(none)"
        if key not in rows:
            rows[key] = [key, 0, 0.0, 0, 0.0, 0, 0.0, 0.0]
        return rows[key]

    for (t0, t1), ev in zip(waits, innermost(rec.events,
                                             [w[0] for w in waits])):
        row(ev)[4] += (t1 - t0) / 1e6
    launched = sorted((o for o in ops if o[3] is not None),
                      key=lambda o: o[3])
    for o, ev in zip(launched, innermost(rec.events,
                                         [o[3] for o in launched])):
        r = row(ev)
        r[5] += not o[0].startswith(_COPIES)
        r[6] += (o[2] - o[1]) / 1e6
    for o in ops:
        if o[3] is None:
            r = row(None)
            r[5] += not o[0].startswith(_COPIES)
            r[6] += (o[2] - o[1]) / 1e6
    gaps, end = [], None
    for o in ops:
        if end is not None and o[1] > end:
            gaps.append((end + (o[1] - end) // 2, (o[1] - end) / 1e6))
        end = o[2] if end is None else max(end, o[2])
    for (t, ms), ev in zip(gaps, innermost(rec.events,
                                           [g[0] for g in gaps])):
        row(ev)[7] += ms
    return sorted(rows.values(), key=lambda r: -r[2])


def write_span_table(path, rows):
    with open(path, "w") as f:
        f.write("span,count,host_self_ms,syncs,wait_ms,launches,device_ms,"
                "idle_ms\n")
        for p, n, self_ms, syncs, wait_ms, launches, dev_ms, idle_ms in rows:
            f.write(f"{p},{n},{self_ms:.6f},{syncs},{wait_ms:.6f},"
                    f"{launches},{dev_ms:.6f},{idle_ms:.6f}\n")


@contextmanager
def profile_trace(out_dir):
    """Profile the enclosed block with `torch.profiler` (CPU, and CUDA
    where a card is present) and write into out_dir `trace.json`, a Chrome
    trace in which the program's spans are host ranges beside the
    kernels, `spans.csv`, one row per span path (`span_table`: its
    `wait_ms` is the host's time inside the CUDA runtime's calls that
    wait for the card, the part of `host_self_ms` spent waiting), and
    `counters.json`, the recorder's counters: the process-wide recorder
    records the block. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    PROCESS.reset()
    with profile(activities=acts) as prof:
        yield prof
    PROCESS._stop_counting(all_=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    write_span_table(os.path.join(out_dir, "spans.csv"),
                     span_table(PROCESS, *device_ops(prof)))
    with open(os.path.join(out_dir, "counters.json"), "w") as f:
        json.dump(counter_report(PROCESS), f, indent=1)


def counter_report(rec):
    """The counters of a recorder as plain data: `counters`, the live
    member steps, eigensolver calls as [caller, route, B, D, dtype,
    calls], the jobs as [job id, B, N, method], and the span events
    dropped past the first 200,000."""
    return {"counters": dict(rec.counters),
            "live_member_steps": rec.live_member_steps(),
            "eigh_calls": [list(k) + [n]
                           for k, n in sorted(rec.eigh_calls.items())],
            "jobs": [list(j) for j in rec.jobs],
            "dropped_events": rec.dropped}
