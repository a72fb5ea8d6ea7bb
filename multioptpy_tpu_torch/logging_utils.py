"""Run logging and per-stage timing.

Counterpart of `multioptpy_tpu/logging_utils.py`: `RunLogger` collects
per-iteration scalars into `run_log.csv` and the values of tracked
internal coordinates (`-gi`) into `geometry_params.csv`;
`snapshot_config` writes `input.json`, the record of every option of a
run; `StageTimer` times the stages of a driver loop, synchronizing the
card before it closes a stage that was given a CUDA tensor;
`profile_trace` wraps `torch.profiler` and writes a Chrome trace.

`make_callback` takes the optimize driver's state, a batch of one: each
per-step `float()` is one host synchronization, as in the reference.
"""

from contextlib import contextmanager
import collections
import dataclasses
import json
import os
import time

import numpy as np
import torch


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


class StageTimer:
    """Per-stage wall-clock timers for driver loops.

        timer = StageTimer()
        with timer.stage("step", block=state.energy):
            ...
        timer.report()   # {"step": {"total_s", "count", "mean_ms"}, ...}

    Launches return before the card finishes: `stage(..., block=x)`
    synchronizes x's device before closing the timer when x is a CUDA
    tensor, so device work counts to the stage that launched it."""

    def __init__(self):
        self.totals = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)

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


@contextmanager
def profile_trace(out_dir):
    """Profile the enclosed block with `torch.profiler` (CPU, and CUDA
    where a card is present) and write `trace.json`, a Chrome trace, into
    out_dir. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
