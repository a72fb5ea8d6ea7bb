"""The device trace of a traced run: torch.profiler over the card alone,
reduced from its raw events (the profiler's aggregated tables take seconds
to build over hundreds of thousands of launches).

`summarize` gives what the per-layer readers and the result line take:
kernel launches, device time by kernel name, the busy time (the union of
kernel and copy intervals), and the longest idle gaps, each named by what
the host was doing then (inside the calculator's span, in the optimization
driver between spans, or in the harness between jobs) and by the device
operation that ended it.
"""

import time

import torch

COPIES = ("Memcpy", "Memset")


class Trace:
    """A context that profiles the card and records the window's ends."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t0, self.w0 = time.perf_counter(), time.time_ns()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.w1 = time.time_ns()
        self.prof.__exit__(*exc)
        return False

    def events(self):
        """[(name, start_ns, end_ns)] of the device's operations, by start."""
        out = []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                out.append((ev.name(), ev.start_ns(), ev.end_ns()))
        out.sort(key=lambda e: e[1])
        return out


def _label(t_ns, spans, jobs):
    """What the host was doing at t_ns: 'calculator', 'driver' or
    'harness'."""
    if any(a <= t_ns <= b for a, b in spans):
        return "calculator"
    if any(a <= t_ns <= b for a, b in jobs):
        return "driver"
    return "harness"


def summarize(events, window_s, spans_ns=(), jobs_ns=(), top=10):
    """Launch count, device time by name, busy seconds and the longest idle
    gaps of a list of (name, start_ns, end_ns)."""
    by_name = {}
    launches = 0
    busy_ns, cur_a, cur_b = 0, None, None
    gaps = []
    for name, a, b in events:
        if not name.startswith(COPIES):
            launches += 1
        cnt, dur = by_name.get(name, (0, 0))
        by_name[name] = (cnt + 1, dur + (b - a))
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy_ns += cur_b - cur_a
                gaps.append((a - cur_b, cur_b, name))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy_ns += cur_b - cur_a
    gaps.sort(reverse=True)
    idle = [[f"{_label(t + g // 2, spans_ns, jobs_ns)} before {n[:60]}",
             g / 1e9] for g, t, n in gaps[:top]]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {
        "launches": launches,
        "kernel_s": {n: d / 1e9 for n, (_, d) in by_name.items()},
        "busy_s": busy_ns / 1e9,
        "window_s": window_s,
        "device_ops": [[n[:120], d / 1e9] for n, (_, d) in ops[:top]],
        "idle_gaps": idle,
    }
