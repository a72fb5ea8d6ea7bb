"""The benchmark's span around the calculator layer.

`SpanCalc` forwards every call to the calculator the program would use and
is what the benchmark hands to `optimize` and `optimize_batch`. It counts
calls and the structures they evaluate, keeps a copy of every answer (the
geometries, energies, gradients and the exact Hessian) for the comparison
with the reference after the window, and in a traced run times each call
between two synchronizations of the card.
"""

import time

import torch


class SpanCalc:
    """A forwarding wrapper of `inner` (an SQM calculator)."""

    def __init__(self, inner, timed=False):
        self.inner = inner
        self.timed = timed
        self.jobs = []          # per job: ("eg"|"hess", coords, outputs...)
        self.gradients = 0      # structures whose energy and gradient ran
        self.span_s = 0.0       # seconds inside calls (timed runs only)
        self.spans_ns = []      # (start, end) of each call, time.time_ns()

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def begin_job(self):
        self.jobs.append([])

    def _span(self, fn):
        if not self.timed:
            return fn()
        torch.cuda.synchronize()
        t0, w0 = time.perf_counter(), time.time_ns()
        out = fn()
        torch.cuda.synchronize()
        self.span_s += time.perf_counter() - t0
        self.spans_ns.append((w0, time.time_ns()))
        return out

    def energy_and_gradient(self, coords, z):
        e, g = self._span(lambda: self.inner.energy_and_gradient(coords, z))
        self.gradients += coords.shape[0]
        self.jobs[-1].append(("eg", coords.detach().clone(), e.clone(),
                              g.clone()))
        return e, g

    def hessian(self, coords, z):
        h = self._span(lambda: self.inner.hessian(coords, z))
        # the seminumerical Hessian: two displaced gradients per coordinate
        self.gradients += coords.shape[0] * 6 * coords.shape[1]
        self.jobs[-1].append(("hess", coords.detach().clone(), h.clone()))
        return h
