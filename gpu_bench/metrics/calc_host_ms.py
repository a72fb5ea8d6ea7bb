"""Host milliseconds per optimizer step inside the calculator itself: the
self time of the program's `calc` span and its `calc.*` and `sqm.*`
children (a job's exact Hessian included), recorded by the program
(`program_spans.py`). Unlike `calc_ms_per_step` it lies inside the
benchmark's synchronizations around each call, so it leaves them out."""

from gpu_bench.program_spans import self_ms_per_step


def read(name, run):
    return self_ms_per_step(run, lambda n: n == "calc" or n.startswith(
        ("calc.", "sqm.")))
