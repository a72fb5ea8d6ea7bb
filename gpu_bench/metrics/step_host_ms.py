"""Host milliseconds per optimizer step that the step engine and the
driver loop spend themselves: the self time of the program's `step` span
and its `step.*` children (the Hessian update, the projections, the step's
solve less its eigensolver, the acceptance; not `step.calc`, the
calculator's boundary) and of the driver's `loop` span, recorded by the
program (`program_spans.py`)."""

from gpu_bench.program_spans import self_ms_per_step


def read(name, run):
    return self_ms_per_step(run, lambda n: n in ("step", "loop") or (
        n.startswith("step.") and n != "step.calc"))
