"""Host milliseconds per optimizer step inside the seminumerical Hessian a
job starts from: the inclusive time of the program's `calc.hessian` spans
(building the 6N displaced structures, their batched gradient with its
`calc.forward`, `calc.backward` and `sqm.*` spans, the central
difference), spread over the steps as `step_ms` spreads the job's start;
recorded by the program (`program_spans.py`). A program without the span
gives None."""

from gpu_bench.program_spans import recorder


def read(name, run):
    rec = recorder()
    row = rec.by_name().get("calc.hessian") if rec is not None else None
    if row is None or not run["steps"]:
        return None
    return row[1] / 1e6 / run["steps"]
