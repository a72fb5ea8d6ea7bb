"""Implicit host synchronizations of the card per optimizer step, summed
over the program's spans: the driver's deliberate reads (`wait`), the
eigensolvers' error checks, blocking host-to-device copies; counted by
torch's sync debug mode while the program's recorder records
(`program_spans.py`). Explicit torch.cuda.synchronize() calls, such as the
benchmark's own around the calculator, are not counted."""

from gpu_bench.program_spans import recorder


def read(name, run):
    rec = recorder()
    if rec is None or not run["steps"]:
        return None
    return sum(row[3] for row in rec.by_name().values()) / run["steps"]
