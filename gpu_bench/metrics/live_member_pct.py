"""The share of the structures that the batched driver's steps hand the
calculator that are members not yet converged, in percent: the rest are
frozen members that the lockstep round carries through the calculator to
its last step, work whose answer is thrown away. Counted by the program's
step (`program_spans.py`): the live member steps over the structures
evaluated, so a step that leaves frozen members out of the calculator's
batch reads higher."""

from gpu_bench.program_spans import recorder


def read(name, run):
    rec = recorder()
    evaluated = rec.counters.get("step_structures", 0) if rec else 0
    if not evaluated:
        return None
    return 100.0 * rec.live_member_steps() / evaluated
