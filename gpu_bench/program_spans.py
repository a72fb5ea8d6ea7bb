"""The program's own spans and counters, as the per-layer readers take
them: the port's process-wide recorder (`multioptpy_tpu_torch.logging_utils
.PROCESS`), which records while a torch.profiler records, so in a traced
run exactly over the traced window. A program without that recorder, or a
recorder that recorded nothing, gives None."""


def recorder():
    """The process-wide recorder, or None where there is none or it holds
    no span."""
    try:
        from multioptpy_tpu_torch import logging_utils
    except ImportError:
        return None
    rec = getattr(logging_utils, "PROCESS", None)
    if rec is None or not getattr(rec, "paths", None):
        return None
    return rec


def self_ms_per_step(run, keep):
    """Milliseconds of host self time per optimizer step in the spans
    whose name `keep(name)` accepts, or None."""
    rec = recorder()
    if rec is None or not run["steps"]:
        return None
    ns = sum(row[2] for name, row in rec.by_name().items() if keep(name))
    return ns / 1e6 / run["steps"]
