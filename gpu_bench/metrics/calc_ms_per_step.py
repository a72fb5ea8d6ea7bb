"""Milliseconds per optimizer step inside the benchmark's span around the
calculator (energy and gradient, and the exact Hessian at a job's start),
each call timed between two synchronizations of the card."""


def read(name, run):
    if not run["steps"]:
        return None
    return run["calc_s"] * 1e3 / run["steps"]
