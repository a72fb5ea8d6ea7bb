"""Kernel launches per optimizer step in the traced window (copies and
memsets left out), the benchmark's copies of each answer included; a
batch cell's step is one step of the whole batch."""


def read(name, run):
    if not run["steps"]:
        return None
    return run["trace"]["launches"] / run["steps"]
