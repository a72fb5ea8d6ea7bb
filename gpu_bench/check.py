"""Whether the timed path's answers were right, judged against the plain
reference (`reference/`) after the window has closed.

The configuration names its reference by key: `reference.calculator` is a
module `reference/<name>.py` with `model(config, device)`,
`energy_and_gradient(x, model)` and `hessian(x, model)`, and
`reference.method` a module `reference/<name>.py` with `job_gaps(record,
result, config, calc_ref, model)` and `missing(record, steps)`. A new
calculator or method is a new file there. The numbers compared are the
keys of the configuration's `limits`, and `missing_steps`, with the limit
0: steps the program reports for which the calculator gave no answer,
over every job of the window.

A sample of the window's jobs, drawn from the seed (for single-structure
jobs the longest and two more; for rounds, one round with all its
structures), is compared in full. For rfo_fsb on SQM2 (`reference/rfo.py`,
`reference/sqm2.py`):

* energy_gap, gradient_gap -- the program's energy and gradient at every
  geometry it evaluated against the reference's (Ha, Ha/Bohr);
* hessian_gap -- the exact Hessian a job starts from against the
  reference's own (Ha/Bohr^2);
* step_gap -- every trial geometry against the one the reference's step
  works out from its own state (`reference/rfo.replay`), and the job's
  final geometry against the reference's (Bohr).

A number that is not finite fails.
"""

import importlib

import numpy as np


def references(config):
    """(calculator module, method module) the configuration names."""
    ref = config["reference"]
    return tuple(importlib.import_module(f"gpu_bench.reference.{ref[k]}")
                 for k in ("calculator", "method"))


def sample(lengths, seed, batch):
    """The indices of the jobs compared: one round of a batch traffic, the
    longest and two more single-structure jobs, drawn from the seed."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, 7])
    if batch:
        return [int(rng.integers(len(lengths)))]
    longest = int(np.argmax(lengths))
    rest = [j for j in range(len(lengths)) if j != longest]
    pick = rng.choice(len(rest), size=min(2, len(rest)), replace=False)
    return [longest] + [rest[int(i)] for i in sorted(pick)]


def compare(records, results, steps, config, seed, batch, device):
    """The numbers compared: `records` are the calculator's answers per job
    (`spans.SpanCalc.jobs`), `results` what the program's entry returned
    for each job, and `steps` the steps each job reports."""
    calc_ref, method = references(config)
    model = calc_ref.model(config, device)
    gaps = dict.fromkeys(config["limits"], 0.0)
    gaps["missing_steps"] = float(sum(
        method.missing(r, n) for r, n in zip(records, steps)))
    for j in sample([len(r) for r in records], seed, batch):
        for k, v in method.job_gaps(records[j], results[j], config,
                                    calc_ref, model).items():
            gaps[k] = max(gaps[k], v)
    return gaps


def judge(gaps, limits):
    """(correct, {name: {"value", "limit"}})."""
    limits = dict(limits, missing_steps=0)
    out = {k: {"value": gaps[k], "limit": limits[k]} for k in limits}
    return all(v["value"] <= v["limit"] for v in out.values()), out
