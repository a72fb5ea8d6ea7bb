"""Back-to-back single-structure jobs through `optimize`.

Job j starts from entry j mod `pool_size` of a fixed pool, the
configuration's geometry with Gaussian displacements of `start_sigma_ang`
drawn from the mix's `pool_seed`, turned by a random rotation drawn from
the run's seed: every seed runs the same jobs in the same order, and the
numbers differ. A job runs to convergence or the configuration's step cap;
`optimize`'s per-step callback, which fires after the step's own wait on
the card, times each step.
"""

import time

import numpy as np

from gpu_bench.generate import displaced, rng_of, rotation

BATCHED = False


def prepare(traffic):
    traffic.pool = displaced(traffic.x, traffic.config["start_sigma_ang"],
                             rng_of(traffic.mix["pool_seed"]),
                             traffic.mix["pool_size"])


def start(traffic, j, rng):
    """(N, 3) Bohr: the pool's entry, turned about its centre."""
    s = traffic.pool[j % len(traffic.pool)]
    c = s.mean(0)
    return (s - c) @ rotation(rng).T + c


def run(ctx, x, steps=None):
    """(result, seconds of each step, steps the job reports)."""
    from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig, optimize

    cfg = ctx.opt_cfg if steps is None else OptimizeConfig(
        **dict(ctx.optimizer, nsteps=steps))
    times = [time.perf_counter()]
    res = optimize(ctx.calc, x, ctx.z, config=cfg, device=ctx.device,
                   callback=lambda it, st: times.append(time.perf_counter()),
                   dissociation_limit=ctx.dissociation_limit)
    return res, list(np.diff(times)), res.n_iterations
