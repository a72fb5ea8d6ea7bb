"""Rounds of `batch` structures relaxed together by one `optimize_batch`
call of the mix's `steps` steps (the driver runs them all, in lockstep).

`start` is "displace" (Gaussian displacements of the configuration's
`start_sigma_ang`) or "orient" (rigid placements of the configuration's
`mobile_fragment`, `distance_ang` from the rest and shifted by up to
`max_shift_bohr`, drawn as the program's orientation search draws them),
each round from the run's seed and the round's index. `optimize_batch`
has no per-step hook, so a round gives no step times.
"""

from gpu_bench.generate import displaced, orientations

BATCHED = True


def prepare(traffic):
    pass


def start(traffic, j, rng):
    """(B, N, 3) Bohr: the round's starting geometries."""
    mix, cfg = traffic.mix, traffic.config
    if mix["start"] == "displace":
        return displaced(traffic.x, cfg["start_sigma_ang"], rng, mix["batch"])
    return orientations(traffic.x, cfg["mobile_fragment"], mix["batch"],
                        mix["max_shift_bohr"], mix["distance_ang"], rng)


def run(ctx, x, steps=None):
    """(result, no step times, steps of the round)."""
    from multioptpy_tpu_torch.drivers.optimize import optimize_batch

    res = optimize_batch(ctx.calc, x, ctx.z, config=ctx.opt_cfg,
                         n_steps=steps or ctx.mix["steps"],
                         device=ctx.device)
    return res, [], res.n_iterations
