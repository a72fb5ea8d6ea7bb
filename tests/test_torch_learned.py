"""Port parity: the learned step-size controllers (GAN and RL) against
multioptpy_tpu/steppers/learned.py.

The MLPs start from the JAX package's initial parameters (jax.random's
stream cannot be reproduced by a torch.Generator), carried into the port's
batched states; their SGD updates take gradients from torch.autograd in
place of jax.grad. Over 5 seeded steps of a batch of 3 (rows from three
reference keys) moves, parameters, replay rings and baselines agree to
1e-10 relative (f64). `rl_step` is given the reference's normal draw. On
the 4-atom Lennard-Jones cluster a GAN run handed over by
`state_from_numpy`'s `fo_state` continues as the reference's."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multioptpy_tpu.calculators.lj import LennardJones as RefLJ
from multioptpy_tpu.steppers import learned as ref
from multioptpy_tpu_torch.calculators.lj import LennardJones
from multioptpy_tpu_torch.steppers import learned

ref_opt = importlib.import_module("multioptpy_tpu.drivers.optimize")
opt = importlib.import_module("multioptpy_tpu_torch.drivers.optimize")

torch.set_num_threads(1)

_B, _D = 3, 9


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-10,
                               atol=1e-13, err_msg=what)


def _stack_rows(states):
    """Per-row reference states -> one tree of batched torch tensors."""
    return jax.tree_util.tree_map(
        lambda *xs: torch.as_tensor(np.stack([np.asarray(x) for x in xs])),
        *states)


def _leaves_close(got, want, what):
    g_leaves = jax.tree_util.tree_leaves(got)
    w_leaves = jax.tree_util.tree_leaves(want)
    assert len(g_leaves) == len(w_leaves), what
    for k, (g, w) in enumerate(zip(g_leaves, w_leaves)):
        _close(g.numpy(), w, f"{what} leaf {k}")


def _stream(seed, n=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((_B, _D))
    e = -3.0 + rng.standard_normal(_B)
    for _ in range(n):
        g = rng.standard_normal((_B, _D)) * 0.4
        yield x.copy(), g, e.copy()
        x = x - 0.2 * g
        e = e - np.abs(rng.standard_normal(_B)) * 0.01 + 0.004


def test_gan_step_from_reference_parameters_matches_reference():
    rows = [ref.gan_init(_D, key=jax.random.PRNGKey(s), buffer_size=4)
            for s in range(_B)]
    s_p = learned.GanState(*_stack_rows(rows))
    s_r = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *rows)
    step_r = jax.jit(jax.vmap(ref.gan_step))
    for k, (x, g, e) in enumerate(_stream(1)):
        base = -0.5 * g
        m_r, s_r = step_r(s_r, jnp.asarray(x), jnp.asarray(g),
                          jnp.asarray(e), jnp.asarray(base))
        m_p, s_p = learned.gan_step(s_p, torch.as_tensor(x),
                                    torch.as_tensor(g), torch.as_tensor(e),
                                    torch.as_tensor(base))
        _close(m_p.numpy(), m_r, f"move {k}")
        _leaves_close(tuple(s_p), tuple(s_r), f"state {k}")


def test_rl_step_with_the_reference_draw_matches_reference():
    rows = [ref.rl_init(_D, key=jax.random.PRNGKey(10 + s))
            for s in range(_B)]
    s_r = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *rows)
    fields = _stack_rows(rows)
    s_p = learned.RlState(*fields)._replace(
        key=torch.Generator().manual_seed(0))
    step_r = jax.jit(jax.vmap(ref.rl_step))
    for k, (_, g, e) in enumerate(_stream(2)):
        base = -0.5 * g
        # the normal draw rl_step takes from its key
        noise = np.array([float(jax.random.normal(jax.random.split(key)[1],
                                                  (), jnp.float64))
                          for key in np.asarray(s_r.key)])
        m_r, s_r = step_r(s_r, jnp.asarray(g), jnp.asarray(e),
                          jnp.asarray(base))
        m_p, s_p = learned.rl_step(s_p, torch.as_tensor(g),
                                   torch.as_tensor(e), torch.as_tensor(base),
                                   noise=torch.as_tensor(noise))
        _close(m_p.numpy(), m_r, f"move {k}")
        for f in ("policy", "baseline", "prev_energy", "prev_summary",
                  "prev_action", "count"):
            _leaves_close(getattr(s_p, f), getattr(s_r, f), f"{f} {k}")


def test_rl_step_draws_from_its_generator():
    """Without `noise` the draw comes from the state's generator: two runs
    from equal seeds agree, and the stream advances."""
    def run():
        s = opt._batched(learned.rl_init(_D), 2)
        s = s._replace(key=torch.Generator().manual_seed(5))
        moves = []
        for _, g, e in _stream(3, n=3):
            g, e = torch.as_tensor(g[:2]), torch.as_tensor(e[:2])
            m, s = learned.rl_step(s, g, e, -0.5 * g)
            moves.append(m)
        return torch.stack(moves)

    a, b = run(), run()
    assert torch.equal(a, b)
    assert not torch.allclose(a[1] / a[0], a[2] / a[1])


_TET = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                float) * 6.6 / np.sqrt(8)
_X0 = _TET + 0.6 * np.random.default_rng(0).standard_normal((4, 3))
_Z = np.array([18, 18, 18, 18])


def test_gan_run_handed_over_by_state_from_numpy_matches_reference():
    """4 GAN steps of the reference on the LJ cluster, then its state (the
    MLPs, the replay ring) goes to the port, and both take 3 more."""
    cfg = ref_opt.OptimizeConfig(method="gan")
    ref_step = jax.jit(ref_opt.make_step_fn(RefLJ(), jnp.asarray(_Z),
                                            config=cfg))
    state = ref_opt.init_state(jnp.asarray(_X0), jnp.asarray(_Z), RefLJ(),
                               config=cfg)
    for _ in range(4):
        state = ref_step(state)
    mine = opt.state_from_numpy(
        jax.tree_util.tree_map(np.asarray, state._asdict()), device="cpu")
    assert isinstance(mine.fo_state[0], learned.GanState)
    step = opt.make_step_fn(LennardJones(device="cpu"), _Z,
                            config=opt.OptimizeConfig(method="gan"))
    for k in range(3):
        state, mine = ref_step(state), step(mine)
        for key in ("coords", "energy", "move"):
            _close(getattr(mine, key)[0].numpy(), getattr(state, key),
                   f"{key} {k}")
        gen = [t[0] for t in jax.tree_util.tree_leaves(mine.fo_state[0].gen)]
        _leaves_close(gen, state.fo_state[0].gen, f"generator {k}")
