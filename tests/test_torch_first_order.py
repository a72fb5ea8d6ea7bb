"""Port parity: the first-order step engines (FIRE family, CG, L-BFGS, SD)
against multioptpy_tpu/steppers/first_order.py.

A batch of 3 rows runs 6 steps of seeded geometries and gradients through
the port and through the reference `vmap`ped; moves and every state field
agree to 1e-10 relative (f64). Rows start at different steps, so a row's
first (steepest-descent) branch and another row's later branch are taken
in one call, as the per-row selects must."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.steppers import first_order as ref
from multioptpy_tpu_torch.steppers import first_order as fo

torch.set_num_threads(1)

_B, _D = 3, 9


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10,
                               atol=1e-14, err_msg=what)


def _states_close(got, want):
    for name, g, w in zip(want._fields, got, want):
        _close(g.numpy(), w, name)


def _stream(seed, n=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((_B, _D))
    for _ in range(n):
        g = rng.standard_normal((_B, _D)) * 0.3
        x = x - 0.1 * g + 0.02 * rng.standard_normal((_B, _D))
        yield x.copy(), g


def _tile_ref(state):
    return jax.tree_util.tree_map(lambda a: jnp.stack([a] * _B), state)


def _to_torch(state):
    return type(state)(*(torch.as_tensor(np.array(a)) for a in state))


@pytest.mark.parametrize("name", ["fire", "fire2", "abc_fire"])
def test_fire_family_matches_reference(name):
    step_r = jax.vmap(getattr(ref, f"{name}_step"))
    step_p = getattr(fo, f"{name}_step")
    s_r = _tile_ref(ref.fire_init(_D))
    s_p = _to_torch(s_r)
    for _, g in _stream(1, n=10):
        m_r, s_r = step_r(s_r, jnp.asarray(g))
        m_p, s_p = step_p(s_p, torch.as_tensor(g))
        _close(m_p.numpy(), m_r, "move")
        _states_close(s_p, s_r)


@pytest.mark.parametrize("variant", ["pr", "fr", "hs", "dy", "hz"])
def test_cg_matches_reference(variant):
    step_r = jax.vmap(lambda s, g: ref.cg_step(s, g, variant=variant,
                                               delta=0.7))
    s_r = _tile_ref(ref.cg_init(_D))
    # row 2 starts later: its first call is the steepest-descent branch
    s_r = s_r._replace(initialized=jnp.array([True, True, False]),
                       direction=s_r.direction.at[:2].set(0.1),
                       prev_gradient=s_r.prev_gradient.at[:2].set(0.2))
    s_p = _to_torch(s_r)
    for _, g in _stream(2):
        m_r, s_r = step_r(s_r, jnp.asarray(g))
        m_p, s_p = fo.cg_step(s_p, torch.as_tensor(g), variant=variant,
                              delta=0.7)
        _close(m_p.numpy(), m_r, "move")
        _states_close(s_p, s_r)


def test_cg_unknown_variant_raises():
    s = fo.CgState(*(torch.zeros(1, _D) for _ in range(2)),
                   torch.ones(1, dtype=torch.bool))
    with pytest.raises(ValueError, match="unknown CG variant"):
        fo.cg_step(s, torch.ones(1, _D), variant="xx")


@pytest.mark.parametrize("history", [12, 3])
def test_lbfgs_matches_reference(history):
    """The ring wraps (history 3 over 10 steps); one row sees a pair with
    s.y ~ 0 and does not admit it."""
    step_r = jax.vmap(lambda s, x, g: ref.lbfgs_step(s, x, g, delta=0.8))
    s_r = _tile_ref(ref.lbfgs_init(_D, history=history))
    s_p = _to_torch(s_r)
    for i, (x, g) in enumerate(_stream(3, n=10)):
        if i == 4:
            x[1] = np.asarray(s_r.prev_geometry[1])   # s = 0 for row 1
        m_r, s_r = step_r(s_r, jnp.asarray(x), jnp.asarray(g))
        m_p, s_p = fo.lbfgs_step(s_p, torch.as_tensor(x),
                                 torch.as_tensor(g), delta=0.8)
        _close(m_p.numpy(), m_r, "move")
        _states_close(s_p, s_r)
    assert int(s_p.count[1]) < int(s_p.count[0])


def test_sd_and_mass_weighted_sd_match_reference():
    rng = np.random.default_rng(4)
    g = rng.standard_normal((_B, _D))
    m3 = np.repeat(rng.uniform(1.0, 40.0, (_B, _D // 3)), 3, axis=1)
    _close(fo.sd_step(torch.as_tensor(g), 0.3).numpy(),
           ref.sd_step(jnp.asarray(g), 0.3), "sd")
    want = jax.vmap(lambda gg, mm: ref.mwsd_step(gg, mm, 2.0))(
        jnp.asarray(g), jnp.asarray(m3))
    _close(fo.mwsd_step(torch.as_tensor(g), torch.as_tensor(m3),
                        2.0).numpy(), want, "mwsd")
