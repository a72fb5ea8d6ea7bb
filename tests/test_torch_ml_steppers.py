"""Port parity: the ML-style steppers of multioptpy_tpu/steppers/ml.py.

`adam`, `adabelief` and `radam` are written out in the port with optax's
formulas and defaults; over 10 seeded steps on a batch of 3 rows (RAdam's
rectification switches on at step 6) their moves and moments agree with
`optax` itself to 1e-10 relative (f64). Eve agrees with the reference's
`eve_step`. The other six names of OPTAX_STEPPERS raise at their first
step in the reference (ROADMAP Queue 3, F4: its `optax_step` passes no
`params`), and raise a ValueError naming F4 in the port. A mid-run Adam or
Eve state handed over by `state_from_numpy` continues as in the
reference."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multioptpy_tpu.calculators.lj import LennardJones as RefLJ
from multioptpy_tpu.steppers import ml as ref
from multioptpy_tpu_torch.calculators.lj import LennardJones
from multioptpy_tpu_torch.steppers import ml

ref_opt = importlib.import_module("multioptpy_tpu.drivers.optimize")
opt = importlib.import_module("multioptpy_tpu_torch.drivers.optimize")

torch.set_num_threads(1)

_B, _D = 3, 9


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-10,
                               atol=1e-14, err_msg=what)


def _gradients(seed, n=10):
    rng = np.random.default_rng(seed)
    scale = np.array([1.0, 1e-3, 30.0])[:, None]
    for _ in range(n):
        yield rng.standard_normal((_B, _D)) * scale


@pytest.mark.parametrize("name", ml.PORTED_OPTAX)
def test_ported_optax_rules_match_optax(name):
    tx = getattr(optax, name)(0.05)
    s_r = [tx.init(jnp.zeros(_D)) for _ in range(_B)]
    s_p = jax.tree_util.tree_map(
        lambda a: torch.as_tensor(np.stack([a] * _B)),
        ml.optax_init(name, _D))
    s_p = ml.OptaxState(*(torch.as_tensor(a) for a in s_p))
    for k, g in enumerate(_gradients(1)):
        move, s_p = ml.optax_step(name, s_p, torch.as_tensor(g), lr=0.05)
        for i in range(_B):
            want, s_r[i] = tx.update(jnp.asarray(g[i]), s_r[i])
            _close(move[i].numpy(), want, f"move {k} row {i}")
            for f in ("count", "mu", "nu"):
                _close(getattr(s_p, f)[i].numpy(), getattr(s_r[i][0], f),
                       f"{f} {k} row {i}")


def test_eve_matches_reference():
    step_r = jax.vmap(ref.eve_step)
    s_r = jax.tree_util.tree_map(lambda a: jnp.stack([a] * _B),
                                 ref.eve_init(_D))
    s_p = ml.EveState(*(torch.as_tensor(np.array(a)) for a in s_r))
    rng = np.random.default_rng(2)
    for k, g in enumerate(_gradients(3)):
        e = -5.0 + rng.standard_normal(_B)
        m_r, s_r = step_r(s_r, jnp.asarray(g), jnp.asarray(e))
        m_p, s_p = ml.eve_step(s_p, torch.as_tensor(g), torch.as_tensor(e))
        _close(m_p.numpy(), m_r, f"move {k}")
        for f, got, want in zip(s_r._fields, s_p, s_r):
            _close(got.numpy(), want, f"{f} {k}")


_F4 = [n for n in ref.OPTAX_STEPPERS if n not in ml.PORTED_OPTAX]


def test_f4_names_are_the_reference_names():
    assert ml.OPTAX_STEPPERS == ref.OPTAX_STEPPERS
    assert sorted(_F4) == sorted(["lars", "lamb", "lion", "adamw", "prodigy",
                                  "lookahead_adam"])


@pytest.mark.parametrize("name", _F4)
def test_f4_names_raise_in_both(name):
    """ROADMAP Queue 3, F4: the reference raises at the first step
    (ValueError 'requires the current value of parameters', TypeError for
    lookahead_adam); the port raises a ValueError that names F4."""
    g = np.ones(_D)
    with pytest.raises((ValueError, TypeError)):
        ref.optax_step(name, ref.optax_init(name, _D), jnp.asarray(g))
    state = opt._batched(ml.optax_init(name, _D), 1)
    with pytest.raises(ValueError, match="F4"):
        ml.optax_step(name, state, torch.as_tensor(g[None]))
    with pytest.raises(ValueError, match="unknown optax stepper"):
        ml.optax_init("sgd_nesterov", _D)


_TET = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                float) * 6.6 / np.sqrt(8)
_X0 = _TET + 0.6 * np.random.default_rng(0).standard_normal((4, 3))
_Z = np.array([18, 18, 18, 18])


@pytest.mark.parametrize("method", ["adam", "radam", "eve"])
def test_state_handed_over_mid_run_continues_as_reference(method):
    cfg_kw = dict(method=method)
    ref_cfg = ref_opt.OptimizeConfig(**cfg_kw)
    ref_step = jax.jit(ref_opt.make_step_fn(RefLJ(), jnp.asarray(_Z),
                                            config=ref_cfg))
    state = ref_opt.init_state(jnp.asarray(_X0), jnp.asarray(_Z), RefLJ(),
                               config=ref_cfg)
    for _ in range(3):
        state = ref_step(state)
    fields = jax.tree_util.tree_map(np.asarray, state._asdict())
    mine = opt.state_from_numpy(fields, device="cpu")
    step = opt.make_step_fn(LennardJones(device="cpu"), _Z,
                            config=opt.OptimizeConfig(**cfg_kw))
    for _ in range(2):
        state, mine = ref_step(state), step(mine)
        for key in ("coords", "energy", "move"):
            _close(getattr(mine, key)[0].numpy(), getattr(state, key), key)
