"""Port parity: the DIIS family against multioptpy_tpu/steppers/diis.py.

Three rows run 8 steps of seeded geometries, energies, gradients and
quasi-Newton steps through each engine (histories of 5 and 6 wrap), in the
port on the batch and in the reference `vmap`ped. GDIIS, GEDIIS, KDIIS and
C2DIIS moves and states agree to 1e-10 relative (f64). EDIIS and ADIIS
take their coefficients from `_simplex_qp`, 400 fixed exponentiated-
gradient iterations from M + 1 starts: they agree to 1e-9, as do the
simplex coefficients themselves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.steppers import diis as ref
from multioptpy_tpu_torch.steppers import diis

torch.set_num_threads(1)

_B, _D = 3, 9


def _close(got, want, what, tol=1e-10):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=1e-13, err_msg=what)


def _stream(seed, n=8):
    """(x, energy, gradient, plain step) of a descent on a quadratic."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((_B, _D, _D))
    h = a @ a.transpose(0, 2, 1) / _D + 0.3 * np.eye(_D)
    x = rng.standard_normal((_B, _D))
    for _ in range(n):
        g = np.einsum("bij,bj->bi", h, x) + 0.01 * rng.standard_normal(
            (_B, _D))
        e = 0.5 * np.einsum("bi,bi->b", x, g) - 3.0
        step = -0.4 * g + 0.02 * rng.standard_normal((_B, _D))
        yield x.copy(), e, g, step
        x = x + 0.7 * step


def _tile(state):
    return jax.tree_util.tree_map(lambda a: jnp.stack([a] * _B), state)


def _to_torch(state):
    return type(state)(*(torch.as_tensor(np.array(a)) for a in state))


_ENGINES = {
    "gdiis": (lambda d: ref.diis_init(d), diis.gdiis_step,
              ref.gdiis_step, lambda x, e, g, s: (x, s, s), 1e-10),
    "gediis": (lambda d: ref.gediis_init(d), diis.gediis_step,
               ref.gediis_step, lambda x, e, g, s: (x, e, g, s), 1e-9),
    "kdiis": (lambda d: ref.kdiis_init(d), diis.kdiis_step,
              ref.kdiis_step, lambda x, e, g, s: (x, g, s), 1e-10),
    "ediis": (lambda d: ref.gediis_init(d), diis.ediis_step,
              ref.ediis_step, lambda x, e, g, s: (x, e, g, s), 1e-9),
    "adiis": (lambda d: ref.gediis_init(d), diis.adiis_step,
              ref.adiis_step, lambda x, e, g, s: (x, e, g, s), 1e-9),
    "c2diis": (lambda d: ref.gediis_init(d), diis.c2diis_step,
               ref.c2diis_step, lambda x, e, g, s: (x, e, g, s), 1e-10),
}


@pytest.mark.parametrize("name", sorted(_ENGINES))
def test_diis_engine_matches_reference(name):
    init, step_p, step_r, args, tol = _ENGINES[name]
    step_r = jax.vmap(step_r)
    s_r = _tile(init(_D))
    s_p = _to_torch(s_r)
    for k, fields in enumerate(_stream(11)):
        m_r, s_r = step_r(s_r, *(jnp.asarray(a) for a in args(*fields)))
        m_p, s_p = step_p(s_p, *(torch.as_tensor(a) for a in args(*fields)))
        _close(m_p.numpy(), m_r, f"move {k}", tol)
        for f, got, want in zip(s_r._fields, s_p, s_r):
            _close(got.numpy(), want, f"{f} {k}", tol)


def test_port_initial_states_are_the_reference_ones():
    for init_p, init_r in ((diis.diis_init, ref.diis_init),
                           (diis.gediis_init, ref.gediis_init),
                           (diis.kdiis_init, ref.kdiis_init)):
        got, want = init_p(_D), init_r(_D)
        assert got._fields == want._fields
        for f, g, w in zip(want._fields, got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f)


def _qp_problem(seed, m=5):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((_B, m, m))
    b = a + a.transpose(0, 2, 1)          # indefinite, as EDIIS's can be
    lin = rng.standard_normal((_B, m))
    return b, lin


def test_simplex_qp_matches_reference():
    b, lin = _qp_problem(12)
    got = diis._simplex_qp(torch.as_tensor(b), torch.as_tensor(lin))
    want = jax.vmap(ref._simplex_qp)(jnp.asarray(b), jnp.asarray(lin))
    _close(got.numpy(), want, "coefficients", 1e-9)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=0, atol=1e-12)
    assert (got >= 0).all()


def test_coefficient_rules_match_reference():
    rng = np.random.default_rng(13)
    m = 5
    x = rng.standard_normal((_B, m, _D))
    g = rng.standard_normal((_B, m, _D))
    e = rng.standard_normal((_B, m))
    valid = np.array([[True] * 5, [True] * 3 + [False] * 2,
                      [True, True] + [False] * 3])
    xn, gn = rng.standard_normal((2, _B, _D))
    t = torch.as_tensor
    j = jnp.asarray
    _close(diis.ediis_coefficients(t(e), t(x), t(g), t(valid)).numpy(),
           jax.vmap(ref.ediis_coefficients)(j(e), j(x), j(g), j(valid)),
           "ediis", 1e-9)
    _close(diis.adiis_coefficients(t(e), t(x), t(g), t(valid), t(xn),
                                   t(gn)).numpy(),
           jax.vmap(ref.adiis_coefficients)(j(e), j(x), j(g), j(valid),
                                            j(xn), j(gn)), "adiis", 1e-9)
    vm = valid.astype(float)
    _close(diis.c2diis_coefficients(t(g), t(vm)).numpy(),
           jax.vmap(ref.c2diis_coefficients)(j(g), j(vm)), "c2diis")
    _close(diis._bordered_diis_coefficients(t(g), t(vm)).numpy(),
           jax.vmap(ref._bordered_diis_coefficients)(j(g), j(vm)),
           "bordered")
