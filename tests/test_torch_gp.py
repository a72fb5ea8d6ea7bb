"""Port parity: the Gaussian-process stepper (GPmin) against
multioptpy_tpu/steppers/gp.py.

The port writes the RBF kernel's value and derivative blocks in closed
form (the reference takes them from jax.grad/jacfwd); the posterior mean
over a part-filled and a wrapped history agrees with the reference to
1e-10 relative (f64). `gp_step` is 30 fixed descent iterations on the
surrogate in both, with and without the inverse-distance descriptor: 5
steps of a batch of 3 agree to 1e-8 relative to the largest entry (the
fit's 1e-8 nugget lets its condition number reach ~1e8, and the moves
differ by ~3e-9 relative from the fourth step on), the first one the
steepest-descent fallback (fewer than 2 observations)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.steppers import gp as ref
from multioptpy_tpu_torch.steppers import gp

torch.set_num_threads(1)

_B, _N = 3, 4
_D = 3 * _N


def _close(got, want, what, tol=1e-10):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=1e-13, err_msg=what)


def _history(seed, m=6, counts=(2, 6, 9)):
    rng = np.random.default_rng(seed)
    st = ref.gp_init(_D, history=m)
    states = []
    for c in counts:
        states.append(st._replace(
            x_hist=jnp.asarray(rng.standard_normal((m, _D)) * 0.5),
            e_hist=jnp.asarray(rng.standard_normal(m)),
            g_hist=jnp.asarray(rng.standard_normal((m, _D)) * 0.3),
            count=jnp.asarray(c, jnp.int32)))
    return states


def _stack(states):
    return gp.GpState(*(torch.as_tensor(np.stack([np.asarray(s[i])
                                                  for s in states]))
                        for i in range(4)))


def test_rbf_and_posterior_energy_match_reference():
    states = _history(1)
    q = np.random.default_rng(2).standard_normal((_B, _D)) * 0.5
    got = gp.gp_posterior_energy(torch.as_tensor(q), _stack(states),
                                 lengthscale=1.3)
    for i, st in enumerate(states):
        _close(got[i].numpy(),
               ref.gp_posterior_energy(jnp.asarray(q[i]), st,
                                       lengthscale=1.3), f"row {i}")
    a, b = np.random.default_rng(3).standard_normal((2, _D))
    _close(gp._rbf(torch.as_tensor(a), torch.as_tensor(b), 0.7).numpy(),
           ref._rbf(jnp.asarray(a), jnp.asarray(b), 0.7), "rbf")


def test_inverse_distance_descriptor_matches_reference():
    phi_p, n_p = gp.inv_dist_descriptor(_N, min_dist=1.0)
    phi_r, n_r = ref.inv_dist_descriptor(_N, min_dist=1.0)
    assert n_p == n_r == 6
    x = np.random.default_rng(4).standard_normal((_B, _D))
    got = phi_p(torch.as_tensor(x))
    for i in range(_B):
        _close(got[i].numpy(), phi_r(jnp.asarray(x[i])), f"row {i}")


@pytest.mark.parametrize("descriptor", [False, True])
def test_gp_step_matches_reference(descriptor):
    phi_p = gp.inv_dist_descriptor(_N)[0] if descriptor else None
    phi_r = ref.inv_dist_descriptor(_N)[0] if descriptor else None
    dim = 6 if descriptor else _D
    step_r = jax.vmap(lambda s, x, e, g: ref.gp_step(s, x, e, g,
                                                     phi_fn=phi_r))
    s_r = jax.tree_util.tree_map(lambda a: jnp.stack([a] * _B),
                                 ref.gp_init(dim, history=4))
    s_p = gp.GpState(*(torch.as_tensor(np.array(a)) for a in s_r))
    rng = np.random.default_rng(5)
    x = np.tile(np.array([[0, 0, 0], [2.2, 0, 0], [0, 2.1, 0],
                          [0, 0, 2.3]], float).reshape(-1), (_B, 1))
    x = x + 0.1 * rng.standard_normal((_B, _D))
    for k in range(5):
        # a soft pair potential's energy and gradient: the surrogate has
        # structure to fit, and the 30 descent steps on it (rate 0.2)
        # contract; on a stiff one they oscillate, and rounding differences
        # of 1e-12 in the fit grow to 1e-2 in either package
        c = x.reshape(_B, _N, 3)
        d = c[:, :, None] - c[:, None]
        r = np.linalg.norm(d, axis=-1) + np.eye(_N)
        e = 0.01 * ((r - 2.2) ** 2 * (1 - np.eye(_N))).sum((1, 2))
        g = (0.04 * ((r - 2.2) / r)[..., None] * d
             * (1 - np.eye(_N))[..., None]).sum(2).reshape(_B, _D)
        m_r, s_r = step_r(s_r, jnp.asarray(x), jnp.asarray(e),
                          jnp.asarray(g))
        m_p, s_p = gp.gp_step(s_p, torch.as_tensor(x), torch.as_tensor(e),
                              torch.as_tensor(g), phi_fn=phi_p)
        for f, got, want in zip(("move",) + s_r._fields, (m_p,) + s_p,
                                (m_r,) + s_r):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.numpy(), want, rtol=1e-8,
                atol=1e-8 * np.abs(want).max(), err_msg=f"{f} {k}")
        x = x + np.asarray(m_r)
