"""Port parity: the block (multi-secant) Hessian updates against
multioptpy_tpu/hessian/block_updates.py.

Three rows take 8 seeded (s, y) pairs through a window of 4 (the ring
wraps twice); the first push takes the rank-2 rule. Each pair comes from a
different SPD curvature (a surface that is not quadratic), so the SR1
residual R = Y - H S stays away from zero and R^T S well conditioned: on a
quadratic with noise the block SR1 solve amplifies rounding by cond(R^T S)
~1e6 in either package. Every rule of `_BLOCK_RULES` and the double-damped
`_dd` forms run in the port on the batch and in the reference `vmap`ped:
Hessians and windows agree to 1e-10 relative to their largest entry
(f64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.hessian import block_updates as ref
from multioptpy_tpu_torch.hessian import block_updates as bu

torch.set_num_threads(1)

_B, _D, _W = 3, 9, 4


def _pairs(seed, n=8):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        a = rng.standard_normal((_B, _D, _D))
        curv = a @ a.transpose(0, 2, 1) / _D + 0.5 * np.eye(_D)
        s = 0.1 * rng.standard_normal((_B, _D))
        yield s, np.einsum("bij,bj->bi", curv, s)


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                               atol=1e-10 * max(np.abs(want).max(), 1.0),
                               err_msg=what)


@pytest.mark.parametrize("rule", sorted(ref._BLOCK_RULES)
                         + ["block_bfgs_dd", "block_fsb_dd"])
def test_block_update_matches_reference(rule):
    step_r = jax.vmap(lambda h, w, s, y: ref.block_update_hessian(
        h, w, s, y, rule))
    win_r = jax.tree_util.tree_map(lambda a: jnp.stack([a] * _B),
                                   ref.block_window_init(_D, window=_W))
    win_p = bu.BlockWindow(*(torch.as_tensor(np.array(a)) for a in win_r))
    h_r = jnp.asarray(np.tile(np.eye(_D), (_B, 1, 1)))
    h_p = torch.as_tensor(np.array(h_r))
    for k, (s, y) in enumerate(_pairs(2)):
        h_r, win_r = step_r(h_r, win_r, jnp.asarray(s), jnp.asarray(y))
        h_p, win_p = bu.block_update_hessian(h_p, win_p, torch.as_tensor(s),
                                             torch.as_tensor(y), rule)
        _close(h_p, h_r, f"hessian after pair {k}")
        for name, got, want in zip(win_r._fields, win_p, win_r):
            _close(got, want, f"{name} after pair {k}")


def test_window_init_and_push_match_reference():
    """The port's unbatched init is the reference's; a batched push writes
    each row's ring slot (rows at different counts)."""
    init_r = ref.block_window_init(_D, window=_W)
    init_p = bu.block_window_init(_D, window=_W)
    for name, got, want in zip(init_r._fields, init_p, init_r):
        assert got.shape == tuple(want.shape), name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(3)
    counts = np.array([0, 3, 6], np.int32)
    win_r = jax.tree_util.tree_map(lambda a: jnp.stack([a] * _B), init_r)
    win_r = win_r._replace(count=jnp.asarray(counts),
                           s_win=jnp.asarray(rng.standard_normal(
                               (_B, _W, _D))))
    win_p = bu.BlockWindow(*(torch.as_tensor(np.array(a)) for a in win_r))
    s, y = rng.standard_normal((2, _B, _D))
    want = jax.vmap(ref.block_window_push)(win_r, jnp.asarray(s),
                                           jnp.asarray(y))
    got = bu.block_window_push(win_p, torch.as_tensor(s), torch.as_tensor(y))
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
