"""Port parity: hyperspherical coordinates (multioptpy_tpu_torch.coords.polar)
against the JAX package: the transforms both ways, the Jacobian and the
polar gradient, 1e-13 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.coords import polar as ref
from multioptpy_tpu_torch.coords import polar

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [2, 3, 6, 9])
def test_transforms_and_jacobian_match_reference(n):
    rng = np.random.default_rng(n)
    x, x0 = rng.standard_normal(n), rng.standard_normal(n)
    for ref_pt in (None, x0):
        jr = None if ref_pt is None else jnp.asarray(ref_pt)
        tr = None if ref_pt is None else torch.as_tensor(ref_pt)
        p_ref = np.asarray(ref.cart2polar(jnp.asarray(x), jr))
        p = polar.cart2polar(torch.as_tensor(x), tr)
        np.testing.assert_allclose(p.numpy(), p_ref, rtol=1e-13, atol=1e-15)
        back = polar.polar2cart(p, tr)
        np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-13)
        np.testing.assert_allclose(
            polar.polar_jacobian(p, tr).numpy(),
            np.asarray(ref.polar_jacobian(jnp.asarray(p_ref), jr)),
            rtol=1e-13, atol=1e-14)


def test_polar_gradient_keeps_the_reference_chain_rule():
    """The reference's cart_grad_to_polar_grad (coords/polar.py:54-63) is
    J^T g with J taken at p = cart2polar(x) from polar2cart, unlike the
    upstream code whose first Jacobian column reads cart2polar of a polar
    vector; the port keeps the reference's form, so its gradient is the
    true derivative of f(polar2cart(p))."""
    rng = np.random.default_rng(0)
    x, x0, g = (rng.standard_normal(5) for _ in range(3))
    want = np.asarray(ref.cart_grad_to_polar_grad(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(x0)))
    got = polar.cart_grad_to_polar_grad(torch.as_tensor(x),
                                        torch.as_tensor(g),
                                        torch.as_tensor(x0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-14)
    # f(x) = g . x: d f(polar2cart(p)) / dp by autograd equals J^T g
    p = polar.cart2polar(torch.as_tensor(x), torch.as_tensor(x0))
    p = p.detach().requires_grad_(True)
    f = polar.polar2cart(p, torch.as_tensor(x0)) @ torch.as_tensor(g)
    (dp,) = torch.autograd.grad(f, p)
    np.testing.assert_allclose(got.numpy(), dp.numpy(), rtol=1e-12)
