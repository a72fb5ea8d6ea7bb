"""Port parity: ops/eigh64 of multioptpy_tpu_torch against the JAX package,
values and gradients (jax.grad through the reference's custom JVPs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.ops import eigh64 as ref
from multioptpy_tpu_torch.ops import eigh64 as port

torch.set_num_threads(1)


def _rand_sym(rng, b, d):
    a = rng.standard_normal((b, d, d))
    return a + np.swapaxes(a, -1, -2)


def _spd(rng, b, d):
    m = rng.standard_normal((b, d, d))
    return m @ np.swapaxes(m, -1, -2) + 0.5 * np.eye(d)


def test_eigh_solve_value_and_grad():
    rng = np.random.default_rng(4)
    a = _rand_sym(rng, 3, 9)                    # indefinite
    b = rng.standard_normal((3, 9))
    w_out = rng.standard_normal((3, 9))

    def loss_ref(m, v):
        return jnp.sum(jax.vmap(ref.eigh_solve)(m, v) * w_out)

    x_ref = jax.vmap(ref.eigh_solve)(jnp.asarray(a), jnp.asarray(b))
    ga_ref, gb_ref = jax.grad(loss_ref, argnums=(0, 1))(jnp.asarray(a),
                                                         jnp.asarray(b))
    at = torch.as_tensor(a).requires_grad_(True)
    bt = torch.as_tensor(b).requires_grad_(True)
    x = port.eigh_solve(at, bt)
    (x * torch.as_tensor(w_out)).sum().backward()
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(x_ref),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(ga_ref),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb_ref),
                               rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("degenerate", [False, True])
def test_inv_sqrt_psd_value_and_grad(degenerate):
    rng = np.random.default_rng(5)
    if degenerate:
        q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
        s = ((q * np.array([1.0, 1.0, 1.0, 2.0, 2.0, 4.0])) @ q.T)[None]
    else:
        s = _spd(rng, 2, 6)
    probe = rng.standard_normal(s.shape)

    def loss_ref(m):
        return jnp.sum(jax.vmap(ref.inv_sqrt_psd)(m) * probe)

    y_ref = jax.vmap(ref.inv_sqrt_psd)(jnp.asarray(s))
    g_ref = jax.grad(loss_ref)(jnp.asarray(s))
    st = torch.as_tensor(s).requires_grad_(True)
    y = port.inv_sqrt_psd(st)
    (y * torch.as_tensor(probe)).sum().backward()
    assert torch.isfinite(st.grad).all()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(g_ref),
                               rtol=1e-9, atol=1e-11)


def test_eigh_deflated_matches_reference():
    from multioptpy_tpu.geometry import tr_rot_projector as ref_projector
    from multioptpy_tpu_torch.geometry import tr_rot_projector

    rng = np.random.default_rng(6)
    coords = rng.standard_normal((2, 4, 3)) * 2.0
    h = _spd(rng, 2, 12)
    p = tr_rot_projector(torch.as_tensor(coords))
    p_ref = jax.vmap(ref_projector)(jnp.asarray(coords))
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=1e-12)
    h_proj = p.mT @ torch.as_tensor(h) @ p
    w, v = port.eigh_deflated(h_proj, p)
    w_ref, v_ref = ref.eigh_deflated(jnp.asarray(h_proj.numpy()), p_ref)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=1e-10)
    # eigenvectors up to sign (the 6-fold zero block is degenerate)
    np.testing.assert_allclose(np.abs(v.numpy()[..., 6:]),
                               np.abs(np.asarray(v_ref)[..., 6:]), atol=1e-8)


@pytest.mark.parametrize("d", [7, 10])
def test_seeded_eigh_matches_reference(d):
    rng = np.random.default_rng(d)
    a = _rand_sym(rng, 4, d)
    w, v = port.seeded_eigh(torch.as_tensor(a))
    w_ref, _ = ref.seeded_eigh(jnp.asarray(a))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=1e-11)
    rec = torch.einsum("bij,bj,bkj->bik", v, w, v).numpy()
    np.testing.assert_allclose(rec, a, atol=1e-11)


def test_degenerate_inputs_give_no_nan():
    """Exactly degenerate spectra: seeded eigh, the S^-1/2 backward and the
    solve stay finite."""
    eye = torch.eye(8, dtype=torch.float64)[None].repeat(2, 1, 1)
    eye[1] = 3.0 * eye[1]
    w, v = port.seeded_eigh(eye)
    assert torch.isfinite(w).all() and torch.isfinite(v).all()
    np.testing.assert_allclose(w.numpy(), [[1.0] * 8, [3.0] * 8], atol=1e-14)
    s = eye.clone().requires_grad_(True)
    port.inv_sqrt_psd(s).sum().backward()
    assert torch.isfinite(s.grad).all()
    a = eye.clone().requires_grad_(True)
    b = torch.ones(2, 8, dtype=torch.float64, requires_grad=True)
    port.eigh_solve(a, b).sum().backward()
    assert torch.isfinite(a.grad).all() and torch.isfinite(b.grad).all()


def test_solve_f64safe_is_plain_solve():
    rng = np.random.default_rng(7)
    a = torch.as_tensor(_spd(rng, 2, 5))
    b = torch.as_tensor(rng.standard_normal((2, 5)))
    x = port.solve_f64safe(a, b, assume_sym=True)
    x_ref = jax.vmap(ref.solve_f64safe)(jnp.asarray(a.numpy()),
                                     jnp.asarray(b.numpy()))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=1e-12)
