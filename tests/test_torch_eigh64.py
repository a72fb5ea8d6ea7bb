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


def test_eigh_route_sends_batches_from_b_min_to_k1():
    """On the card, a batch of at least b_min(D) f32 or f64 matrices with
    D up to max_dim goes to K1, a smaller one to cuSOLVER; an odd D is
    looked up at its even padding."""
    from multioptpy_tpu_torch.ops.jacobi_cuda import max_dim

    routed = [(dtype, d, need) for dtype, table in port.EIGH_MIN_BATCH.items()
              for d, need in table.items()]
    assert routed
    for dtype, d, need in routed:
        assert d <= max_dim(dtype)
        for b in (need, need + 1, 16, 2496):
            assert port.eigh_route("cuda", dtype, d, b, False) == "k1"
            assert port.eigh_route("cuda", dtype, d - 1, b, False) == "k1"
        assert port.eigh_route("cuda", dtype, d, need - 1,
                               False) == "cusolver"


@pytest.mark.parametrize("d", [54, 78, 104])
def test_eigh_route_keeps_one_matrix_on_cusolver(d):
    """B = 1 at the single cells' RFO and Loewdin dimensions stays on
    cuSOLVER, which is faster there; so does an empty batch."""
    assert port.eigh_route("cuda", torch.float64, d, 1, False) == "cusolver"
    assert port.eigh_route("cuda", torch.float64, d, 0, False) == "cusolver"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eigh_route_keeps_large_dims_grad_and_cpu_off_k1(dtype):
    """Past K1's shared-memory limit, for a grad-tracked input (K1 has no
    backward), for other dtypes and off the card, no batch goes to K1
    (past the limit an f64 batch may go to K3 instead:
    tests/test_torch_eigh_route.py)."""
    from multioptpy_tpu_torch.ops.jacobi_cuda import max_dim

    top = max_dim(dtype)
    past = ("cusolver", "k3") if dtype == torch.float64 else ("cusolver",)
    for b in (1, 16, 2496):
        assert port.eigh_route("cuda", dtype, top + 1, b, False) in past
        assert port.eigh_route("cuda", dtype, top + 2, b, False) in past
        assert port.eigh_route("cuda", dtype, 104, b, True) == "cusolver"
        assert port.eigh_route("cuda", torch.float16, 54, b,
                               False) == "cusolver"
        for d in (28, 54, 104, top + 2):
            assert port.eigh_route("cpu", dtype, d, b, False) == "cpu"


def test_b_min_takes_the_larger_neighbour_between_scanned_dims():
    """Between two scanned D the larger b_min of the two; outside the
    scanned D never K1."""
    for dtype, table in port.EIGH_MIN_BATCH.items():
        dims = sorted(table)
        for lo, hi in zip(dims, dims[1:]):
            for d in range(lo + 2, hi, 2):
                assert port.b_min(d, dtype) == max(table[lo], table[hi]), (
                    dtype, d)
        assert port.b_min(dims[0] - 2, dtype) is None
        assert port.b_min(dims[-1] + 2, dtype) is None


def test_cpu_eigh_fast_is_lapack_counted_as_cpu():
    """On the CPU eigh_fast is torch.linalg.eigh bit for bit, at any
    batch, and the recorder counts the call as "cpu"."""
    from multioptpy_tpu_torch import logging_utils as lu

    rng = np.random.default_rng(8)
    a = torch.as_tensor(_rand_sym(rng, 16, 78))
    t = lu.StageTimer()
    with lu.recording(t), lu.span("caller"):
        w, v = port.eigh_fast(a)
    w_ref, v_ref = torch.linalg.eigh(a)
    assert torch.equal(w, w_ref) and torch.equal(v, v_ref)
    assert dict(t.eigh_calls) == {("caller", "cpu", 16, 78, "float64"): 1}


def test_k1_sweeps_are_the_rs_rfo_count():
    """One sweep count for every caller: the f64 RS-RFO step's."""
    for d, want in ((28, 13), (54, 14), (56, 14), (72, 15), (78, 15),
                    (104, 15)):
        assert port.k1_sweeps(d, torch.float64) == want
        assert want == port.jacobi_sweeps_for(d) + port.rfo_extra_sweeps(
            torch.float64)
