"""Port parity: the Jacobi eigensolvers of multioptpy_tpu_torch against the
JAX package (Pallas kernel in interpret mode, round-robin Jacobi)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.ops.jacobi import _round_robin_schedule as jax_schedule
from multioptpy_tpu.ops.jacobi import jacobi_eigh as jax_jacobi_eigh
from multioptpy_tpu.ops.jacobi_pallas import jacobi_eigh_pallas
from multioptpy_tpu_torch.ops import jacobi_cuda
from multioptpy_tpu_torch.ops.jacobi import _round_robin_schedule, jacobi_eigh
from multioptpy_tpu_torch.ops.jacobi_cuda import (circle_schedule,
                                                  jacobi_eigh_auto,
                                                  jacobi_eigh_cuda,
                                                  jacobi_eigh_plain, max_dim)

torch.set_num_threads(1)


def _sym(rng, b, d, dtype=np.float32):
    m = rng.standard_normal((b, d, d)).astype(dtype)
    return (m + np.transpose(m, (0, 2, 1))) * 0.5


@pytest.mark.parametrize("b,d", [(20, 9), (6, 12)])
def test_plain_matches_pallas_interpret(b, d):
    """f32, the tolerances of tests/test_jacobi_pallas.py: eigenvalues
    2e-5 and the reconstruction 3e-5, relative to max|a|."""
    rng = np.random.default_rng(b * 100 + d)
    a = _sym(rng, b, d)
    w_j, v_j = jacobi_eigh_pallas(jnp.asarray(a), sweeps=10, interpret=True)
    w, v = jacobi_eigh_plain(torch.as_tensor(a), sweeps=10)
    scale = max(1.0, np.abs(a).max())
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=2e-5 * scale)
    rec = torch.einsum("bij,bj,bkj->bik", v, w, v).numpy()
    np.testing.assert_allclose(rec, a, atol=3e-5 * scale)
    vtv = torch.einsum("bij,bik->bjk", v, v).numpy()
    np.testing.assert_allclose(vtv, np.broadcast_to(np.eye(d), vtv.shape),
                               atol=1e-5)
    # same angles, same pairing orientation: the eigenvectors agree too
    # (up to the f32 rounding of the two rotation orders)
    np.testing.assert_allclose(np.abs(v.numpy()), np.abs(np.asarray(v_j)),
                               atol=1e-4)


@pytest.mark.parametrize("d,sweeps", [(8, 10), (9, 10), (24, 7)])
def test_round_robin_jacobi_matches_jax_f64(d, sweeps):
    rng = np.random.default_rng(d)
    a = _sym(rng, 5, d, np.float64)
    w_j, v_j = jax_jacobi_eigh(jnp.asarray(a), sweeps=sweeps)
    w, v = jacobi_eigh(torch.as_tensor(a), sweeps=sweeps)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(_round_robin_schedule(d + d % 2),
                                  jax_schedule(d + d % 2))


def test_closed_form_pairing_matches_round_robin_schedule():
    """The kernel's closed-form pairs (jacobi_pallas.py:56-58) are the
    round-robin schedule's pairs, round by round, for D = 2..96."""
    for d in range(2, 97, 2):
        closed = circle_schedule(d).numpy()
        ref = jax_schedule(d)
        assert closed.shape == ref.shape
        for r in range(d - 1):
            got = sorted(tuple(sorted(p)) for p in closed[r].tolist())
            assert got == [tuple(p) for p in ref[r].tolist()], (d, r)


def test_cpu_tensor_runs_plain_version_without_launch():
    rng = np.random.default_rng(3)
    a = torch.as_tensor(_sym(rng, 4, 10, np.float64))
    before = jacobi_eigh_cuda.launches
    w, v = jacobi_eigh_cuda(a, sweeps=8)
    w_p, v_p = jacobi_eigh_plain(a, sweeps=8)
    assert jacobi_eigh_cuda.launches == before
    assert torch.equal(w, w_p) and torch.equal(v, v_p)
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(a.numpy()),
                               atol=1e-12)


def test_auto_gate_is_the_shared_memory_limit():
    assert max_dim(torch.float32) == 168
    assert max_dim(torch.float64) == 120
    for dtype, limit in ((torch.float32, 168), (torch.float64, 120)):
        assert jacobi_cuda.smem_bytes(limit, torch.finfo(dtype).bits // 8) \
            <= jacobi_cuda.SMEM_LIMIT
    # above the gate the reference calls the library eigh
    rng = np.random.default_rng(4)
    a = torch.as_tensor(_sym(rng, 1, 122, np.float64))
    before = jacobi_eigh_cuda.launches
    w, _ = jacobi_eigh_auto(a, sweeps=1)     # one sweep would not converge
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(a.numpy()),
                               atol=1e-10)
    assert jacobi_eigh_cuda.launches == before


def test_degenerate_batch_stays_finite_and_orthonormal():
    """Overlap-like matrices (all-ones diagonal, equal pairs: tau = 0) need
    the 45-degree rotation, sgn(0) = +1."""
    a = np.ones((3, 6, 6)) * 0.3 + np.eye(6)[None] * 0.7
    a[1] = np.eye(6)
    w, v = jacobi_eigh_plain(torch.as_tensor(a), sweeps=8)
    assert torch.isfinite(w).all() and torch.isfinite(v).all()
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(a), atol=1e-12)
    rec = torch.einsum("bij,bj,bkj->bik", v, w, v).numpy()
    np.testing.assert_allclose(rec, a, atol=1e-12)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 through chip_smoke)")
    rng = np.random.default_rng(5)
    for dtype, tol in ((np.float32, 3e-5), (np.float64, 1e-11)):
        for b, d in ((20, 9), (8, 54), (4, 72)):
            a = torch.as_tensor(_sym(rng, b, d, dtype), device="cuda")
            before = jacobi_eigh_cuda.launches
            w, v = jacobi_eigh_cuda(a, sweeps=9)
            w_p, _ = jacobi_eigh_plain(a, sweeps=9)
            torch.cuda.synchronize()
            assert jacobi_eigh_cuda.launches == before + 1
            scale = max(1.0, a.abs().max().item())
            assert (w - w_p).abs().max().item() <= tol * scale
            rec = torch.einsum("bij,bj,bkj->bik", v, w, v)
            assert (rec - a).abs().max().item() <= tol * scale
