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
from multioptpy_tpu_torch.ops.jacobi import pad_to_even, sort_and_trim
from multioptpy_tpu_torch.ops.jacobi_cuda import (
    SMEM_LIMIT, circle_schedule, jacobi_eigh_auto,
    jacobi_eigh_cuda, jacobi_eigh_plain, launch_plan, max_dim, pair_indices,
    symmetrize_pairs, thread_blocks)
from multioptpy_tpu_torch.steppers.rfo import jacobi_sweeps_for

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
    with pytest.raises(ValueError):     # the raw launcher takes CUDA only
        jacobi_cuda.launch(a, 8, launch_plan(4, 10, a.dtype))
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(a.numpy()),
                               atol=1e-12)


def test_auto_gate_is_the_shared_memory_limit():
    # A, V and two rounds' (c, s) per pair
    assert max_dim(torch.float32) == 168
    assert max_dim(torch.float64) == 120
    for dtype, limit in ((torch.float32, 168), (torch.float64, 120)):
        itemsize = torch.finfo(dtype).bits // 8
        assert jacobi_cuda.smem_bytes(limit, itemsize) <= SMEM_LIMIT
        assert jacobi_cuda.smem_bytes(limit + 2, itemsize) > SMEM_LIMIT
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


def test_pair_indices_are_the_circle_method_closed_form():
    """The kernel's compare-and-add wraps give jacobi_pallas.py:56-58's
    modular closed form, D = 2..max_dim."""
    for d in range(2, max_dim(torch.float32) + 1, 2):
        m = d - 1
        k = torch.arange(d // 2)
        r = torch.arange(m)[:, None]
        p, q = pair_indices(k, r, d)
        assert torch.equal(q, 1 + (m - 1 - k - r + 2 * m) % m), d
        assert torch.equal(p, torch.where(k == 0, 0, 1 + (k - 1 - r + m) % m))
        assert pair_indices(d // 2 - 1, m - 1, d) == (int(p[-1, -1]),
                                                      int(q[-1, -1]))


_WARP_BATCH = 12288     # a batch the warp variant takes (D <= 32)


def _variants(d):
    """(variant, threads) of each kernel variant that takes even d."""
    out = [("block", launch_plan(1, d, torch.float64).threads)]
    if d <= 32:
        out.insert(0, ("warp", 32))
    return out


def _cells(d, variant, threads, phase):
    """Flat cells of A (phase "a") or V ("v") each thread writes, per round:
    a (d-1, n, 4) long tensor, one row per owned block, the block
    variant's A as canonical upper-triangle cells, its V transposed."""
    t, k, l, swapped = thread_blocks(d, threads, phase).unbind(-1)
    r = torch.arange(d - 1)[:, None]
    if variant == "block" and phase == "v":
        pl, ql = pair_indices(k, r, d)
        cols = torch.stack([2 * l, 2 * l + 1], -1).expand(d - 1, -1, -1)
        return torch.cat([pl[..., None] * d + cols, ql[..., None] * d + cols],
                         -1)
    pk, qk = pair_indices(k, r, d)
    pl, ql = pair_indices(l, r, d)
    c1 = torch.where(swapped.bool(), ql, pl)
    c2 = torch.where(swapped.bool(), pl, ql)
    rows = torch.stack([pk, pk, qk, qk], -1)
    cols = torch.stack([c1, c2, c1, c2], -1)
    if variant == "block":
        rows, cols = torch.minimum(rows, cols), torch.maximum(rows, cols)
    return rows * d + cols


@pytest.mark.parametrize("phase", ["a", "v"])
def test_fused_blocks_partition_every_round(phase):
    """Per round, what the threads of one matrix own in the A update (the
    2x2 blocks rows {p_k, q_k} x columns {p_l, q_l}; the block variant's
    upper triangle, diagonal blocks sharing their one off-diagonal cell)
    and in the V update covers every cell exactly once, D = 2..max_dim,
    both variants. Warp lanes own at most 8 blocks; no block-variant V
    worker computes an angle."""
    for d in range(2, max_dim(torch.float32) + 1, 2):
        for variant, threads in _variants(d):
            t = thread_blocks(d, threads, phase)[:, 0]
            assert int(t.max()) < threads
            if variant == "warp":
                assert int(torch.bincount(t).max()) <= 8
            elif phase == "v":
                assert int(t.min()) >= d // 2
            cells = _cells(d, variant, threads, phase)
            keep = torch.ones_like(cells, dtype=torch.bool)
            keep[..., 2] = cells[..., 2] != cells[..., 1]   # diagonal blocks
            offset = torch.arange(d - 1)[:, None, None] * d * d
            count = torch.bincount((cells + offset)[keep],
                                   minlength=(d - 1) * d * d).view(d - 1, d * d)
            if variant == "block" and phase == "a":
                upper = torch.ones(d, d).triu().flatten().bool()
                assert bool((count[:, upper] == 1).all()), d
                assert int(count[:, ~upper].sum()) == 0, d
            else:
                assert bool((count == 1).all()), (d, variant, phase)


def test_symmetrize_pairs_cover_each_off_diagonal_pair_once():
    for d in range(2, max_dim(torch.float32) + 1, 2):
        ij = symmetrize_pairs(d)
        lo, hi = ij.min(-1).values, ij.max(-1).values
        assert bool((lo < hi).all())
        assert len(torch.unique(lo * d + hi)) == len(ij) == d * (d - 1) // 2
        # a warp's pass of one delta touches distinct rows and columns
        for delta in range(1, d // 2 + 1):
            sel = (ij[:, 1] - ij[:, 0]) % d == delta
            assert len(torch.unique(ij[sel, 0])) == int(sel.sum())
            assert len(torch.unique(ij[sel, 1])) == int(sel.sum())


def _givens(app, aqq, apq):
    small = apq.abs() < 1e-30
    tau = (aqq - app) / torch.where(small, 1.0, 2.0 * apq)
    sgn = torch.where(tau >= 0.0, 1.0, -1.0).to(app.dtype)
    t = torch.where(small, 0.0,
                    -sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau)))
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def _emulate_warp(a, sweeps):
    """The warp variant in torch, in its order of operations: per round the
    angles, each lane's 2x2 blocks of A rotated by G_k from the left and
    G_l^T from the right (upper lanes with their columns swapped and s_l
    negated), then V's blocks by G_l^T; once a sweep the re-symmetrization
    over `symmetrize_pairs`."""
    b, d, _ = a.shape
    a = a.clone()
    v = torch.eye(d, dtype=a.dtype).expand(b, d, d).clone()
    _, k, l, swapped = thread_blocks(d, 32).unbind(-1)
    sw = swapped.bool()
    si, sj = symmetrize_pairs(d).unbind(-1)
    pairs = torch.arange(d // 2)
    for _ in range(sweeps):
        for r in range(d - 1):
            p, q = pair_indices(pairs, r, d)
            c, s = _givens(a[:, p, p], a[:, q, q], a[:, p, q])
            pk, qk = pair_indices(k, r, d)
            pl, ql = pair_indices(l, r, d)
            c1, c2 = torch.where(sw, ql, pl), torch.where(sw, pl, ql)
            ck, sk, cl = c[:, k], s[:, k], c[:, l]
            sl = torch.where(sw, -s[:, l], s[:, l])
            x11, x12 = a[:, pk, c1], a[:, pk, c2]
            x21, x22 = a[:, qk, c1], a[:, qk, c2]
            m11, m21 = ck * x11 + sk * x21, -sk * x11 + ck * x21
            m12, m22 = ck * x12 + sk * x22, -sk * x12 + ck * x22
            a[:, pk, c1], a[:, pk, c2] = cl * m11 + sl * m12, -sl * m11 + cl * m12
            a[:, qk, c1], a[:, qk, c2] = cl * m21 + sl * m22, -sl * m21 + cl * m22
            v11, v12 = v[:, pk, c1], v[:, pk, c2]
            v21, v22 = v[:, qk, c1], v[:, qk, c2]
            v[:, pk, c1], v[:, pk, c2] = cl * v11 + sl * v12, -sl * v11 + cl * v12
            v[:, qk, c1], v[:, qk, c2] = cl * v21 + sl * v22, -sl * v21 + cl * v22
        sym = 0.5 * (a[:, si, sj] + a[:, sj, si])
        a[:, si, sj] = sym
        a[:, sj, si] = sym
    return torch.diagonal(a, dim1=-2, dim2=-1), v


def _emulate_block(a, sweeps, threads):
    """The block variant in torch, in its order of operations: A kept as
    its upper triangle (cell (min, max) of each entry), per round the
    angles, each block (k, l), k <= l, rotated by G_k from the left and
    G_l^T from the right with its four cells stored in order (on a
    diagonal block the (q_k, p_l) store stands), then rows p_l, q_l of V
    transposed rotated by G_l."""
    b, d, _ = a.shape
    a = a.triu().reshape(b, d * d)
    vt = torch.eye(d, dtype=a.dtype).expand(b, d, d).clone()
    _, k, l, _ = thread_blocks(d, threads, "a").unbind(-1)
    pairs = torch.arange(d // 2)

    def cell(i, j):
        return torch.minimum(i, j) * d + torch.maximum(i, j)

    for _ in range(sweeps):
        for r in range(d - 1):
            p, q = pair_indices(pairs, r, d)
            c, s = _givens(a[:, p * (d + 1)], a[:, q * (d + 1)], a[:, cell(p, q)])
            pk, qk = pair_indices(k, r, d)
            pl, ql = pair_indices(l, r, d)
            ck, sk, cl, sl = c[:, k], s[:, k], c[:, l], s[:, l]
            i11, i12, i21, i22 = cell(pk, pl), cell(pk, ql), cell(qk, pl), cell(qk, ql)
            x11, x12, x21, x22 = a[:, i11], a[:, i12], a[:, i21], a[:, i22]
            m11, m21 = ck * x11 + sk * x21, -sk * x11 + ck * x21
            m12, m22 = ck * x12 + sk * x22, -sk * x12 + ck * x22
            a[:, i11] = cl * m11 + sl * m12
            a[:, i12] = -sl * m11 + cl * m12
            a[:, i21] = cl * m21 + sl * m22
            a[:, i22] = -sl * m21 + cl * m22
            cr, sr = c[..., None], s[..., None]
            vp, vq = vt[:, p, :], vt[:, q, :]
            vt[:, p, :] = cr * vp + sr * vq
            vt[:, q, :] = -sr * vp + cr * vq
    return a[:, pairs.new_tensor(range(d)) * (d + 1)], vt.mT


@pytest.mark.parametrize("d,variant", [(8, "warp"), (8, "block"),
                                       (24, "warp"), (24, "block"),
                                       (32, "warp"), (32, "block"),
                                       (34, "block"), (54, "block"),
                                       (72, "block")])
def test_fused_round_emulation_matches_plain_f64(d, variant):
    rng = np.random.default_rng(40 + d)
    a = torch.as_tensor(_sym(rng, 2, d, np.float64))
    sweeps = jacobi_sweeps_for(d) + 1
    threads = dict(_variants(d))[variant]
    w, v = (_emulate_warp(a, sweeps) if variant == "warp"
            else _emulate_block(a, sweeps, threads))
    w, v = sort_and_trim(w, v, d, a.shape[:1])
    w_p, v_p = jacobi_eigh_plain(a, sweeps)
    np.testing.assert_allclose(w.numpy(), w_p.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(v.numpy(), v_p.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(a.numpy()),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dispatch_boundary_and_launch_shapes(dtype):
    """At a batch that fills the card D = 32 goes to the warp variant and
    D = 34 to the block variant, odd D padded to even first; below
    WARP_MIN_BATCH_PER_SM matrices per SM every D goes to the block
    variant. Every plan fits a Hopper block."""
    itemsize = torch.finfo(dtype).bits // 8
    for d0, variant in ((31, "warp"), (32, "warp"), (33, "block"),
                        (34, "block")):
        a, _, _ = pad_to_even(torch.zeros(1, d0, d0, dtype=dtype))
        assert launch_plan(_WARP_BATCH, a.shape[-1], dtype).variant == variant
    few = jacobi_cuda.WARP_MIN_BATCH_PER_SM * jacobi_cuda.H100_SMS
    assert launch_plan(few, 32, dtype).variant == "warp"
    for b in (1, 7, 256, few - 1):
        assert launch_plan(b, 32, dtype).variant == "block"
    # 4 matrices a block; a masked tail warp
    assert launch_plan(12288, 32, dtype)[:3] == ("warp", 3072, 128)
    assert launch_plan(12289, 32, dtype)[:3] == ("warp", 3073, 128)
    assert launch_plan(12288, 32, dtype).smem == 4 * 2 * 32 * 32 * itemsize
    assert launch_plan(108, 72, dtype)[:3] == ("block", 108, 672)
    assert launch_plan(1, 168, dtype)[:3] == ("block", 1, 1024)
    assert launch_plan(1, 2, dtype)[:3] == ("block", 1, 64)
    # scan_jacobi forces a variant by the SM count: 0, or the batch itself
    assert launch_plan(256, 24, dtype, sm_count=0).variant == "warp"
    assert launch_plan(_WARP_BATCH, 32, dtype,
                       sm_count=_WARP_BATCH).variant == "block"
    for d in range(2, max_dim(dtype) + 1, 2):
        for b in (1, _WARP_BATCH):
            plan = launch_plan(b, d, dtype)
            assert plan.smem <= SMEM_LIMIT and plan.threads % 32 == 0
            assert plan.threads <= 1024, d
            if plan.variant == "block":   # angle warps, then >= d/2 V workers
                assert plan.threads - 32 * -(-d // 64) >= d // 2, d


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Both variants against the plain version: D = 2, 30, 32, 34, 54, 72;
    B = 1 and 7 (block variant) and 12 * 132 + 1 (the warp variant for
    D <= 32, one matrix above a whole number of 4-matrix blocks); odd D
    through the wrapper's padding, (20, 9) and (4, 27); f32 at 3e-5, f64 at
    1e-11, relative to max|a|. Each call launches once, of its variant."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 through chip_smoke)")
    rng = np.random.default_rng(5)
    big = jacobi_cuda.WARP_MIN_BATCH_PER_SM * jacobi_cuda.H100_SMS + 1
    shapes = [(b, d) for d in (2, 30, 32, 34, 54, 72) for b in (1, 7, big)]
    shapes += [(20, 9), (4, 27)]
    for dtype, tol in ((np.float32, 3e-5), (np.float64, 1e-11)):
        for b, d in shapes:
            a = torch.as_tensor(_sym(rng, b, d, dtype), device="cuda")
            variant = "warp" if d <= 32 and b == big else "block"
            before = jacobi_eigh_cuda.launches
            before_v = dict(jacobi_eigh_cuda.variant_launches)
            w, v = jacobi_eigh_cuda(a, sweeps=9)
            w_p, _ = jacobi_eigh_plain(a, sweeps=9)
            torch.cuda.synchronize()
            before_v[variant] += 1
            assert jacobi_eigh_cuda.launches == before + 1, (d, b)
            assert jacobi_eigh_cuda.variant_launches == before_v, (d, b)
            scale = max(1.0, a.abs().max().item())
            assert (w - w_p).abs().max().item() <= tol * scale, (d, b)
            rec = torch.einsum("bij,bj,bkj->bik", v, w, v)
            assert (rec - a).abs().max().item() <= tol * scale, (d, b)
