"""K3, the batched tridiagonal eigensolver past K1's gate: its plain
version (`tridiag_eigh_plain`, the stages and the chain the kernels run)
against torch.linalg.eigh (LAPACK) at D = 122, 200, 294 and 392 on random
symmetric, SPD overlap-like and exactly degenerate matrices; the chain's
record split over rounds; the kernels' names under the eigensolver
metric's; and, on a card, the kernels against the plain version and SQM2
through the "k3" route."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multioptpy_tpu_torch.calculators.sqm import _FERMI_KT, _fermi_occupations
from multioptpy_tpu_torch.ops import eigh64
from multioptpy_tpu_torch.ops import tridiag_cuda as tc

torch.set_num_threads(1)

DIMS = (122, 200, 294, 392)
KINDS = ("random", "overlap", "degenerate")


def _matrix(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        m = rng.standard_normal((n, n))
        return torch.as_tensor(0.5 * (m + m.T))
    if kind == "overlap":
        # Gaussian overlaps of n centres on a jittered cubic lattice 1.4
        # widths apart: SPD, unit diagonal, eigenvalues ~0.3 to ~2.5
        side = int(np.ceil(n ** (1 / 3)))
        grid = np.stack(np.meshgrid(*[np.arange(side)] * 3), -1).reshape(-1, 3)
        x = 1.4 * (grid[rng.permutation(len(grid))[:n]]
                   + rng.uniform(-0.15, 0.15, (n, 3)))
        d2 = ((x[:, None] - x[None]) ** 2).sum(-1)
        return torch.as_tensor(np.exp(-0.5 * d2))
    # repeated blocks, rows and columns permuted: each eigenvalue of the
    # block exactly k times
    k = {122: 2, 200: 4, 294: 6, 392: 8}[n]
    blk = rng.standard_normal((n // k, n // k))
    a = np.kron(np.eye(k), 0.5 * (blk + blk.T))
    p = rng.permutation(n)
    return torch.as_tensor(a[p][:, p])


def _check(a, w, v):
    """Values to 1e-12 of max|a|, reconstruction and orthonormality, and
    the sign- and rotation-free products the program consumes: the band's
    density V diag(occ) V^T (Fermi occupations of half the levels) and,
    for an SPD matrix, Loewdin's V w^-1/2 V^T, to 1e-12."""
    n = a.shape[-1]
    w_ref, v_ref = torch.linalg.eigh(a)
    scale = a.abs().max()
    assert (w - w_ref).abs().max() <= 1e-12 * scale
    assert ((v * w[..., None, :]) @ v.mT - a).abs().max() <= 1e-12 * scale
    assert (v.mT @ v - torch.eye(n, dtype=a.dtype)).abs().max() <= 1e-12
    for ww, vv, wr, vr in zip(w.reshape(-1, n), v.reshape(-1, n, n),
                              w_ref.reshape(-1, n), v_ref.reshape(-1, n, n)):
        occ = _fermi_occupations(ww[None], float(n), _FERMI_KT)[0][0]
        occ_ref = _fermi_occupations(wr[None], float(n), _FERMI_KT)[0][0]
        rho = (vv * occ) @ vv.mT
        assert (rho - (vr * occ_ref) @ vr.mT).abs().max() <= 1e-12
        if wr[0] > 0:
            isq = (vv * ww ** -0.5) @ vv.mT
            isq_ref = (vr * wr ** -0.5) @ vr.mT
            assert (isq - isq_ref).abs().max() <= 1e-12 * isq_ref.abs().max()


@pytest.mark.parametrize("n", DIMS)
@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_lapack_one_matrix(kind, n):
    a = _matrix(kind, n, n)[None]
    w, v = tc.tridiag_eigh_plain(a)
    _check(a, w, v)


@pytest.mark.parametrize("n", DIMS)
def test_plain_matches_lapack_batch_of_three(n):
    """B = 3, one matrix of each kind, as (3, n, n) and as (1, 3, n, n)."""
    a = torch.stack([_matrix(k, n, 7 * n + i) for i, k in enumerate(KINDS)])
    w, v = tc.tridiag_eigh_plain(a[None])
    assert w.shape == (1, 3, n) and v.shape == (1, 3, n, n)
    _check(a, w[0], v[0])


def test_a_full_record_resumes_in_the_next_round():
    """The chain stops before a sweep its record has no room for and goes
    on in the next round: a record of n rotations and one sweep a round
    (hundreds of rounds) gives the default record's result bit for bit;
    random matrices need two rounds of the default record."""
    n = 122
    a = _matrix("random", n, 3)[None]
    d, e, _, _ = tc.sytrd_plain(a)
    db, eb = d[0].tolist(), e[0].tolist()
    st, perm = [0] * tc.STATE_LEN, list(range(n))
    rounds = 0
    while st[tc.STATUS] == tc.RUNNING:
        tc.steqr_chain(db, eb, st, *tc.record_capacity(n), perm)
        rounds += 1
    assert rounds == 2 and st[tc.STATUS] == tc.FINISHED
    w, v = tc.tridiag_eigh_plain(a)
    w1, v1 = tc.tridiag_eigh_plain(a, capacity=(n, 1))
    assert torch.equal(w, w1) and torch.equal(v, v1)


def test_the_chain_ends_in_order():
    """A finished chain reports FINISHED once, then DONE_BEFORE and an
    empty record, as the kernel's next round sees it."""
    n = 40
    d, e, _, _ = tc.sytrd_plain(_matrix("overlap", n, 1)[None])
    db, eb = d[0].tolist(), e[0].tolist()
    st, perm = [0] * tc.STATE_LEN, list(range(n))
    while st[tc.STATUS] == tc.RUNNING:
        sweeps, cs = tc.steqr_chain(db, eb, st, *tc.record_capacity(n), perm)
    assert st[tc.STATUS] == tc.FINISHED and sweeps
    assert len(cs) == st[tc.ROTATIONS]
    assert db == sorted(db) and sorted(perm) == list(range(n))
    assert tc.steqr_chain(db, eb, st, *tc.record_capacity(n), perm) == ([], [])
    assert st[tc.STATUS] == tc.DONE_BEFORE and st[tc.SWEEPS] == 0


def test_every_kernel_is_counted_as_eigensolver_time():
    """eigh_roofline divides by the device time of kernels whose names hold
    one of its KERNELS: each of K3's must, and each stage's LAPACK name
    (sytrd, ormtr, steqr) appears."""
    from gpu_bench.metrics.eigh_roofline import KERNELS

    src = Path(tc.SOURCE).read_text()
    names = re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src)
    assert len(names) == 4
    for name in names:
        assert any(k in name for k in KERNELS), name
    for stage in ("sytrd", "ormtr", "steqr"):
        assert any(stage in name for name in names)


def test_launch_counts_name_each_kernel_and_start_at_zero():
    """The stages `launch` counts are the source's four kernels, its grid
    split is the source's, and a CPU call (the plain version) launches
    nothing."""
    src = Path(tc.SOURCE).read_text()
    names = re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src)
    assert sorted(f"k3_{s}_kernel" for s in tc.STAGES) == sorted(names)
    assert re.search(rf"kMaxGridY\s*=\s*{tc.MAX_GRID_Y}\b", src)
    tc.reset_launches()
    tc.tridiag_eigh_cuda(torch.eye(3, dtype=torch.float64))
    assert tc.tridiag_eigh_cuda.launches == 0
    assert tc.tridiag_eigh_cuda.stage_launches == dict.fromkeys(tc.STAGES, 0)


def test_limits_follow_shared_memory():
    assert tc.max_dim() == 830
    assert max(tc.smem_bytes(tc.max_dim()).values()) <= tc.SMEM_LIMIT
    assert max(tc.smem_bytes(tc.max_dim() + 1).values()) > tc.SMEM_LIMIT
    with pytest.raises(ValueError):
        tc.tridiag_eigh_cuda(torch.zeros(2, 4, 4, dtype=torch.float64,
                                         device="meta"))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """588 x 392 random symmetric: K3 against its plain version on three
    members (values), and reconstruction and orthonormality on all, to
    1e-11 of max|a|; plus odd, small and the largest order (830), and a
    batch past a grid's 65,535 rows of blocks, through the same launch,
    their values against LAPACK's."""
    _card()
    g = torch.Generator().manual_seed(19)
    for b, n in ((588, 392), (3, 121), (2, 5), (1, 1), (1, tc.max_dim()),
                 (65537, 6)):
        m = torch.randn(b, n, n, generator=g, dtype=torch.float64)
        a = (0.5 * (m + m.mT)).cuda()
        tc.reset_launches()
        w, v = tc.tridiag_eigh_cuda(a)
        torch.cuda.synchronize()
        stages = tc.tridiag_eigh_cuda.stage_launches
        grids, rounds = -(-b // tc.MAX_GRID_Y), stages["steqr_chain"]
        assert rounds >= 1 and stages == {
            "sytrd": 1, "ormtr": grids, "steqr_chain": rounds,
            "steqr_apply": rounds * grids}
        assert tc.tridiag_eigh_cuda.launches == sum(stages.values())
        scale = a.abs().max().item()
        eye = torch.eye(n, dtype=torch.float64, device="cuda")
        assert ((v * w[:, None, :]) @ v.mT - a).abs().max() <= 1e-11 * scale
        assert (v.mT @ v - eye).abs().max() <= 1e-11
        w_ref = torch.linalg.eigvalsh(a.cpu())
        assert (w.cpu() - w_ref).abs().max() <= 1e-11 * scale
        if b == 588:
            for k in (0, b // 2, b - 1):
                w_p, _ = tc.tridiag_eigh_plain(a[k:k + 1].cpu())
                assert (w[k].cpu() - w_p[0]).abs().max() <= 1e-11 * scale


@pytest.mark.cuda
def test_sqm2_through_k3_matches_cusolver_on_card(monkeypatch):
    """SQM2's energy and gradient of three displaced C32H66 structures with
    every band and Loewdin solve on K3 (the route's table forced to take
    B = 3) against the same with them on torch.linalg.eigh, to 1e-10."""
    _card()
    from multioptpy_tpu_torch.calculators.sqm import SQM2
    from multioptpy_tpu_torch.io.fixtures import alkane_chain
    from multioptpy_tpu_torch.logging_utils import StageTimer, recording
    from multioptpy_tpu_torch.units import ANGSTROM2BOHR

    c, z = alkane_chain(32)
    rng = np.random.default_rng(32)
    x = torch.as_tensor(c[None] + 0.1 * ANGSTROM2BOHR
                        * rng.standard_normal((3,) + c.shape), device="cuda")
    calc = SQM2(device="cuda")
    out = {}
    for name, need in (("k3", 1), ("cusolver", None)):
        monkeypatch.setattr(eigh64, "K3_MIN_BATCH",
                            {torch.float64: {392: need}} if need else {})
        rec = StageTimer()
        with recording(rec):
            e, g = calc.energy_and_gradient(x, z)
        routes = {key[1] for key in rec.eigh_calls if key[3] == 392}
        assert routes == {name}, rec.eigh_calls
        out[name] = (e.cpu(), g.cpu())
    (e3, g3), (e0, g0) = out["k3"], out["cusolver"]
    assert (e3 - e0).abs().max() <= 1e-10
    assert (g3 - g0).abs().max() <= 1e-10
