"""A member's result does not depend on its batch (ROADMAP Queue 3, F12):
`device.bmv`, the batched matrix-vector product of the port's step paths
(torch.bmm on the CPU), and `bmv_reduce`, its form on the card, against
`a @ x[..., None]`, and one member computed alone, in a batch of 64 and in
a batch of 256, equal to the bit, at the step paths' widths (the S8 RFO
step and band in f32; the Diels-Alder RFO step and band and the n-octane
band in f64). `chip_smoke.py`'s `mesh` phase holds the same on the card
(`mesh_paths.batch_probe`, `ring_step_probe`, `op_probe`)."""

import numpy as np
import pytest
import torch

from multioptpy_tpu_torch.calculators.lj import LennardJones
from multioptpy_tpu_torch.device import bmv, bmv_reduce
from multioptpy_tpu_torch.drivers.optimize import (OptimizeConfig,
                                                   optimize_batch)
from multioptpy_tpu_torch.periodic import UFF_VDW_R

torch.set_num_threads(1)

WIDTHS = [(24, torch.float32), (32, torch.float32), (54, torch.float64),
          (72, torch.float64), (104, torch.float64)]


def _mats(d, dtype, n=256, seed=0, exact=False):
    """(n, d, d) and (n, d) from a seed; `exact`: multiples of 1/16 in
    [-1, 1], whose products and sums (at most 104 terms) every dtype holds
    exactly."""
    rng = np.random.default_rng(seed)
    if exact:
        a, x = (rng.integers(-16, 17, size=s) / 16.0
                for s in ((n, d, d), (n, d)))
    else:
        a, x = rng.standard_normal((n, d, d)), rng.standard_normal((n, d))
    return (torch.as_tensor(a, dtype=dtype), torch.as_tensor(x, dtype=dtype))


@pytest.mark.parametrize("fn", [bmv, bmv_reduce])
@pytest.mark.parametrize("d,dtype", WIDTHS)
def test_bmv_equals_matmul(d, dtype, fn):
    """bmv(a, x) and bmv(a.mT, x) against the matmul forms they replace, to
    1e-15 relative: exactly where every product and sum is exact (f32 and
    f64), and within 1e-15 of max(|a| |x|) on random f64 inputs."""
    for exact in (True, False):
        if not exact and dtype == torch.float32:
            continue
        a, x = _mats(d, dtype, n=8, seed=d, exact=exact)
        for m in (a, a.mT):
            want = (m @ x[..., None])[..., 0]
            scale = (m.abs() @ x.abs()[..., None]).max()
            got = fn(m, x)
            assert got.shape == want.shape and got.dtype == dtype
            gap = (got - want).abs().max() / scale
            assert gap == 0.0 if exact else gap <= 1e-15


@pytest.mark.parametrize("fn", [bmv, bmv_reduce])
@pytest.mark.parametrize("d,dtype", WIDTHS)
def test_bmv_member_alone_equals_member_in_batch(d, dtype, fn):
    a, x = _mats(d, dtype, seed=d + 1)
    for m in (a, a.mT):
        whole = fn(m, x)
        for k in (1, 64):
            assert torch.equal(fn(m[:k].clone(), x[:k].clone()), whole[:k])


def _ar8_batch(n=256):
    """n perturbed Ar8 cubes (3N = 24, the S8 step's width)."""
    rmin = float(UFF_VDW_R[18])
    cube = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                    -1).reshape(8, 3) * rmin
    rng = np.random.default_rng(12)
    return torch.as_tensor(cube + 0.1 * rng.standard_normal((n, 8, 3)))


def test_rfo_fsb_member_alone_equals_member_in_batch():
    """The step path (RS-RFO with its eigensolve, the FSB update, the
    TR/rot projection, an exact initial Hessian) over 4 steps of 256
    perturbed Ar8 cubes: member 1 alone and members 1-64 as a batch give
    the whole batch's energies and coordinates to the bit (with
    `a @ x[..., None]` on the step path, member 1 alone ends 1.5e-9 Bohr
    away on the CPU)."""
    calc, z = LennardJones(device="cpu"), np.full(8, 18)
    cfg = OptimizeConfig(method="rfo_fsb", init_hessian="exact")
    batch = _ar8_batch()
    whole = optimize_batch(calc, batch, z, config=cfg, n_steps=4,
                           device="cpu")
    assert np.isfinite(whole.energy_history).all()
    for k in (1, 64):
        part = optimize_batch(calc, batch[:k].clone(), z, config=cfg,
                              n_steps=4, device="cpu")
        assert np.array_equal(part.energy_history,
                              whole.energy_history[:, :k])
        assert torch.equal(part.coords, whole.coords[:k])
