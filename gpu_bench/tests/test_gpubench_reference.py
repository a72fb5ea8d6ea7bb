"""The plain reference against the program's CPU path at small sizes
(ethane, propane): SQM2's energy, gradient and exact Hessian, and the
rfo_fsb step replayed through a run of the program."""

import numpy as np
import pytest
import torch

from gpu_bench.reference import rfo, sqm2


def _starts(n_carbons, b=3, sigma=0.1):
    from multioptpy_tpu_torch.io.fixtures import alkane_chain
    x, z = alkane_chain(n_carbons)
    rng = np.random.default_rng(n_carbons)
    return torch.as_tensor(x[None] + sigma * rng.standard_normal(
        (b,) + x.shape)), z


@pytest.mark.parametrize("n_carbons", [2, 3])
def test_plain_sqm2_matches_the_program(n_carbons):
    from multioptpy_tpu_torch.calculators.sqm import SQM2
    torch.set_num_threads(2)
    x, z = _starts(n_carbons)
    calc = SQM2(device="cpu")
    mol = sqm2.Molecule(z, "cpu")
    e, g = calc.energy_and_gradient(x, z)
    e_ref, g_ref = sqm2.energy_and_gradient(x, mol)
    # LAPACK on both sides, two routes to the band: rounding alone
    assert (e - e_ref).abs().max() < 1e-12
    assert (g - g_ref).abs().max() < 1e-12
    h = calc.hessian(x[:1], z)
    assert (h - sqm2.hessian(x[:1], mol)).abs().max() < 1e-9


def test_plain_sqm2_refuses_what_it_does_not_cover():
    with pytest.raises(ValueError):
        sqm2.Molecule([6, 16], "cpu")


@pytest.mark.parametrize("n_carbons", [2, 3])
def test_replay_follows_the_program(n_carbons):
    from multioptpy_tpu_torch.calculators.sqm import SQM2
    from multioptpy_tpu_torch.drivers.optimize import (OptimizeConfig,
                                                       optimize_batch)
    from gpu_bench.spans import SpanCalc
    torch.set_num_threads(2)
    x, z = _starts(n_carbons, b=2)
    calc = SpanCalc(SQM2(device="cpu"))
    calc.begin_job()
    res = optimize_batch(calc, x, z, config=OptimizeConfig(), n_steps=8,
                         device="cpu")
    rec = calc.jobs[0]
    mol = sqm2.Molecule(z, "cpu")
    h0 = sqm2.hessian(rec[1][1], mol)
    opt = dict(max_force=3e-4, rms_force=2e-4, max_displacement=1.5e-3,
               rms_displacement=1e-3, trust_radius_ang=0.5,
               trust_radius_min_ang=0.01)
    gap, x_end = rfo.replay(rec[0][1], rec[0][2], rec[0][3], h0,
                            [r[1:] for r in rec[2:]], opt)
    assert len(rec) == 2 + 8 and gap.max() < 1e-8
    assert (x_end - res.coords).abs().max() < 1e-8
    # a step of another length is seen
    bad = [(r[1] + 1e-5, r[2], r[3]) for r in rec[2:]]
    assert rfo.replay(rec[0][1], rec[0][2], rec[0][3], h0, bad,
                      opt)[0].max() > 1e-6


def test_projector_removes_rigid_motions():
    x, _ = _starts(3, b=2)
    p = rfo.projector(x)
    n = x.shape[1]
    shift = torch.zeros(2, n, 3, dtype=x.dtype)
    shift[..., 0] = 1.0
    spin = torch.linalg.cross(torch.tensor([0.0, 0.0, 1.0], dtype=x.dtype)
                              .expand(2, n, 3), x - x.mean(1, keepdim=True),
                              dim=-1)
    for v in (shift, spin):
        assert (p @ v.reshape(2, -1, 1)).abs().max() < 1e-10
    assert torch.allclose(p @ p, p, atol=1e-12)
