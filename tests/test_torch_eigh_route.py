"""eigh_fast's K1 route converges the hot path's own matrices at its one
sweep count (`eigh64.k1_sweeps`). On the CPU, K1's plain version
(`jacobi_eigh_plain`, the kernel's algorithm, which the card holds the
kernel to) stands in for the kernel, against torch.linalg.eigh (LAPACK),
on what the batch cells diagonalize: the Loewdin overlaps of 16 displaced
n-octane and Diels-Alder structures and a slice of the exact Hessian's
displaced ones, their EEQ matrices, and the RS-RFO step's TR/rot-projected
Hessians."""

import numpy as np
import pytest
import torch

from multioptpy_tpu_torch.calculators import sqm
from multioptpy_tpu_torch.calculators.sqm import SQM2
from multioptpy_tpu_torch.geometry import (project_gradient_tr_rot,
                                           tr_rot_projector)
from multioptpy_tpu_torch.io.fixtures import alkane_chain, diels_alder_reactant
from multioptpy_tpu_torch.ops import eigh64
from multioptpy_tpu_torch.ops.jacobi_cuda import jacobi_eigh_plain
from multioptpy_tpu_torch.steppers.rfo import rs_rfo_step
from multioptpy_tpu_torch.units import ANGSTROM2BOHR

torch.set_num_threads(1)

# molecule: (coords, z), displacement (Angstrom) as the batch cells draw it
MOLECULES = {"n-octane": (alkane_chain(8), 0.10),
             "diels-alder": (diels_alder_reactant(), 0.05)}
BATCH = 16
HESSIANS = 2          # members whose exact Hessian the test builds
OVERLAP_SLICE = 16    # of their 6N displaced overlaps each


def _k1_plain(a):
    return jacobi_eigh_plain(a, eigh64.k1_sweeps(a.shape[-1], a.dtype))


@pytest.fixture(scope="module", params=sorted(MOLECULES))
def hot_path(request):
    """What SQM2 hands `inv_sqrt_psd` and `eigh_solve` for 16 displaced
    structures and for the exact Hessians of two of them, and the RS-RFO
    step's inputs at those two."""
    (c, z), sigma = MOLECULES[request.param]
    rng = np.random.default_rng(16)
    x = torch.as_tensor(c[None] + sigma * ANGSTROM2BOHR
                        * rng.standard_normal((BATCH,) + c.shape))
    seen = {"s": [], "eeq": []}
    isp, solve = sqm.inv_sqrt_psd, sqm.eigh_solve

    def keep_s(s, *args):
        seen["s"].append(s.detach().clone())
        return isp(s, *args)

    def keep_eeq(a, b):
        seen["eeq"].append((a.detach().clone(), b.detach().clone()))
        return solve(a, b)

    calc = SQM2(device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sqm, "inv_sqrt_psd", keep_s)
        mp.setattr(sqm, "eigh_solve", keep_eeq)
        _, g = calc.energy_and_gradient(x, z)
        s16, eeq16 = seen["s"][-1], seen["eeq"][-1]
        h = calc.hessian(x[:HESSIANS], z)
    displaced = seen["s"][-1]
    pick = torch.linspace(0, displaced.shape[0] - 1, OVERLAP_SLICE).long()
    xs = x[:HESSIANS]
    p = tr_rot_projector(xs)
    eye = torch.eye(h.shape[-1], dtype=h.dtype)
    h_eff = p.mT @ h @ p
    h_eff = 0.5 * (h_eff + h_eff.mT) + 1e3 * (eye - p)
    g_flat = project_gradient_tr_rot(g[:HESSIANS], xs).reshape(HESSIANS, -1)
    return {"name": request.param, "s": s16, "s_displaced": displaced[pick],
            "eeq": eeq16, "h_eff": h_eff, "g": g_flat}


def _inv_sqrt_and_grad(s, probe):
    s = s.clone().requires_grad_(True)
    y = eigh64.inv_sqrt_psd(s)
    (g,) = torch.autograd.grad((y * probe).sum(), s)
    return y.detach(), g


@pytest.mark.parametrize("which", ["s", "s_displaced"])
def test_loewdin_on_the_k1_route_matches_lapack(hot_path, which,
                                                monkeypatch):
    """S^-1/2 to 1e-12 of its largest entry, its backward to 1e-10."""
    s = hot_path[which]
    assert s.shape[-1] == {"n-octane": 104, "diels-alder": 72}[
        hot_path["name"]]
    probe = torch.as_tensor(np.random.default_rng(3).standard_normal(
        s.shape))
    y_ref, g_ref = _inv_sqrt_and_grad(s, probe)
    monkeypatch.setattr(eigh64, "eigh_fast", _k1_plain)
    y, g = _inv_sqrt_and_grad(s, probe)
    assert (y - y_ref).abs().max() <= 1e-12 * y_ref.abs().max()
    assert (g - g_ref).abs().max() <= 1e-10 * g_ref.abs().max()


def test_eeq_solve_on_the_k1_route_matches_lapack(hot_path, monkeypatch):
    """The bordered EEQ systems (N + 1, indefinite) to 1e-12 of max|x|."""
    a, b = hot_path["eeq"]
    x_ref = eigh64.eigh_solve(a, b)
    monkeypatch.setattr(eigh64, "eigh_fast", _k1_plain)
    x = eigh64.eigh_solve(a, b)
    assert (x - x_ref).abs().max() <= 1e-12 * x_ref.abs().max()


def test_rs_rfo_step_on_the_k1_route_matches_lapack(hot_path):
    """The step from the exact start Hessian (TR/rot-projected, the
    projected-out block at 1e3) to 1e-10 Bohr; "kernel" is K1's plain
    version at the route's sweep count."""
    h, g = hot_path["h_eff"], hot_path["g"]
    trust = torch.full((h.shape[0],), 0.5 * ANGSTROM2BOHR,
                       dtype=torch.float64)
    exact, _ = rs_rfo_step(g, h, trust, eigh_impl="xla")
    got, _ = rs_rfo_step(g, h, trust, eigh_impl="kernel")
    assert (got - exact).abs().max() <= 1e-10
