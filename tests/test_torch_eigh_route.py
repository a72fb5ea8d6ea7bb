"""eigh_fast's K1 route converges the hot path's own matrices at its one
sweep count (`eigh64.k1_sweeps`). On the CPU, K1's plain version
(`jacobi_eigh_plain`, the kernel's algorithm, which the card holds the
kernel to) stands in for the kernel, against torch.linalg.eigh (LAPACK),
on what the batch cells diagonalize: the Loewdin overlaps of 16 displaced
n-octane and Diels-Alder structures and a slice of the exact Hessian's
displaced ones, their EEQ matrices, and the RS-RFO step's TR/rot-projected
Hessians. Past K1's gate the route takes K3 (`ops/tridiag_cuda.py`) from
its own measured batch, and nowhere else."""

import numpy as np
import pytest
import torch

from multioptpy_tpu_torch.calculators import sqm
from multioptpy_tpu_torch.calculators.sqm import SQM2
from multioptpy_tpu_torch.geometry import (project_gradient_tr_rot,
                                           tr_rot_projector)
from multioptpy_tpu_torch.io.fixtures import alkane_chain, diels_alder_reactant
from multioptpy_tpu_torch.ops import eigh64, tridiag_cuda
from multioptpy_tpu_torch.ops.jacobi_cuda import jacobi_eigh_plain, max_dim
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


# (B, D) of every f64 eigh_fast call the benchmark's cells pose, and its
# route: the RS-RFO step (D = 3N), Loewdin (band order), EEQ (N + 1) at B = 1
# or the batch, and the exact Hessian's 6N displaced structures
CELL_SHAPES = [
    (1, 54, "cusolver"), (1, 72, "cusolver"), (1, 20, "k1"),     # da.opt1
    (108, 72, "k1"), (108, 20, "k1"),
    (1, 78, "cusolver"), (1, 104, "cusolver"), (1, 28, "k1"),    # octane.opt1
    (156, 104, "k1"), (156, 28, "k1"),
    (16, 78, "k1"), (16, 104, "k1"), (16, 28, "k1"),           # octane.conf16
    (2496, 104, "k1"), (2496, 28, "k1"),
    (16, 54, "k1"), (16, 72, "k1"), (16, 20, "k1"),              # da.orient16
    (1728, 72, "k1"), (1728, 20, "k1"),
    (1, 294, "cusolver"), (1, 392, "cusolver"), (1, 99, "cusolver"),  # c32h66
    (588, 99, "k1"),
]


@pytest.mark.parametrize("b, d, route", CELL_SHAPES)
def test_the_cells_shapes_route_as_before(b, d, route):
    assert eigh64.eigh_route("cuda", torch.float64, d, b, False) == route


def test_the_c32h66_start_goes_to_k3():
    """The exact Hessian's 588 band and Loewdin matrices at D = 392, the
    one shape of the cells that moved off cuSOLVER; grad-tracked, off the
    card or in f32 it does not."""
    assert eigh64.eigh_route("cuda", torch.float64, 392, 588, False) == "k3"
    route = eigh64.eigh_route
    assert route("cuda", torch.float64, 392, 588, True) == "cusolver"
    assert route("cpu", torch.float64, 392, 588, False) == "cpu"
    assert route("cuda", torch.float32, 392, 588, False) == "cusolver"


def b_min3(d):
    return eigh64.b_min(d, torch.float64, eigh64.K3_MIN_BATCH)


def test_k3_only_past_k1s_gate_from_b_min3():
    """"k3" exactly where D is past K1's gate (D > 120 in f64) and B is at
    least `b_min` by K3_MIN_BATCH (`b_min3`); never in f32, whose K1 gate
    is 168 and which K3 does not take; K1's region routes as `b_min`
    says."""
    top = max_dim(torch.float64)
    batches = (1, 2, 3, 4, 6, 8, 16, 100, 588, 2496)
    for d in range(2, 840):
        need = b_min3(d)
        for b in batches:
            route = eigh64.eigh_route("cuda", torch.float64, d, b, False)
            want_k3 = d + d % 2 > top and need is not None and b >= need
            assert (route == "k3") == want_k3, (d, b, route)
            if d + d % 2 > top:
                assert route in ("k3", "cusolver")
            assert eigh64.eigh_route("cuda", torch.float32, d, b,
                                     False) != "k3"
    table = eigh64.K3_MIN_BATCH[torch.float64]
    assert min(table) > top and max(table) <= tridiag_cuda.max_dim()
    assert b_min3(min(table) - 1) is None
    assert b_min3(max(table) + 1) is None
    dims = sorted(table)
    for lo, hi in zip(dims, dims[1:]):
        assert b_min3((lo + hi) // 2) == max(table[lo], table[hi])


# --------------------------------------------------------------- the plan
#
# `eigh64.plan` against the routes of the five dispatchers it replaced
# (`steppers.rfo._eigh`, `calculators.sqm._sqm_eigh`,
# `jacobi_cuda.jacobi_eigh_auto`, `eigh64._seed_eigh_f32`, `eigh_fast`),
# written down from them as literals.

DIMS = (20, 24, 28, 32, 54, 72, 78, 104, 120, 122, 168, 170, 200, 294, 392)
BATCHES = (1, 2, 3, 6, 16, 588)
F64, F32 = torch.float64, torch.float32
# jacobi_sweeps_for(D): 5 + ceil(log2(max(D, 16) / 16))
SWEEPS = {20: 6, 24: 6, 28: 6, 32: 6, 54: 7, 72: 8, 78: 8, 104: 8, 120: 8,
          122: 8, 168: 9, 170: 9, 200: 9, 294: 10, 392: 10}
# the step's extra K1 sweeps (the band's is 1), and K1's even-D gate
STEP_EXTRA = {F64: 7, F32: 1}
K1_GATE = {F64: 120, F32: 168}
# eigh_fast on the card, input not grad-tracked, at the BATCHES: K1 (k),
# K3 (3) or cuSOLVER (c)
FAST = {
    F64: {20: "kkkkkk", 24: "kkkkkk", 28: "kkkkkk", 32: "ckkkkk",
          54: "ckkkkk", 72: "ckkkkk", 78: "ckkkkk", 104: "cckkkk",
          120: "ccckkk", 122: "ccc333", 168: "cccc33", 170: "cccc33",
          200: "cccc33", 294: "cccc33", 392: "cccc33"},
    F32: {20: "cccccc", 24: "kkkkkk", 28: "kkkkkk", 32: "kkkkkk",
          **{d: "cccccc" for d in (54, 72, 78, 104, 120, 122, 168, 170, 200,
                                   294, 392)}},
}
# knob value: (step on CUDA, step on the CPU, band on CUDA, band on the CPU)
RULES = {
    "pallas": ("gate", "jacobi", "gate", "jacobi"),
    "kernel": ("gate", "gate", "gate", "gate"),
    "jacobi": ("jacobi", "jacobi", "fast", "fast"),
    "auto": ("fast", "fast", "gate", "fast"),
    "seeded": ("fast", "fast", "seeded", "seeded"),
    "xla": ("fast", "fast", "fast", "fast"),
    "anything": ("fast", "fast", "fast", "fast"),
}


def _callable_impl(a, sweeps):
    raise AssertionError("the planner calls nothing")


def _fast(device, dtype, d, b, grad):
    if device == "cpu":
        return "cpu", None
    if grad:
        return "cusolver", None
    route = {"k": "k1", "3": "k3", "c": "cusolver"}[
        FAST[dtype][d][BATCHES.index(b)]]
    return route, (SWEEPS[d] + STEP_EXTRA[dtype] if route == "k1" else None)


def _parent(impl, caller, device, dtype, d, b, grad):
    sweeps = SWEEPS[d] + (STEP_EXTRA[dtype] if caller == "step" else 1)
    if callable(impl):
        return "callable", sweeps
    rule = RULES[impl][(caller == "band") * 2 + (device == "cpu")]
    if rule == "jacobi":
        return "jacobi", SWEEPS[d]
    if rule == "seeded":
        return "seeded", None
    if rule == "gate" and d <= K1_GATE[dtype]:
        return "k1", sweeps
    return _fast(device, dtype, d, b, grad)


@pytest.mark.parametrize("impl", [*RULES, _callable_impl],
                         ids=[*RULES, "callable"])
@pytest.mark.parametrize("caller", ["step", "band"])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_plan_matches_the_parent(impl, caller, device, dtype):
    for d in DIMS:
        for b in BATCHES:
            for grad in (False, True):
                want = _parent(impl, caller, device, dtype, d, b, grad)
                got = eigh64.plan(impl, caller, device, dtype, d, b, grad)
                assert got == want, (d, b, grad)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_seeded_eighs_seed_matches_the_parent(device):
    """The f32 seed: K1 at 8 sweeps at or below the f32 gate on the card,
    else eigh_fast, whatever the knob."""
    for d in DIMS:
        for b in BATCHES:
            for grad in (False, True):
                if device == "cuda" and d <= K1_GATE[F32]:
                    want = ("k1", 8)
                else:
                    want = _fast(device, F32, d, b, grad)
                for impl in ("seeded", "xla"):
                    got = eigh64.plan(impl, "seed", device, F32, d, b, grad)
                    assert got == want, (d, b, grad)
