"""Port parity: the RS-P-RFO step, mode following and the classic RFO step
against multioptpy_tpu/steppers/rfo.py, and the RS-P-RFO driver on H2O+.

The port's step is batched (B, D); the reference runs one row at a time.
Steps, shifts and followed modes agree to 1e-10 relative (f64) on seeded
symmetric matrices, for the unrestricted and the trust-restricted
(alpha-bisection) branch in one batch. `eigh_impl="kernel"` (the Jacobi
kernel's algorithm, the card's sweep count) is held against the
reference's "jacobi" route: both converge at D = 9. The f32 routes agree
with the reference's f64 step to 3e-5 of the largest entry (the
tolerance of tests/test_jacobi_pallas.py)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.calculators import sqm as ref_sqm
from multioptpy_tpu.steppers import rfo as ref
from multioptpy_tpu_torch.calculators import sqm
from multioptpy_tpu_torch.steppers import rfo

ref_opt = importlib.import_module("multioptpy_tpu.drivers.optimize")
opt = importlib.import_module("multioptpy_tpu_torch.drivers.optimize")

torch.set_num_threads(1)

_D = 9


def _problem(seed, b=4):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, _D, _D))
    h = a + np.swapaxes(a, 1, 2)
    g = rng.standard_normal((b, _D))
    # rows 0-1 fit the trust radius unrestricted, rows 2-3 are restricted
    trust = np.array([50.0, 20.0, 0.05, 0.2])[:b]
    follow = rng.standard_normal((b, _D))
    return h, g, trust, follow


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10,
                               atol=1e-13, err_msg=what)


@pytest.mark.parametrize("port_impl,ref_impl", [("xla", "xla"),
                                                ("kernel", "jacobi")])
@pytest.mark.parametrize("follow", [False, True])
@pytest.mark.parametrize("saddle_order", [1, 2])
def test_rs_prfo_step_matches_reference(port_impl, ref_impl, follow,
                                        saddle_order):
    h, g, trust, fv = _problem(1 + saddle_order)
    kw = {}
    if follow:
        kw["follow_vector"] = torch.as_tensor(fv)
    got, aux = rfo.rs_prfo_step(torch.as_tensor(g), torch.as_tensor(h),
                                torch.as_tensor(trust),
                                saddle_order=saddle_order,
                                eigh_impl=port_impl, **kw)
    for i in range(len(g)):
        rkw = {"follow_vector": jnp.asarray(fv[i])} if follow else {}
        want, raux = ref.rs_prfo_step(jnp.asarray(g[i]), jnp.asarray(h[i]),
                                      trust[i], saddle_order=saddle_order,
                                      eigh_impl=ref_impl, **rkw)
        _close(got[i].numpy(), want, f"step {i}")
        for key in ("predicted_energy_change", "lambda_min", "lambda_max",
                    "step_norm"):
            _close(aux[key][i].numpy(), raux[key], f"{key} {i}")
        # eigenvector signs differ between solvers unless sign-aligned
        # (mode following aligns them to the followed vector)
        mode, want_mode = aux["followed_mode"][i].numpy(), np.asarray(
            raux["followed_mode"])
        if not follow:
            mode = mode * np.sign(mode @ want_mode)
        _close(mode, want_mode, f"followed_mode {i}")
    assert (torch.linalg.vector_norm(got, dim=-1)
            <= torch.as_tensor(trust) * (1 + 1e-12)).all()


def test_rs_prfo_step_falls_back_on_a_broken_hessian():
    h, g, trust, _ = _problem(5, b=2)
    h[1, 0, 0] = np.nan
    got, _ = rfo.rs_prfo_step(torch.as_tensor(g), torch.as_tensor(h),
                              torch.as_tensor(trust))
    want, _ = ref.rs_prfo_step(jnp.asarray(g[1]), jnp.asarray(h[1]),
                               trust[1])
    assert np.isfinite(got.numpy()).all()
    _close(got[1].numpy(), want, "NaN row")


def test_rightmost_secular_root_matches_reference():
    rng = np.random.default_rng(6)
    poles = np.sort(rng.standard_normal((3, _D)), axis=-1)
    g2 = rng.uniform(0.01, 1.0, (3, _D))
    valid = rng.uniform(size=(3, _D)) > 0.2
    got = -rfo._leftmost_secular_root(torch.as_tensor(-poles),
                                      torch.as_tensor(g2),
                                      torch.as_tensor(valid))
    for i in range(3):
        want = ref._rightmost_secular_root(jnp.asarray(poles[i]),
                                           jnp.asarray(g2[i]),
                                           jnp.asarray(valid[i]))
        _close(got[i].numpy(), want, f"root {i}")


@pytest.mark.parametrize("mode", ["min", "max"])
def test_rfo_classic_step_matches_reference(mode):
    h, g, _, _ = _problem(7, b=3)
    got = rfo.rfo_classic_step(torch.as_tensor(g), torch.as_tensor(h),
                               mode=mode)
    for i in range(3):
        want = ref.rfo_classic_step(jnp.asarray(g[i]), jnp.asarray(h[i]),
                                    mode=mode)
        _close(got[i].numpy(), want, f"row {i}")


_H2O = np.array([[0.0, 0.0, 0.1173], [0.0, 0.95, -0.4692],
                 [0.0, -0.7572, -0.40]]) * 1.8897261254578281
_Z = np.array([8, 1, 1])


@pytest.mark.parametrize("method", ["rsprfo_bofill", "mf_rsirfo_fsb"])
def test_saddle_search_on_a_cation_matches_reference(method):
    """RS-P-RFO and mode following on H2O+ (SQM2; the open shell keeps the
    reference's Fermi search well conditioned), an exact Hessian every 2
    steps: 4 steps, energies to 1e-9 Ha (as tests/test_torch_optimize.py),
    geometries to 1e-8 Bohr."""
    kw = dict(method=method, saddle_order=1, fc_count=2, nsteps=4)
    ref_res = ref_opt.optimize(ref_sqm.SQM2(charge=1), jnp.asarray(_H2O),
                               jnp.asarray(_Z),
                               config=ref_opt.OptimizeConfig(**kw),
                               record_trajectory=True)
    got = opt.optimize(sqm.SQM2(charge=1, device="cpu"), _H2O, _Z,
                       config=opt.OptimizeConfig(**kw),
                       record_trajectory=True, device="cpu")
    assert got.n_iterations == ref_res.n_iterations
    np.testing.assert_allclose(got.energy_history,
                               np.asarray(ref_res.energy_history), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got.coords_history,
                               np.asarray(ref_res.coords_history), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("port_impl", ["xla", "kernel"])
def test_rs_prfo_step_in_f32_matches_reference(port_impl):
    """The f32 route against the reference's f64 step, at the tolerances of
    tests/test_jacobi_pallas.py (3e-5 of the largest entry)."""
    h, g, trust, _ = _problem(8)
    got, _ = rfo.rs_prfo_step(torch.as_tensor(g, dtype=torch.float32),
                              torch.as_tensor(h, dtype=torch.float32),
                              torch.as_tensor(trust, dtype=torch.float32),
                              eigh_impl=port_impl)
    assert got.dtype == torch.float32
    for i in range(len(g)):
        want = np.asarray(ref.rs_prfo_step(jnp.asarray(g[i]),
                                           jnp.asarray(h[i]), trust[i])[0])
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0,
                                   atol=3e-5 * max(1.0, np.abs(want).max()),
                                   err_msg=f"row {i}")


def test_mode_following_on_diels_alder_climbs_as_the_reference():
    """mf_rsirfo_bofill from the Diels-Alder reactant (+1 cation, SQM2, an
    exact Hessian every 5 steps) maximizes along the lowest mode of the
    starting Hessian and climbs, in both packages: 3 steps, energies to
    1e-9 relative (the seminumerical Hessian, step 1e-4, turns the
    packages' ~1e-12 gradient differences into ~1e-8 Hessian entries at
    this size, and each step along an uphill mode widens the gap)."""
    from multioptpy_tpu_torch.io.fixtures import diels_alder_reactant

    x0, z = diels_alder_reactant()
    kw = dict(method="mf_rsirfo_bofill", saddle_order=1, fc_count=5,
              nsteps=3)
    ref_res = ref_opt.optimize(ref_sqm.SQM2(charge=1), jnp.asarray(x0),
                               jnp.asarray(z),
                               config=ref_opt.OptimizeConfig(**kw))
    got = opt.optimize(sqm.SQM2(charge=1, device="cpu"), x0, z,
                       config=opt.OptimizeConfig(**kw), device="cpu")
    np.testing.assert_allclose(got.energy_history,
                               np.asarray(ref_res.energy_history),
                               rtol=1e-9, atol=0)
    assert (np.diff(got.energy_history) > 0).all()
