"""Port parity: the NEB layer of multioptpy_tpu_torch (forces, FIRE, linear
resampling, the band driver with its chunked semantics, a band resumed from
the reference's state) against the JAX package, on Muller-Brown and on an
HCN+ -> HNC+ band of 5 images (SQM2)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.calculators import sqm as ref_sqm
from multioptpy_tpu.calculators.model_surfaces import MullerBrown as RefMB
from multioptpy_tpu.interpolation import linear_resample as ref_resample
from multioptpy_tpu.steppers import first_order as ref_fo
from multioptpy_tpu_torch.calculators import sqm
from multioptpy_tpu_torch.calculators.model_surfaces import (MB_MIN_A,
                                                             MB_MIN_C,
                                                             MullerBrown)
from multioptpy_tpu_torch.interpolation import (linear_resample,
                                                redistribute_path)
from multioptpy_tpu_torch.steppers import first_order as fo

ref_neb = importlib.import_module("multioptpy_tpu.drivers.neb")
neb = importlib.import_module("multioptpy_tpu_torch.drivers.neb")

torch.set_num_threads(1)

_ANG = 1.8897261254578281
_HCN = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.156], [0.1, 0.0, -1.064]])
_HNC = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.17], [0.1, 0.0, 2.17]])
_Z_HCN = np.array([6, 7, 1])


def _mb_path(n=9):
    a = np.array([[MB_MIN_A[0], MB_MIN_A[1], 0.0]])
    c = np.array([[MB_MIN_C[0], MB_MIN_C[1], 0.0]])
    return np.asarray(ref_neb.interpolate_linear(jnp.asarray(a),
                                                 jnp.asarray(c), n))


def _random_band(seed, n_img=6, n_atoms=4):
    rng = np.random.default_rng(seed)
    path = np.cumsum(0.3 * rng.standard_normal((n_img, n_atoms, 3)), 0)
    return (path, rng.standard_normal(n_img),
            rng.standard_normal((n_img, n_atoms, 3)))


@pytest.mark.parametrize("variant,climbing", [("neb", False),
                                              ("cineb", True),
                                              ("neb", True)])
def test_neb_forces_match_reference(variant, climbing):
    path, e, g = _random_band(1)
    for endpoints in (False, True):
        ref = ref_neb.neb_forces(jnp.asarray(path), jnp.asarray(e),
                                 jnp.asarray(g), 0.02, variant, climbing,
                                 endpoints)
        got = neb.neb_forces(torch.as_tensor(path), torch.as_tensor(e),
                             torch.as_tensor(g), 0.02, variant, climbing,
                             endpoints)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=1e-14)


def test_other_variants_and_optimizers_raise():
    """Every variant, clock and scheme of the reference runs in the port
    (tests/test_torch_neb_family.py); names outside them raise as in the
    reference."""
    path, e, g = _random_band(2)
    with pytest.raises(ValueError, match="unknown NEB variant"):
        neb.neb_forces(torch.as_tensor(path), torch.as_tensor(e),
                       torch.as_tensor(g), variant="fneb")
    calc = MullerBrown(device="cpu")
    with pytest.raises(ValueError, match="unknown NEB optimizer"):
        neb.neb(calc, _mb_path(), [1], neb.NEBConfig(optimizer="bfgs"),
                device="cpu")
    with pytest.raises(ValueError, match="unknown redistribution scheme"):
        neb.neb(calc, _mb_path(), [1],
                neb.NEBConfig(n_steps=3, redistribute="cubic",
                              redistribute_every=2), device="cpu")


def test_fire_step_matches_reference():
    rng = np.random.default_rng(3)
    ref_state = ref_fo.fire_init(12, jnp.float64, dt0=0.05)
    state = fo.fire_init(12, torch.float64, dt0=0.05)
    for _ in range(9):   # downhill streaks and uphill resets
        grad = rng.standard_normal(12)
        ref_mv, ref_state = ref_fo.fire_step(ref_state, jnp.asarray(grad),
                                             dt_max=0.2)
        mv, state = fo.fire_step(state, torch.as_tensor(grad), dt_max=0.2)
        np.testing.assert_allclose(mv.numpy(), np.asarray(ref_mv),
                                   rtol=1e-12, atol=1e-15)
        for a, b in zip(state, ref_state):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                       atol=1e-15)


def test_linear_resample_and_redistribution_match_reference():
    path, _, _ = _random_band(4, n_img=7)
    for n_out in (4, 7, 12):
        np.testing.assert_allclose(
            linear_resample(torch.as_tensor(path), n_out).numpy(),
            np.asarray(ref_resample(jnp.asarray(path), n_out)),
            rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        redistribute_path(torch.as_tensor(path), "linear").numpy(),
        np.asarray(ref_resample(jnp.asarray(path), 7)), rtol=1e-12,
        atol=1e-14)
    a, c = path[0], path[-1]
    np.testing.assert_allclose(
        neb.interpolate_linear(torch.as_tensor(a), torch.as_tensor(c),
                               6).numpy(),
        np.asarray(ref_neb.interpolate_linear(jnp.asarray(a), jnp.asarray(c),
                                              6)), rtol=1e-14, atol=1e-15)


@pytest.mark.parametrize("every", [3, 2])
@pytest.mark.parametrize("scan_chunk", [0, 4])
def test_neb_on_muller_brown_matches_reference(scan_chunk, every):
    """Per-step and chunked drivers, with a linear redistribution every 3
    iterations and an early fmax exit inside a chunk, or every 2, where the
    band converges on a redistribution iteration (46): the chunked driver
    returns the band before that redistribution, the per-step loop after
    it."""
    kw = dict(variant="cineb", n_steps=60, k_spring=5e-4, climbing_start=5,
              fmax=2e-2, dt0=0.05, dt_max=0.4, redistribute="linear",
              redistribute_every=every, scan_chunk=scan_chunk)
    path = _mb_path()
    ref = ref_neb.neb(RefMB(), jnp.asarray(path), jnp.array([1]),
                      ref_neb.NEBConfig(**kw))
    got = neb.neb(MullerBrown(device="cpu"), path, np.array([1]),
                  neb.NEBConfig(**kw), device="cpu")
    assert got.n_iterations == ref.n_iterations < 60
    assert got.converged and bool(ref.converged)
    assert got.ts_index == ref.ts_index
    np.testing.assert_allclose(got.energy_history,
                               np.asarray(ref.energy_history), rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(got.path.numpy(), np.asarray(ref.path),
                               rtol=0, atol=1e-12)


def test_neb_five_iterations_on_muller_brown():
    kw = dict(variant="cineb", n_steps=5, climbing_start=2, fmax=1e-9,
              dt0=0.05, dt_max=0.2)
    path = _mb_path(7)
    ref = ref_neb.neb(RefMB(), jnp.asarray(path), jnp.array([1]),
                      ref_neb.NEBConfig(**kw))
    got = neb.neb(MullerBrown(device="cpu"), path, np.array([1]),
                  neb.NEBConfig(**kw), device="cpu")
    assert got.n_iterations == 5 and ref.n_iterations == 5
    np.testing.assert_allclose(got.path.numpy(), np.asarray(ref.path),
                               rtol=0, atol=1e-13)


def test_hcn_band_five_iterations_match_reference():
    """5 NEB iterations of a 5-image HCN+ -> HNC+ band on SQM2, one batched
    calculator call per iteration."""
    a, c = _HCN * _ANG, _HNC * _ANG
    path = np.asarray(ref_neb.interpolate_linear(jnp.asarray(a),
                                                 jnp.asarray(c), 5))
    kw = dict(variant="cineb", n_steps=5, k_spring=0.01, climbing_start=3,
              fmax=1e-9, dt0=0.05, dt_max=0.2)
    ref = ref_neb.neb(ref_sqm.SQM2(charge=1), jnp.asarray(path),
                      jnp.asarray(_Z_HCN), ref_neb.NEBConfig(**kw))
    got = neb.neb(sqm.SQM2(charge=1, device="cpu"), path, _Z_HCN,
                  neb.NEBConfig(**kw), device="cpu")
    np.testing.assert_allclose(got.energy_history,
                               np.asarray(ref.energy_history), rtol=1e-10,
                               atol=0)
    np.testing.assert_allclose(got.path.numpy(), np.asarray(ref.path),
                               rtol=0, atol=1e-9)


def test_band_resumed_from_reference_state():
    """Both packages continue one band from the reference's mid-run path,
    FIRE state and iteration (neb_state_from_numpy)."""
    cfg_kw = dict(variant="cineb", climbing_start=4, k_spring=5e-4,
                  dt0=0.05, dt_max=0.4)
    ref_step = jax.jit(ref_neb.make_neb_step(RefMB(), jnp.array([1]),
                                             ref_neb.NEBConfig(**cfg_kw)))
    path = jnp.asarray(_mb_path())
    fire = ref_fo.fire_init(path.size, jnp.float64, dt0=0.05)
    for it in range(1, 4):
        path, fire, _, _, _ = ref_step(path, fire, jnp.asarray(it))
    p, f, it0 = neb.neb_state_from_numpy(
        np.asarray(path), {k: np.asarray(v) for k, v in
                           fire._asdict().items()}, 3, device="cpu")
    step = neb.make_neb_step(MullerBrown(device="cpu"), np.array([1]),
                             neb.NEBConfig(**cfg_kw))
    for it in range(it0 + 1, it0 + 3):
        path, fire, e_ref, _, fm_ref = ref_step(path, fire, jnp.asarray(it))
        p, f, e, _, fm = step(p, f, it)
        np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), rtol=1e-12)
        np.testing.assert_allclose(p.numpy(), np.asarray(path), rtol=0,
                                   atol=1e-13)
        assert float(fm) == pytest.approx(float(fm_ref), rel=1e-10)
