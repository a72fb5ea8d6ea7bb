"""Port parity: GP-accelerated NEB (multioptpy_tpu_torch.drivers.gpneb)
against the JAX package on Muller-Brown and on a 6-image Ar5 band (LJ).
The surrogate solve carries a 1e-8 nugget, so its conditioning reaches
~1e8 and amplifies rounding: paths are held to 1e-9 Bohr and true energies
to 1e-10 Ha after the rounds (measured 2.7e-11 Bohr and 4.5e-12 Ha on
Muller-Brown, 3.9e-13 Bohr on Ar5)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.calculators.lj import LennardJones as RefLJ
from multioptpy_tpu.calculators.model_surfaces import MullerBrown as RefMB
from multioptpy_tpu_torch.calculators.lj import LennardJones
from multioptpy_tpu_torch.calculators.model_surfaces import (MB_MIN_A,
                                                             MB_MIN_C,
                                                             MullerBrown)

ref_gp = importlib.import_module("multioptpy_tpu.drivers.gpneb")
gpneb = importlib.import_module("multioptpy_tpu_torch.drivers.gpneb")
ref_neb = importlib.import_module("multioptpy_tpu.drivers.neb")

torch.set_num_threads(1)

_AR = np.full(5, 18)
_AR5_A = np.array([[0.0, 0.0, 0.0], [7.1, 0.0, 0.0], [3.55, 6.15, 0.0],
                   [3.55, 2.05, 5.8], [3.55, 2.05, -5.8]])
_AR5_B = _AR5_A.copy()
_AR5_B[4] = [3.55, -6.0, -3.0]


def _line(a, b, n):
    return np.array(ref_neb.interpolate_linear(jnp.asarray(a),
                                               jnp.asarray(b), n))


def _check(ref, got):
    np.testing.assert_allclose(got.path.numpy(), np.asarray(ref.path),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.energies.numpy(),
                               np.asarray(ref.energies), rtol=0, atol=1e-10)
    assert got.n_true_evaluations == ref.n_true_evaluations
    assert got.converged == bool(ref.converged)
    assert got.ts_index == ref.ts_index


def test_gpneb_on_muller_brown_matches_reference():
    a = np.array([[MB_MIN_A[0], MB_MIN_A[1], 0.0]])
    c = np.array([[MB_MIN_C[0], MB_MIN_C[1], 0.0]])
    path = _line(a, c, 7)
    kw = dict(n_outer=3, n_inner=15, k_spring=5e-4, lengthscale=0.5,
              max_history=16, fmax=1e-9)
    ref = ref_gp.gpneb(RefMB(), jnp.asarray(path), jnp.array([1]),
                       ref_gp.GPNEBConfig(**kw))
    got = gpneb.gpneb(MullerBrown(device="cpu"), path, [1],
                      gpneb.GPNEBConfig(**kw), device="cpu")
    assert got.n_true_evaluations == 21
    assert not np.allclose(got.path.numpy(), path)
    _check(ref, got)


def test_gpneb_on_an_ar5_band_matches_reference():
    """Two rounds: the ring of 8 observations wraps (12 pushes)."""
    path = _line(_AR5_A, _AR5_B, 6)
    kw = dict(n_outer=2, n_inner=10, k_spring=0.005, lengthscale=4.0,
              max_history=8, dt0=1.0, dt_max=2.0, fmax=1e-9)
    ref = ref_gp.gpneb(RefLJ(), jnp.asarray(path), jnp.asarray(_AR),
                       ref_gp.GPNEBConfig(**kw))
    got = gpneb.gpneb(LennardJones(device="cpu"), path, _AR,
                      gpneb.GPNEBConfig(**kw), device="cpu")
    _check(ref, got)


def test_gpneb_converges_at_once_and_refuses_a_non_mesh():
    path = _line(_AR5_A, _AR5_B, 5)
    cfg = gpneb.GPNEBConfig(n_outer=2, fmax=1.0)
    got = gpneb.gpneb(LennardJones(device="cpu"), path, _AR, cfg,
                      device="cpu")
    assert got.converged and got.n_true_evaluations == 5
    with pytest.raises(TypeError, match="Mesh"):
        gpneb.gpneb(LennardJones(device="cpu"), path, _AR, cfg,
                    mesh=object(), device="cpu")
