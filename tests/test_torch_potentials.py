"""Port parity: the AFIR bias engine of multioptpy_tpu_torch against the JAX
package, with the flagship's two AFIR terms on the Diels-Alder reactant,
and the Muller-Brown surface with the base calculator's autodiff Hessian."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.calculators import model_surfaces as ref_mb
from multioptpy_tpu.io.fixtures import diels_alder_reactant
from multioptpy_tpu.potentials import BiasEngine as RefEngine
from multioptpy_tpu.potentials import get_potential as ref_get
from multioptpy_tpu.potentials.afir import afir_alpha as ref_alpha
from multioptpy_tpu.potentials.base import ang_to_bohr as ref_ang_to_bohr
from multioptpy_tpu_torch.calculators import model_surfaces as mb
from multioptpy_tpu_torch.potentials import BiasEngine, get_potential
from multioptpy_tpu_torch.potentials.afir import afir_alpha
from multioptpy_tpu_torch.potentials.base import ang_to_bohr

torch.set_num_threads(1)

_AFIR = [(300.0, [1], [11]), (300.0, [4], [12])]


def _engines(z):
    ref = RefEngine([ref_get("afir", gamma=g, fragm_1=f1, fragm_2=f2,
                             element_z=z) for g, f1, f2 in _AFIR])
    got = BiasEngine([get_potential("afir", gamma=g, fragm_1=f1, fragm_2=f2,
                                    element_z=z) for g, f1, f2 in _AFIR])
    return ref, got


def _batch(n=3, seed=0):
    coords, z = diels_alder_reactant()
    rng = np.random.default_rng(seed)
    return coords[None] + 0.05 * rng.standard_normal((n,) + coords.shape), z


def _rel(a, b):
    a = np.asarray(a)
    return np.abs(a - np.asarray(b)).max() / max(np.abs(a).max(), 1e-300)


@pytest.mark.parametrize("gamma", [0.0, 150.0, -300.0])
def test_afir_alpha_matches_reference(gamma):
    got = afir_alpha(torch.tensor(gamma, dtype=torch.float64)).item()
    assert got == pytest.approx(float(ref_alpha(jnp.asarray(gamma))),
                                rel=1e-14, abs=0.0)


def test_afir_energy_gradient_hessian_match_reference():
    x, z = _batch()
    ref, got = _engines(z)
    e, g = got.energy_and_gradient(torch.as_tensor(x))
    h = got.hessian(torch.as_tensor(x))
    assert e.shape == (3,) and g.shape == x.shape and h.shape == (3, 54, 54)
    for k in range(len(x)):
        re, rg = ref.energy_and_gradient(jnp.asarray(x[k]))
        rh = ref.hessian(jnp.asarray(x[k]))
        assert _rel(re, e[k].item()) < 1e-10
        assert _rel(rg, g[k].numpy()) < 1e-10
        assert _rel(rh, h[k].numpy()) < 1e-10
        assert float(ref.total_energy(jnp.asarray(x[k]))) == pytest.approx(
            got.total_energy(torch.as_tensor(x[k:k + 1])).item(), rel=1e-12)


def test_batched_bias_equals_single_members():
    x, z = _batch(seed=1)
    _, got = _engines(z)
    xt = torch.as_tensor(x)
    e, g = got.energy_and_gradient(xt)
    h = got.hessian(xt)
    for k in range(len(x)):
        e1, g1 = got.energy_and_gradient(xt[k:k + 1])
        h1 = got.hessian(xt[k:k + 1])
        torch.testing.assert_close(e1[0], e[k], rtol=1e-14, atol=0.0)
        torch.testing.assert_close(g1[0], g[k], rtol=1e-14, atol=1e-18)
        torch.testing.assert_close(h1[0], h[k], rtol=1e-12, atol=1e-16)


def test_unported_potentials_raise():
    """Every potential of the reference is ported now: only a name that
    neither package registers raises, as the reference's KeyError does."""
    with pytest.raises(KeyError, match="unknown bias potential"):
        get_potential("keep_fourier", spring_const=1.0)
    assert get_potential("keep", spring_const=1.0, distance=1.0,
                         atom_pair=[1, 2]).name == "keep"


def test_muller_brown_energy_and_autodiff_hessian_match_reference():
    pts = np.array([[[-0.8, 0.6, 0.1]], [[0.2, 0.3, -0.05]],
                    [[*ref_mb.MB_TS_AB, 0.0]]])
    calc = mb.MullerBrown(device="cpu")
    ref = ref_mb.MullerBrown()
    z = np.array([1])
    e, g = calc.energy_and_gradient(torch.as_tensor(pts), z)
    h = calc.hessian(torch.as_tensor(pts), z)
    for k in range(len(pts)):
        re, rg = ref.energy_and_gradient(jnp.asarray(pts[k]), jnp.asarray(z))
        rh = ref.hessian(jnp.asarray(pts[k]), jnp.asarray(z))
        assert _rel(re, e[k].item()) < 1e-10
        assert _rel(rg, g[k].numpy()) < 1e-10
        assert _rel(rh, h[k].numpy()) < 1e-10
    assert float(mb.muller_brown_energy(*mb.MB_TS_AB)) == pytest.approx(
        float(ref_mb.muller_brown_energy(*ref_mb.MB_TS_AB)), rel=1e-14)


def test_ang_to_bohr_matches_reference():
    for x in (1.54, [0.0, 1.09, -2.5], np.arange(6.0).reshape(2, 3)):
        got, want = ang_to_bohr(x), ref_ang_to_bohr(x)
        assert got.dtype == want.dtype == np.float64
        assert np.array_equal(got, want)
