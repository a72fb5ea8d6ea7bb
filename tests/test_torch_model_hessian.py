"""Port parity: primitive detection, the D3/D4 dispersion pieces and the
lindh2007d3 model Hessians of multioptpy_tpu_torch against the JAX
package, on perturbed Diels-Alder reactants."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.coords import internals as ref_ic
from multioptpy_tpu.hessian import dispersion as ref_disp
from multioptpy_tpu.hessian import model as ref_model
from multioptpy_tpu.io.fixtures import diels_alder_reactant
from multioptpy_tpu_torch.coords import internals as ic
from multioptpy_tpu_torch.hessian import dispersion as disp
from multioptpy_tpu_torch.hessian import model

torch.set_num_threads(1)


def _batch(n=3, seed=0, noise=0.05):
    coords, z = diels_alder_reactant()
    rng = np.random.default_rng(seed)
    return coords[None] + noise * rng.standard_normal((n,) + coords.shape), z


def _rel(a, b):
    a = np.asarray(a)
    return np.abs(a - np.asarray(b)).max() / max(np.abs(a).max(), 1e-300)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_primitive_index_arrays_are_identical(seed):
    x, z = _batch(1, seed=seed, noise=0.3)
    # two fragments: the link-bond search and the near-linear filter run
    for with_linear in (False, True):
        ref = ref_ic.detect_primitives(x[0], z, with_linear=with_linear)
        got = ic.detect_primitives(x[0], z, with_linear=with_linear)
        assert len(ref) == len(got)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    for a, b in zip(ref_model.lindh2007_primitives(x[0], z),
                    model.lindh2007_primitives(x[0], z)):
        np.testing.assert_array_equal(a, b)


def test_linear_bend_axes_and_components_match_reference():
    coords = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 2.2], [0.05, 0.0, 4.4],
                       [3.0, 0.4, 9.0]])
    z = np.array([6, 7, 1, 1])
    ref = ref_ic.detect_primitives(coords, z, with_linear=True)
    got = ic.detect_primitives(coords, z, with_linear=True)
    assert len(got[3]) == 1
    np.testing.assert_array_equal(ref[3], got[3])
    np.testing.assert_allclose(ic.linear_bend_axes(coords, got[3]),
                               ref_ic.linear_bend_axes(coords, ref[3]),
                               rtol=0, atol=1e-15)
    adj = np.eye(5, dtype=bool)
    adj[0, 3] = adj[3, 0] = adj[1, 2] = adj[2, 1] = True
    assert ic._components(adj) == ref_ic._components(adj)


def test_primitive_values_and_wilson_matrix_match_reference():
    x, z = _batch(2, seed=3)
    b, a, t = ic.detect_primitives(x[0], z)
    lin = np.array([[0, 1, 2]], np.int32)
    axes = ic.linear_bend_axes(x[0], lin)
    ref = ref_ic.InternalCoordinates(b, a, t, len(z), lin, axes)
    got = ic.InternalCoordinates(b, a, t, len(z), lin, axes)
    q = got.q(torch.as_tensor(x))
    bm = got.b_matrix(torch.as_tensor(x))
    assert q.shape == (2, got.n_primitives)
    assert bm.shape == (2, got.n_primitives, 3 * len(z))
    for k in range(2):
        assert _rel(ref.q(jnp.asarray(x[k])), q[k].numpy()) < 1e-12
        assert _rel(ref.b_matrix(jnp.asarray(x[k])), bm[k].numpy()) < 1e-10
    np.testing.assert_array_equal(got.torsion_mask().numpy(),
                                  np.asarray(ref.torsion_mask()))


def test_d3_and_d4_pieces_match_reference():
    x, z = _batch()
    xt = torch.as_tensor(x)
    e, g, h = (disp.d3_energy(xt, z), disp.d3_gradient(xt, z),
               disp.d3_hessian(xt, z))
    q = disp.d4_charges(xt, z)
    for k in range(len(x)):
        xk = jnp.asarray(x[k])
        assert _rel(ref_disp.d3_energy(xk, z), e[k].item()) < 1e-12
        assert _rel(ref_disp.d3_gradient(xk, z), g[k].numpy()) < 1e-10
        assert _rel(ref_disp.d3_hessian(xk, z), h[k].numpy()) < 1e-10
        np.testing.assert_allclose(q[k].numpy(),
                                   np.asarray(ref_disp.d4_charges(xk, z)),
                                   rtol=0, atol=1e-15)
    r = np.linspace(2.0, 12.0, 7)
    c6, c8, r0 = (m[0, 10] for m in disp.d4_pair_tables(z))
    np.testing.assert_allclose(
        disp.d4_pair_force_const(torch.as_tensor(r), c6, c8, r0, 0.9).numpy(),
        np.asarray(ref_disp.d4_pair_force_const(jnp.asarray(r), c6, c8, r0,
                                                0.9)),
        rtol=1e-13, atol=0)


@pytest.mark.parametrize("kind", ["lindh2007d3_raw", "lindh2007d3"])
def test_model_hessian_matches_reference(kind):
    x, z = _batch()
    rng = np.random.default_rng(5)
    grad = 0.02 * rng.standard_normal(x.shape)
    got = model.model_hessian(torch.as_tensor(x), z, kind=kind,
                              gradient=torch.as_tensor(grad))
    assert got.shape == (3, 54, 54)
    for k in range(len(x)):
        ref = ref_model.model_hessian(jnp.asarray(x[k]), z, kind=kind,
                                      gradient=jnp.asarray(grad[k]))
        assert _rel(ref, got[k].numpy()) < 1e-10


def test_model_hessian_fn_on_detected_primitives_matches_reference():
    """The mfc_count rebuild: primitives detected once, then the closure."""
    x, z = _batch(2, seed=4)
    prims = ic.detect_primitives(x[0], z)
    fn = model.make_model_hessian_fn(z, *prims, "lindh2007d3_raw")
    ref_fn = ref_model.make_model_hessian_fn(z, *prims, "lindh2007d3_raw")
    got = fn(torch.as_tensor(x), None)
    for k in range(2):
        assert _rel(ref_fn(jnp.asarray(x[k]), None), got[k].numpy()) < 1e-10


def test_other_model_kinds_raise():
    x, z = _batch(1)
    for kind in ("lindh", "fischerd3", "lindh2007d4"):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1 item 10"):
            model.model_hessian(torch.as_tensor(x), z, kind=kind)
