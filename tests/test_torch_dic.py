"""Port parity: the delocalized-internal (DIC) engine of
multioptpy_tpu/coords/internals.py and the driver's `dic_rsirfo` route.

Two molecules cover the primitive kinds: H2O2 (stretches, bends, a
torsion) and a bent HCCH (stretches and the linear-bend pairs that
`auto_internals` puts in place of its near-linear bends). On a batch of two
geometries each, the G pseudo-inverse, the gradient transforms, the
curvature term and both Hessian transforms agree with the reference per
row to 1e-10 relative (f64); the DIC active space is compared as its
projector U U^T (eigenvector signs and rotations inside degenerate
eigenspaces differ between solvers). `to_cartesian` is 25 fixed
Gauss-Newton iterations in both: 1e-9 Bohr."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.calculators import sqm as ref_sqm
from multioptpy_tpu.coords import internals as ref
from multioptpy_tpu_torch.calculators import sqm
from multioptpy_tpu_torch.coords import internals

ref_opt = importlib.import_module("multioptpy_tpu.drivers.optimize")
opt = importlib.import_module("multioptpy_tpu_torch.drivers.optimize")

torch.set_num_threads(1)

_MOLECULES = {
    "h2o2": (np.array([[0.0, 1.32, -0.1], [0.0, -1.32, -0.1],
                       [1.65, 1.75, 0.75], [-1.55, -1.80, 0.85]]),
             np.array([8, 8, 1, 1])),
    "hcch": (np.array([[-3.1, 0.0, 0.0], [-1.14, 0.0, 0.05],
                       [1.14, 0.02, 0.0], [3.1, 0.1, 0.0]]),
             np.array([1, 6, 6, 1])),
}


def _setup(name, seed=0):
    x0, z = _MOLECULES[name]
    got = internals.auto_internals(x0, z)
    want = ref.auto_internals(x0, z)
    rng = np.random.default_rng(seed)
    x = x0[None] + 0.03 * rng.standard_normal((2, 4, 3))
    return got, want, x, rng


def _close(got, want, what, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("name", sorted(_MOLECULES))
def test_auto_internals_match_reference(name):
    got, want, _, _ = _setup(name)
    for field in ("bonds", "angles", "torsions", "linear_bends",
                  "linear_axes"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert got.n_primitives == want.n_primitives
    np.testing.assert_array_equal(got.torsion_mask().numpy(),
                                  np.asarray(want.torsion_mask()))
    if name == "hcch":
        assert len(got.linear_bends) == 2 and len(got.torsions) == 0


@pytest.mark.parametrize("name", sorted(_MOLECULES))
def test_gradient_and_hessian_transforms_match_reference(name):
    got, want, x, rng = _setup(name, 1)
    xt = torch.as_tensor(x)
    g_x = rng.standard_normal((2, 4, 3))
    m = got.n_primitives
    a = rng.standard_normal((2, m, m))
    h_q = a + a.transpose(0, 2, 1)
    a = rng.standard_normal((2, 12, 12))
    h_x = a + a.transpose(0, 2, 1)
    b = got.b_matrix(xt)
    g_q = got.cart_to_internal_gradient(torch.as_tensor(g_x), xt)
    outs = {
        "g_pinv": got.g_pinv(got.g_matrix(b)),
        "g_q": g_q,
        "g_x": got.internal_to_cart_gradient(g_q, xt),
        "curvature": got.curvature_correction(g_q, xt),
        "h_x": got.cart_hessian_from_internal(torch.as_tensor(h_q), g_q, xt),
        "h_q": got.internal_hessian_from_cart(torch.as_tensor(h_x),
                                              torch.as_tensor(g_x), xt),
    }
    for i in range(2):
        xi = jnp.asarray(x[i])
        bi = want.b_matrix(xi)
        gq = want.cart_to_internal_gradient(jnp.asarray(g_x[i]), xi)
        wants = {
            "g_pinv": want.g_pinv(want.g_matrix(bi)),
            "g_q": gq,
            "g_x": want.internal_to_cart_gradient(gq, xi),
            "curvature": want.curvature_correction(gq, xi),
            "h_x": want.cart_hessian_from_internal(jnp.asarray(h_q[i]), gq,
                                                   xi),
            "h_q": want.internal_hessian_from_cart(jnp.asarray(h_x[i]),
                                                   jnp.asarray(g_x[i]), xi),
        }
        for key, val in wants.items():
            val = np.asarray(val)
            _close(outs[key][i].numpy(), val, f"{key} {i}",
                   atol=1e-10 * max(np.abs(val).max(), 1.0))


@pytest.mark.parametrize("name", sorted(_MOLECULES))
def test_delocalized_basis_and_back_transform_match_reference(name):
    got, want, x, rng = _setup(name, 2)
    xt = torch.as_tensor(x)
    u, keep = got.delocalized_basis(xt)
    q0 = got.q(xt)
    dq = 0.02 * rng.standard_normal(q0.shape)
    # a step inside the active space, as dic_move takes it
    target = q0 + (u @ torch.as_tensor(dq)[..., None])[..., 0]
    back = got.to_cartesian(target, xt)
    for i in range(2):
        xi = jnp.asarray(x[i])
        u_r, keep_r = want.delocalized_basis(xi)
        u_r = np.asarray(u_r)
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(keep_r))
        _close((u[i] @ u[i].T).numpy(), u_r @ u_r.T, f"projector {i}",
               atol=1e-10)
        _close(back[i].numpy(),
               want.to_cartesian(jnp.asarray(target[i].numpy()), xi),
               f"to_cartesian {i}", rtol=0, atol=1e-9)
    # the back-transform reaches the target in the active space
    _close(got.q(back).numpy(), target.numpy(), "q(back)", rtol=0,
           atol=1e-6)


def test_dic_diagonal_guess_matches_reference():
    for name in _MOLECULES:
        got, want, _, _ = _setup(name)
        np.testing.assert_array_equal(
            opt._dic_diag_hessian(got, torch.float64).numpy(),
            np.asarray(ref_opt._dic_diag_hessian(want, jnp.float64)))


def test_dic_rsirfo_with_exact_hessians_matches_reference():
    """dic_rsirfo_fsb on H2O2+ (SQM2), an exact Hessian every 2 steps
    carried into primitive space (`internal_hessian_from_cart`): 3 steps,
    energies to 1e-9 Ha (as tests/test_torch_optimize.py), geometries to
    1e-8 Bohr."""
    x0, z = _MOLECULES["h2o2"]
    kw = dict(method="dic_rsirfo_fsb", fc_count=2, nsteps=3)
    want = ref_opt.optimize(ref_sqm.SQM2(charge=1), jnp.asarray(x0),
                            jnp.asarray(z),
                            config=ref_opt.OptimizeConfig(**kw),
                            record_trajectory=True)
    got = opt.optimize(sqm.SQM2(charge=1, device="cpu"), x0, z,
                       config=opt.OptimizeConfig(**kw),
                       record_trajectory=True, device="cpu")
    assert got.n_iterations == want.n_iterations
    np.testing.assert_allclose(got.energy_history,
                               np.asarray(want.energy_history), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got.coords_history,
                               np.asarray(want.coords_history), rtol=0,
                               atol=1e-8)
