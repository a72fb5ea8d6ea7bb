"""Port parity: the batched RS-RFO step and Hessian updates of
multioptpy_tpu_torch against the JAX package's vmapped functions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.hessian.updates import update_hessian as ref_update
from multioptpy_tpu.steppers.rfo import rs_rfo_step as ref_step
from multioptpy_tpu.steppers.rfo import update_trust_radius as ref_trust
from multioptpy_tpu_torch.hessian.updates import UPDATE_RULES, update_hessian
from multioptpy_tpu_torch.steppers.rfo import rs_rfo_step, update_trust_radius

torch.set_num_threads(1)


def _hessians(rng, b, d, kind):
    m = rng.standard_normal((b, d, d))
    if kind == "spd":
        return m @ np.swapaxes(m, -1, -2) / d + 0.3 * np.eye(d)
    return 0.5 * (m + np.swapaxes(m, -1, -2))


@pytest.mark.parametrize("eigh_impl", ["xla", "pallas"])
@pytest.mark.parametrize("saddle_order", [0, 1])
@pytest.mark.parametrize("kind", ["spd", "indefinite"])
def test_rs_rfo_step_matches_vmapped_reference(kind, saddle_order,
                                               eigh_impl):
    rng = np.random.default_rng(10 + saddle_order)
    b, d = 5, 9
    h = _hessians(rng, b, d, kind)
    g = rng.standard_normal((b, d)) * 0.1
    trust = np.array([0.05, 0.1, 0.3, 1.0, 3.0])

    ref = jax.vmap(lambda g_, h_, t_: ref_step(
        g_, h_, t_, saddle_order=saddle_order, eigh_impl=eigh_impl))(
        jnp.asarray(g), jnp.asarray(h), jnp.asarray(trust))
    step, aux = rs_rfo_step(torch.as_tensor(g), torch.as_tensor(h),
                            torch.as_tensor(trust), saddle_order=saddle_order,
                            eigh_impl=eigh_impl)
    np.testing.assert_allclose(step.numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-10)
    for key in ("predicted_energy_change", "step_norm"):
        np.testing.assert_allclose(aux[key].numpy(), np.asarray(ref[1][key]),
                                   rtol=1e-10, atol=1e-12, err_msg=key)
    # lambda belongs to the chosen grid alpha; on the trust boundary several
    # alphas give the same rescaled step, so compare it inside only
    inside = (aux["step_norm"] < torch.as_tensor(trust) * (1 - 1e-9)).numpy()
    np.testing.assert_allclose(aux["lambda"].numpy()[inside],
                               np.asarray(ref[1]["lambda"])[inside],
                               rtol=1e-10, atol=1e-12)
    assert (aux["step_norm"] <= torch.as_tensor(trust) * (1 + 1e-12)).all()


def test_nan_hessian_falls_back_to_steepest_descent():
    rng = np.random.default_rng(3)
    h = _hessians(rng, 2, 6, "spd")
    h[1, 0, 0] = np.nan
    g = rng.standard_normal((2, 6))
    step, _ = rs_rfo_step(torch.as_tensor(g), torch.as_tensor(h),
                          torch.full((2,), 0.2, dtype=torch.float64))
    assert torch.isfinite(step).all()
    ref = jax.vmap(lambda g_, h_: ref_step(g_, h_, 0.2)[0])(jnp.asarray(g),
                                                           jnp.asarray(h))
    np.testing.assert_allclose(step.numpy(), np.asarray(ref), atol=1e-10)


@pytest.mark.parametrize("method", sorted(UPDATE_RULES))
def test_update_hessian_matches_reference(method):
    rng = np.random.default_rng(sorted(UPDATE_RULES).index(method))
    b, d = 4, 7
    h = _hessians(rng, b, d, "indefinite")
    s = rng.standard_normal((b, d)) * 0.1
    y = (h @ s[..., None])[..., 0] + 0.02 * rng.standard_normal((b, d))
    s[3] = 0.0        # a degenerate pair: the guards must zero the update
    ref = jax.vmap(lambda h_, s_, y_: ref_update(h_, s_, y_, method))(
        jnp.asarray(h), jnp.asarray(s), jnp.asarray(y))
    got = update_hessian(torch.as_tensor(h), torch.as_tensor(s),
                         torch.as_tensor(y), method)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-11,
                               atol=1e-12)


def test_update_trust_radius_matches_reference():
    actual = np.array([-1e-3, -1e-3, 1e-3, -5e-3, -1e-12, -1e-3])
    predicted = np.array([-1e-3, -4e-3, -1e-3, -1e-3, -1e-12, -2e-3])
    trust = np.array([0.3, 0.3, 0.3, 0.3, 0.3, 0.9])
    ref = jax.vmap(lambda t, a, p: ref_trust(t, a, p, tr_min=0.02,
                                             tr_max=0.94))(
        jnp.asarray(trust), jnp.asarray(actual), jnp.asarray(predicted))
    got = update_trust_radius(torch.as_tensor(trust), torch.as_tensor(actual),
                              torch.as_tensor(predicted), tr_min=0.02,
                              tr_max=0.94)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-15)


def test_kernel_route_is_the_plain_version_on_cpu():
    """eigh_impl="kernel" runs the kernel's algorithm at the card's sweep
    count (sweeps + 1) on every device; on the CPU that is the plain
    version, and nothing is launched."""
    from multioptpy_tpu_torch.ops.jacobi_cuda import (jacobi_eigh_cuda,
                                                      jacobi_eigh_plain)
    from multioptpy_tpu_torch.steppers.rfo import _eigh

    rng = np.random.default_rng(8)
    for d, sweeps in ((10, 6), (54, 8), (72, 9)):
        h = torch.as_tensor(_hessians(rng, 2, d, "indefinite"))
        before = jacobi_eigh_cuda.launches
        w, v = _eigh(h, "kernel")
        w_p, v_p = jacobi_eigh_plain(h, sweeps)
        assert jacobi_eigh_cuda.launches == before
        assert torch.equal(w, w_p) and torch.equal(v, v_p)


def test_reference_cpu_sweeps_leave_the_rfo_hessian_unconverged():
    """Pins why the "kernel" route exists. On the Diels-Alder TR/rot-
    projected RFO Hessian (D = 54, projected-out block shifted to 1e3) the
    reference's CPU sweep count (7) leaves off-diagonals above 1e-5; the
    card's (8) brings them below 1e-6, so a CPU run that must reproduce a
    card run takes the kernel's algorithm at the card's sweep count."""
    from multioptpy_tpu_torch.calculators.sqm import SQM2
    from multioptpy_tpu_torch.geometry import tr_rot_projector
    from multioptpy_tpu_torch.io.fixtures import diels_alder_reactant
    from multioptpy_tpu_torch.ops.jacobi import jacobi_eigh
    from multioptpy_tpu_torch.steppers.rfo import _eigh

    c, z = diels_alder_reactant()
    x = torch.as_tensor(c)[None]
    h = SQM2(device="cpu").hessian(x, z)
    p = tr_rot_projector(x)
    h_eff = p.mT @ h @ p
    h_eff = 0.5 * (h_eff + h_eff.mT) + 1e3 * (torch.eye(54,
                                                        dtype=h.dtype) - p)

    def off_diagonal(v):
        a1 = v.mT @ h_eff @ v
        return (a1 - torch.diag_embed(torch.diagonal(
            a1, dim1=-2, dim2=-1))).abs().max().item()

    assert off_diagonal(jacobi_eigh(h_eff, 7)[1]) > 1e-5
    w, v = _eigh(h_eff, "kernel")
    assert off_diagonal(v) < 1e-6
    np.testing.assert_allclose(w.numpy(), torch.linalg.eigvalsh(h_eff).numpy(),
                               rtol=0, atol=1e-9)


def test_geometry_and_fixtures_match_reference():
    from multioptpy_tpu import geometry as ref_geo
    from multioptpy_tpu.io import fixtures as ref_fix
    from multioptpy_tpu_torch import geometry as geo
    from multioptpy_tpu_torch.io import fixtures as fix

    for name, args in (("diels_alder_reactant", ()), ("s8_crown", ()),
                       ("water_cluster", (4,))):
        c, z = getattr(fix, name)(*args)
        c_ref, z_ref = getattr(ref_fix, name)(*args)
        np.testing.assert_array_equal(c, c_ref)
        np.testing.assert_array_equal(z, z_ref)
    c, z = fix.diels_alder_reactant()
    rng = np.random.default_rng(9)
    coords = c[None] + 0.1 * rng.standard_normal((2, *c.shape))
    g = rng.standard_normal(coords.shape)
    h = _hessians(rng, 2, c.size, "indefinite")
    masses = geo.masses_from_z(z)
    np.testing.assert_array_equal(masses.numpy(),
                                  np.asarray(ref_geo.masses_from_z(z)))
    got_g = geo.project_gradient_tr_rot(torch.as_tensor(g),
                                        torch.as_tensor(coords))
    got_h = geo.project_hessian_tr_rot(torch.as_tensor(h),
                                       torch.as_tensor(coords), masses)
    ref_g = jax.vmap(ref_geo.project_gradient_tr_rot)(jnp.asarray(g),
                                                      jnp.asarray(coords))
    ref_h = jax.vmap(lambda h_, c_: ref_geo.project_hessian_tr_rot(
        h_, c_, jnp.asarray(masses.numpy())))(jnp.asarray(h),
                                              jnp.asarray(coords))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(ref_g), atol=1e-12)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), atol=1e-11)
