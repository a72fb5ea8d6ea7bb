"""Port parity: the growing Newton trajectory, 2PSHS, ADDF (search and
explore), meta-IRC and ModeKill of multioptpy_tpu_torch against the JAX
package, on the Muller-Brown surface and, for the molecular branches (TR/rot
deflation by mode count, the Kabsch alignment of the product), on the
Lennard-Jones minimum of a Ne-Ar-Kr triangle. Muller-Brown paths and
energies agree to 1e-10 relative (1e-9 Bohr and 1e-11 Ha where a path runs
through several hundred relaxation steps); on the triangle, whose energies
are a few 1e-4 Ha and whose scaled spheres amplify rounding through the
relaxation steps, to 1e-8 Bohr and 1e-12 Ha. ADDF seeds each channel pair
with +/- one soft mode, whose sign is each eigensolver's own, so each pair
is compared as an unordered pair; the triangle's soft modes are not
degenerate (3.6e-4, 4.0e-4 and 9.5e-4 Ha/Bohr^2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.calculators.lj import LennardJones as RefLJ
from multioptpy_tpu.calculators.model_surfaces import MullerBrown as RefMB
from multioptpy_tpu.drivers import addf as ref_addf
from multioptpy_tpu.drivers import irc as ref_irc
from multioptpy_tpu.drivers import newton_traj as ref_gnt
from multioptpy_tpu.drivers import twopshs as ref_2pshs
from multioptpy_tpu.drivers.optimize import OptimizeConfig as RefOptConfig
from multioptpy_tpu_torch.calculators.lj import LennardJones
from multioptpy_tpu_torch.calculators.model_surfaces import (MB_MIN_A,
                                                             MB_MIN_B,
                                                             MullerBrown)
from multioptpy_tpu_torch.drivers import addf, irc, newton_traj, twopshs
from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig

torch.set_num_threads(1)

_Z1 = np.array([1])
_A = np.array([[MB_MIN_A[0], MB_MIN_A[1], 0.0]])
_B = np.array([[MB_MIN_B[0], MB_MIN_B[1], 0.0]])
_Z3 = np.array([10, 18, 36])
_TRIANGLE = np.array([[-3.26539117, -1.95534936, 0.0],
                      [3.44220521, -2.34528964, 0.0],
                      [-0.17681404, 4.300639, 0.0]])


def _stretched_triangle():
    """The triangle with Kr pulled out, rotated and shifted: a product
    that only an aligned direction reaches."""
    x = _TRIANGLE.copy()
    x[2, 1] += 1.5
    c, s = np.cos(0.7), np.sin(0.7)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return x @ rot.T + np.array([1.0, 2.0, 0.5])


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(),
                                                      1e-300)


def _system(system):
    """(reference calculator, port calculator, z, start, product, path
    tolerance in Bohr, energy tolerance in Ha)."""
    if system == "muller_brown":
        return RefMB(), MullerBrown(device="cpu"), _Z1, _B, _A, 1e-9, 1e-11
    return (RefLJ(), LennardJones(device="cpu"), _Z3, _TRIANGLE,
            _stretched_triangle(), 1e-8, 1e-12)


_SPHERES = {"muller_brown": dict(r_start=0.15, r_step=0.12, n_relax=30,
                                 relax_rate=0.1),
            "lj_triangle": dict(r_start=0.003, r_step=0.003, n_spheres=8,
                                n_relax=20, relax_rate=0.5)}


@pytest.mark.parametrize("mode", ["product", "direction"])
def test_newton_trajectory_matches_reference(mode):
    cfg = dict(step_size=0.06, n_steps=40, n_corrector=20,
               corrector_rate=0.3)
    kw = ({"product_coords": _B} if mode == "product"
          else {"direction": np.array([[0.508, -0.975, 0.0]])})
    ref = ref_gnt.newton_trajectory(
        RefMB(), jnp.asarray(_A), jnp.asarray(_Z1),
        config=ref_gnt.GNTConfig(**cfg),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = newton_traj.newton_trajectory(
        MullerBrown(device="cpu"), _A, _Z1,
        config=newton_traj.GNTConfig(**cfg), device="cpu", **kw)
    assert got.path.shape == ref.path.shape
    assert _rel(got.path, ref.path) < 1e-10
    assert _rel(got.energies, ref.energies) < 1e-10
    assert _rel(got.grad_norms, ref.grad_norms) < 1e-9
    assert got.stationary_points == ref.stationary_points
    assert got.ts_energy == pytest.approx(ref.ts_energy, rel=1e-10)
    assert _rel(got.ts_guess.numpy(), ref.ts_guess) < 1e-10


@pytest.mark.parametrize("system", sorted(_SPHERES))
def test_twopshs_matches_reference(system):
    ref_calc, calc, z, _, _, p_tol, e_tol = _system(system)
    if system == "muller_brown":
        a, b = _A, _B
    else:
        a, b = _TRIANGLE, _stretched_triangle()
    cfg = _SPHERES[system]
    ref = ref_2pshs.twopshs(ref_calc, jnp.asarray(a), jnp.asarray(b),
                            jnp.asarray(z), ref_2pshs.TwoPSHSConfig(**cfg))
    got = twopshs.twopshs(calc, a, b, z, twopshs.TwoPSHSConfig(**cfg),
                          device="cpu")
    assert got.path.shape == ref.path.shape and len(got.path) > 3
    assert got.crossed_ts == ref.crossed_ts
    np.testing.assert_allclose(got.path, ref.path, rtol=0, atol=p_tol)
    np.testing.assert_allclose(got.energies, ref.energies, rtol=0,
                               atol=e_tol)
    np.testing.assert_allclose(got.ts_guess, ref.ts_guess, rtol=0,
                               atol=p_tol)


def _pairwise_match(ref_channels, got_channels, p_tol, e_tol):
    """Channels 2k and 2k+1 are +/- one mode: each pair is compared
    unordered, in the order whose paths agree best."""
    assert len(got_channels) == len(ref_channels)
    for k in range(0, len(ref_channels), 2):
        ref_pair = ref_channels[k:k + 2]
        got_pair = got_channels[k:k + 2]

        def worst(order):
            if any(g.path.shape != np.asarray(r.path).shape
                   for g, r in zip(order, ref_pair)):
                return np.inf
            return max(np.abs(g.path - np.asarray(r.path)).max()
                       for g, r in zip(order, ref_pair))

        order = min((got_pair, got_pair[::-1]), key=worst)
        assert worst(order) <= p_tol
        for g, r in zip(order, ref_pair):
            assert g.crossed_ts == r.crossed_ts
            np.testing.assert_allclose(g.energies, r.energies, rtol=0,
                                       atol=e_tol)
            assert abs(g.ts_energy - r.ts_energy) <= e_tol


@pytest.fixture(scope="module")
def mb_explore():
    """addf_explore from the Muller-Brown minimum B in both packages: the
    channels are addf_search's output, so the search test reads them from
    here rather than running the same spheres again."""
    cfg = dict(n_channels=4, r_start=0.2, r_step=0.12, n_spheres=25,
               n_relax=30, relax_rate=0.15)
    saddle = dict(method="rfo_bofill", saddle_order=1, nsteps=40,
                  fc_count=5, init_hessian="exact")
    ref = ref_addf.addf_explore(
        RefMB(), jnp.asarray(_B), jnp.asarray(_Z1),
        ref_addf.ADDFConfig(**cfg), saddle_config=RefOptConfig(**saddle))
    got = addf.addf_explore(
        MullerBrown(device="cpu"), _B, _Z1, addf.ADDFConfig(**cfg),
        saddle_config=OptimizeConfig(**saddle), device="cpu")
    return ref, got


@pytest.mark.parametrize("system", sorted(_SPHERES))
def test_addf_search_matches_reference_as_pm_pairs(system, request):
    ref_calc, calc, z, x0, _, p_tol, e_tol = _system(system)
    if system == "muller_brown":
        (_, ref), (_, got) = request.getfixturevalue("mb_explore")
    else:
        cfg = dict(_SPHERES[system], n_channels=4, n_spheres=6)
        ref = ref_addf.addf_search(ref_calc, jnp.asarray(x0), jnp.asarray(z),
                                   ref_addf.ADDFConfig(**cfg))
        got = addf.addf_search(calc, x0, z, addf.ADDFConfig(**cfg),
                               device="cpu")
    _pairwise_match(ref, got, p_tol, e_tol)
    if system == "muller_brown":
        assert sum(c.crossed_ts for c in got) >= 2


def test_addf_explore_matches_reference(mb_explore):
    (ref_ts, _), (got_ts, _) = mb_explore
    assert len(got_ts) == len(ref_ts) >= 1
    for g, r in zip(got_ts, ref_ts):
        assert (g.n_imaginary, g.converged) == (r.n_imaginary, r.converged)
        assert g.energy == pytest.approx(r.energy, rel=1e-10)
        np.testing.assert_allclose(g.coords, r.coords, rtol=0, atol=1e-9)


def test_meta_irc_and_modekill_match_reference():
    cfg = dict(method="lqa", step_size=0.05, n_steps=20)
    x = _A + np.array([[0.15, 0.2, 0.0]])
    ref = ref_irc.meta_irc(RefMB(), jnp.asarray(x), jnp.asarray(_Z1),
                           ref_irc.IRCConfig(**cfg))
    got = irc.meta_irc(MullerBrown(device="cpu"), x, _Z1,
                       irc.IRCConfig(**cfg), device="cpu")
    assert got.forward_path.shape == ref.forward_path.shape
    assert _rel(got.forward_path, ref.forward_path) < 1e-10
    assert _rel(got.forward_energies, ref.forward_energies) < 1e-10
    assert got.ts_energy == pytest.approx(ref.ts_energy, rel=1e-12)

    opt = dict(method="rfo_fsb", nsteps=80, fc_count=5, max_force=1e-6,
               rms_force=7e-7, max_displacement=1e-4, rms_displacement=7e-5)
    x0 = np.array([[-0.75, 0.9, 0.0]])
    ref_c, ref_n = ref_irc.modekill(RefMB(), jnp.asarray(x0),
                                    jnp.asarray(_Z1), keep_order=0,
                                    max_rounds=20,
                                    opt_config=RefOptConfig(**opt))
    got_c, got_n = irc.modekill(MullerBrown(device="cpu"), x0, _Z1,
                                keep_order=0, max_rounds=20,
                                opt_config=OptimizeConfig(**opt),
                                device="cpu")
    assert got_n == ref_n == 0
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), rtol=0,
                               atol=1e-9)
    g = torch.tensor([[3.0, 4.0, 12.0]], dtype=torch.float64)
    sm = torch.tensor([1.0, 2.0, 4.0], dtype=torch.float64)
    np.testing.assert_array_equal(
        irc._mw_gradient(g, sm).numpy(),
        np.asarray(ref_irc._mw_gradient(jnp.asarray(g.numpy()),
                                        jnp.asarray(sm.numpy()))))
