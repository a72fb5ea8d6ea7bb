"""Port parity: the whole method surface of the optimize driver.

Every key of the reference's RS-I-RFO/RS-P-RFO registry
(tests/test_method_registry.py::_reference_keys, 175 keys) and every
first-order, optax and learned name parses in the port to the JAX
`_parse_method`'s (kind, sub). One method of each structural family, each
first-order engine, each DIIS variant, `switch_method`, `dic_`, `crsirfo`
with a bond constraint, and the shape conditions run 4 steps of `optimize`
on a 4-atom Ar cluster (UFF Lennard-Jones) in both packages: energy
histories (~1.5e-3 Ha) agree to 1e-12 Ha, geometries to 1e-9 Bohr. P-RFO
runs get 1e-8 Bohr: their maximized mode is the softest (3e-5 Ha/Bohr^2
here) of a Hessian whose TR/rot block is shifted to 1e3, so LAPACK's
eigenvalue rounding (~1e3 * 2e-16) moves it by ~1e-8 relative in either
package, and the step along it with it. Block windows, GEDIIS, L-BFGS
and crsirfo run on H2O+ (SQM2) too."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.calculators.lj import LennardJones as RefLJ
from multioptpy_tpu.constraints import Constraints as RefConstraints
from multioptpy_tpu.steppers.ml import OPTAX_STEPPERS as REF_OPTAX
from multioptpy_tpu_torch.calculators.lj import LennardJones
from multioptpy_tpu_torch.constraints import Constraints
from test_method_registry import _reference_keys

ref_opt = importlib.import_module("multioptpy_tpu.drivers.optimize")
opt = importlib.import_module("multioptpy_tpu_torch.drivers.optimize")

torch.set_num_threads(1)

_TET = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                float) * 6.6 / np.sqrt(8)
_X0 = _TET + 0.6 * np.random.default_rng(0).standard_normal((4, 3))
_Z = np.array([18, 18, 18, 18])

_FIRST_ORDER = ["fire", "fire2", "abc_fire", "lbfgs", "tr_lbfgs", "sd",
                "mwsd", "cg", "cg_pr", "cg_fr", "cg_hs", "cg_dy", "cg_hz",
                "eve", "gan", "rl", "gpmin"]


@pytest.mark.parametrize("key", _reference_keys() + _FIRST_ORDER
                         + list(REF_OPTAX) + [
                             "rsirfo_fsb_trim", "mwrsirfo_fsb",
                             "dic_rsirfo_fsb", "mwmf_rsirfo_fsb",
                             "rfo", "prfo", "RSIRFO_FSB"])
def test_every_method_parses_as_the_reference(key):
    assert opt._parse_method(key) == ref_opt._parse_method(key)


def test_unknown_method_raises_in_both():
    for parse in (opt._parse_method, ref_opt._parse_method):
        with pytest.raises(ValueError, match="unknown optimization method"):
            parse("newton_raphson")


def _run_both(kw, constraints=None, **opt_kw):
    ref_cons = cons = None
    if constraints is not None:
        ref_cons, cons = RefConstraints(**constraints), Constraints(
            **constraints)
    ref = ref_opt.optimize(RefLJ(), jnp.asarray(_X0), jnp.asarray(_Z),
                           config=ref_opt.OptimizeConfig(**kw),
                           constraints=ref_cons, record_trajectory=True,
                           **opt_kw)
    got = opt.optimize(LennardJones(device="cpu"), _X0, _Z,
                       config=opt.OptimizeConfig(**kw), constraints=cons,
                       record_trajectory=True, device="cpu", **opt_kw)
    return ref, got


def _assert_same(ref, got, coords_atol=1e-9):
    assert got.n_iterations == ref.n_iterations
    np.testing.assert_allclose(got.energy_history,
                               np.asarray(ref.energy_history), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got.coords_history,
                               np.asarray(ref.coords_history), rtol=0,
                               atol=coords_atol)
    assert bool(got.converged) == bool(ref.converged)


_FAMILIES = [
    # rank-2 updates, block windows, the mode-following families
    ("rsirfo_bfgs", {}), ("rsirfo_block_fsb_weighted", {}),
    ("rsirfo_block_cfd_bofill", {}), ("rsirfo_pcfd_bofill", {}),
    ("rsirfo_block_bfgs_dd", {}), ("rsirfo_fsb_trim", {}),
    ("mwrsirfo_fsb", {}), ("dic_rsirfo_fsb", {}),
    ("rsprfo_fsb", {"fc_count": 3}), ("rsprfo_bofill_trim", {"fc_count": 3}),
    ("mf_rsirfo_bofill", {"fc_count": 3}),
    ("smf_rsirfo_fsb", {"fc_count": 3}),
    ("mwsmf_rsirfo_block_fsb", {"fc_count": 3}),
    ("mwmf_rsirfo_fsb", {"fc_count": 3}),
    ("rsprfo_block_sr1", {"fc_count": 3}),
    # DIIS on the quasi-Newton step, and the switch to FIRE / SD
    *[("rfo_fsb", {"diis_variant": v}) for v in
      ("gdiis", "gediis", "kdiis", "ediis", "adiis", "c2diis")],
    ("rfo_fsb", {"use_gdiis": True}),
    ("rfo_fsb", {"switch_method": "fire"}),
    ("rfo_bofill", {"switch_method": "abc_fire"}),
    ("rfo_fsb", {"switch_method": "sd"}),
    # first-order engines (gan: test_torch_learned.py, from the
    # reference's initial parameters; rl: its random stream differs)
    *[(m, {}) for m in _FIRST_ORDER if m not in ("gan", "rl")],
    ("tr_lbfgs", {"delta": 0.5}),
    *[(m, {}) for m in ("adam", "adabelief", "radam")],
]


@pytest.mark.parametrize("method,extra", _FAMILIES,
                         ids=[f"{m}-{'-'.join(map(str, e.values()))}"
                              for m, e in _FAMILIES])
def test_optimize_matches_reference(method, extra):
    kw = dict(method=method, nsteps=4, init_hessian="identity", **extra)
    ref, got = _run_both(kw)
    _assert_same(ref, got, 1e-8 if "prfo" in method or "mf_" in method
                 else 1e-9)


def test_crsirfo_with_a_bond_constraint_matches_reference():
    """crsirfo: the null space of the constraint Jacobian by SVD (the two
    packages' bases may differ by a rotation; the lifted step does not),
    then SHAKE back onto the bond."""
    cons = dict(bonds=[(1, 2, None)])
    ref, got = _run_both(dict(method="crsirfo_fsb", nsteps=4,
                              init_hessian="identity"), constraints=cons)
    _assert_same(ref, got)
    d = np.linalg.norm(got.coords_history[:, 0] - got.coords_history[:, 1],
                       axis=-1)
    np.testing.assert_allclose(d, d[0], rtol=0, atol=1e-10)


@pytest.mark.parametrize("constraints", [
    dict(fixed_atoms=[1]),
    dict(angles=[(1, 2, 3, None)], fixed_coords=[(4, "z")]),
    dict(dihedrals=[(1, 2, 3, 4, None)]),
    dict(fbonds=[([1, 2], [3, 4], None)], atoms_pairs=[(1, 3)]),
], ids=["fix", "angle-z", "dihedral", "fbond-pair"])
def test_constrained_rfo_matches_reference(constraints):
    ref, got = _run_both(dict(method="rfo_fsb", nsteps=4,
                              init_hessian="identity"),
                         constraints=constraints)
    _assert_same(ref, got)


def test_shape_conditions_stop_where_the_reference_stops():
    """-sc: the run aborts at the first step whose geometry violates a
    condition (here the 1-2 distance, 3.646 A at the start, must stay
    below 3.85 A; it passes it at the fourth step)."""
    sc = ["3.85", "lt", "1,2", "100", "lt", "1,2,3", "-179", "gt",
          "1,2,3,4"]
    ref, got = _run_both(dict(method="rfo_fsb", nsteps=12,
                              init_hessian="identity"), shape_conditions=sc)
    assert ref.n_iterations == 4
    _assert_same(ref, got)


def test_rl_runs_downhill():
    """The RL stepper's normal draw comes from the port's own generator
    (jax.random's stream cannot be reproduced; test_torch_learned.py holds
    the step to the reference with the reference's draw)."""
    got = opt.optimize(LennardJones(device="cpu"), _X0, _Z,
                       config=opt.OptimizeConfig(method="rl", nsteps=6),
                       device="cpu")
    assert np.isfinite(got.energy_history).all()
    assert got.energy_history[-1] < got.energy_history[0]


@pytest.mark.parametrize("method", ["rfo_fsb", "rsprfo_bofill", "fire",
                                    "lbfgs", "gpmin"])
def test_optimize_batch_matches_reference(method):
    batch = _X0[None] + 0.1 * np.random.default_rng(4).standard_normal(
        (3, 4, 3))
    kw = dict(method=method, init_hessian="identity", fc_count=2)
    ref = ref_opt.optimize_batch(RefLJ(), jnp.asarray(batch),
                                 jnp.asarray(_Z),
                                 config=ref_opt.OptimizeConfig(**kw),
                                 n_steps=3)
    got = opt.optimize_batch(LennardJones(device="cpu"), batch, _Z,
                             config=opt.OptimizeConfig(**kw), n_steps=3,
                             device="cpu")
    np.testing.assert_allclose(got.energy_history,
                               np.asarray(ref.energy_history), rtol=1e-10,
                               atol=0)
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(ref.coords),
                               rtol=0, atol=1e-8)


_H2O = np.array([[0.0, 0.0, 0.1173], [0.0, 0.95, -0.4692],
                 [0.0, -0.7572, -0.40]]) * 1.8897261254578281


@pytest.mark.parametrize("method,extra", [
    ("rsirfo_block_fsb", {}), ("rfo_fsb", {"diis_variant": "gediis"}),
    ("lbfgs", {}), ("crsirfo_fsb", {})], ids=["block", "gediis", "lbfgs",
                                            "crsirfo"])
def test_families_on_a_sqm2_cation_match_reference(method, extra):
    """The same families on H2O+ (SQM2, exact initial Hessian; F1 keeps
    parity tests on open shells): 4 steps, energies to 1e-9 Ha (as
    tests/test_torch_optimize.py), geometries to 1e-8 Bohr; crsirfo holds
    the O-H1 bond."""
    from multioptpy_tpu.calculators.sqm import SQM2 as RefSQM2
    from multioptpy_tpu_torch.calculators.sqm import SQM2

    kw = dict(method=method, nsteps=4, **extra)
    spec = dict(bonds=[(1, 2, None)]) if method.startswith("crs") else None
    ref = ref_opt.optimize(RefSQM2(charge=1), jnp.asarray(_H2O),
                           jnp.asarray([8, 1, 1]),
                           config=ref_opt.OptimizeConfig(**kw),
                           constraints=spec and RefConstraints(**spec),
                           record_trajectory=True)
    got = opt.optimize(SQM2(charge=1, device="cpu"), _H2O,
                       np.array([8, 1, 1]), config=opt.OptimizeConfig(**kw),
                       constraints=spec and Constraints(**spec),
                       record_trajectory=True, device="cpu")
    assert got.n_iterations == ref.n_iterations
    np.testing.assert_allclose(got.energy_history,
                               np.asarray(ref.energy_history), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got.coords_history,
                               np.asarray(ref.coords_history), rtol=0,
                               atol=1e-8)
