"""Port parity: the other calculators of multioptpy_tpu_torch against the
JAX package: EMT (a Cu cluster and the toy H/C/N/O set), Tersoff (Si and a
C/Si mix), ONIOM and MicroiterONIOM (SQM2 on CH3 capped with a link H,
LJ on ethane), the six two-state model functions (LJ and EMT as the two
surfaces; mesx2's composed force and Hessian), BITSS (energy, gradient,
kappas and a short bitss_search on Muller-Brown), optimize_model_function,
EDEEL (SQM fragments: two O2, F1-free: every fragment's Fermi level
lies in a partly filled level) and FragmentGradWrapper. The reference's
SQM pieces are compiled per atom list (`_Jitted`) to keep its side cheap.
BITSS is held to the reference over one stage of `bitss_search`: from the
second stage on the reference starts each stage from an energy and
gradient compiled with the first stage's constraint strengths (ROADMAP
Queue 3, F9), which the port does not copy.

Energies and gradients to 1e-10 relative, Hessians to 1e-9 of their
largest entry (a composite's central-difference Hessian, ROADMAP D3, to
1e-6: the truncation error of its 1e-4 Bohr step); the port evaluates a
batch of two structures at once, each held to the reference's own
evaluation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.calculators import base as ref_base
from multioptpy_tpu.calculators import edeel as ref_edeel
from multioptpy_tpu.calculators import emt as ref_emt
from multioptpy_tpu.calculators import oniom as ref_oniom
from multioptpy_tpu.calculators import tersoff as ref_tersoff
from multioptpy_tpu.calculators import two_state as ref_ts
from multioptpy_tpu.calculators.lj import LennardJones as RefLJ
from multioptpy_tpu.calculators.model_surfaces import MullerBrown as RefMB
from multioptpy_tpu.calculators.sqm import SQM as RefSQM
from multioptpy_tpu.calculators.sqm import SQM2 as RefSQM2
from multioptpy_tpu.drivers.optimize import OptimizeConfig as RefConfig
from multioptpy_tpu_torch.calculators import base, edeel, emt, oniom, tersoff
from multioptpy_tpu_torch.calculators import two_state as ts
from multioptpy_tpu_torch.calculators.lj import LennardJones
from multioptpy_tpu_torch.calculators.model_surfaces import (MB_MIN_A,
                                                             MB_MIN_C,
                                                             MullerBrown)
from multioptpy_tpu_torch.calculators.sqm import SQM, SQM2
from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig

torch.set_num_threads(1)


def _pair_of(coords, seed):
    """Two structures: coords and a seeded perturbation of it."""
    rng = np.random.default_rng(seed)
    return np.stack([coords, coords + 0.05 * rng.standard_normal(
        coords.shape)])


class _Jitted:
    """A reference calculator whose energy is compiled once per atom list
    (the composite calculators call it on fragments and model systems;
    compiling keeps the reference side's cost to seconds)."""

    def __init__(self, inner):
        self.inner = inner
        self.on_device = True
        self.charge = inner.charge
        self.multiplicity = inner.multiplicity
        self._fns = {}

    def energy(self, coords, z):
        z_np = np.asarray(z)
        key = tuple(z_np.tolist())
        if key not in self._fns:
            self._fns[key] = jax.jit(lambda x: self.inner.energy(x, z_np))
        return self._fns[key](coords)


def _check_eg(ref_calc, calc, batch, z, hessian=None, compiled=True):
    """`hessian`: the Hessian's tolerance relative to its largest entry
    (None: not compared); `compiled`: compile the reference's energy and
    gradient (False for the composites, which index the atom list; their
    pieces are `_Jitted`)."""
    e, g = calc.energy_and_gradient(torch.as_tensor(batch), z)
    ref_eg = lambda x: ref_calc.energy_and_gradient(x, z)  # noqa: E731
    if compiled:
        ref_eg = jax.jit(ref_eg)
    for k, x in enumerate(batch):
        e_ref, g_ref = ref_eg(jnp.asarray(x))
        assert float(e[k]) == pytest.approx(float(e_ref), rel=1e-10,
                                            abs=1e-13)
        np.testing.assert_allclose(g[k].numpy(), np.asarray(g_ref),
                                   rtol=1e-10,
                                   atol=1e-10 * np.abs(g_ref).max())
    if hessian is not None:
        h = calc.hessian(torch.as_tensor(batch[:1]), z)[0].numpy()
        h_ref = np.asarray(jax.jit(lambda x: ref_calc.hessian(x, z))(
            jnp.asarray(batch[0])))
        np.testing.assert_allclose(h, h_ref, rtol=0,
                                   atol=hessian * np.abs(h_ref).max())


def _cu_cluster(n=13, a=4.8):
    """A cuboctahedral Cu13 (center + 12 vertices), Bohr."""
    v = [(0.0, 0.0, 0.0)]
    for s1 in (1, -1):
        for s2 in (1, -1):
            v += [(s1, s2, 0.0), (s1, 0.0, s2), (0.0, s1, s2)]
    return np.asarray(v[:n]) * a / np.sqrt(2.0), np.full(n, 29)


def test_emt_matches_reference():
    c, z = _cu_cluster()
    _check_eg(ref_emt.EMT(), emt.EMT(device="cpu"), _pair_of(c, 1), z)
    small = np.array([[0.0, 0.0, 0.0], [2.2, 0.1, 0.0], [-0.8, 2.0, 0.3],
                      [0.5, -0.4, 2.4]])
    _check_eg(ref_emt.EMT(), emt.EMT(device="cpu"), _pair_of(small, 2),
              np.array([6, 8, 1, 7]), hessian=1e-9)


def test_tersoff_matches_reference():
    rng = np.random.default_rng(3)
    si = np.array([[0.0, 0.0, 0.0], [4.4, 0.0, 0.0], [2.2, 3.8, 0.0],
                   [2.2, 1.3, 3.6], [2.2, 1.3, -3.6]]) \
        + 0.1 * rng.standard_normal((5, 3))
    _check_eg(ref_tersoff.Tersoff(), tersoff.Tersoff(device="cpu"),
              _pair_of(si, 4), np.full(5, 14))
    _check_eg(ref_tersoff.Tersoff(), tersoff.Tersoff(device="cpu"),
              _pair_of(si[:4] * 0.75, 5), np.array([6, 14, 6, 14]),
              hessian=1e-9)


# ethane, Bohr: C1 (1) with H 3-5, C2 (2) with H 6-8
_ETHANE = np.array([
    [0.0, 0.0, 1.45], [0.0, 0.0, -1.45],
    [1.94, 0.0, 2.18], [-0.97, 1.68, 2.18], [-0.97, -1.68, 2.18],
    [-1.94, 0.0, -2.18], [0.97, -1.68, -2.18], [0.97, 1.68, -2.18]])
_Z_ETHANE = np.array([6, 6, 1, 1, 1, 1, 1, 1])


_REF_HIGH = {}


@pytest.mark.parametrize("micro", [0, 3])
def test_oniom_matches_reference(micro):
    kw = dict(high_atoms=[1, 3, 4, 5], link_bonds=[(1, 2)])
    # one compiled reference SQM2 for both cases
    high = _REF_HIGH.setdefault("sqm2", _Jitted(RefSQM2(charge=1,
                                                        multiplicity=2)))
    if micro:
        ref_calc = ref_oniom.MicroiterONIOM(high, RefLJ(), microiter=micro,
                                            **kw)
        calc = oniom.MicroiterONIOM(
            SQM2(charge=1, multiplicity=2, device="cpu"),
            LennardJones(device="cpu"), microiter=micro, **kw)
    else:
        ref_calc = ref_oniom.ONIOM(high, RefLJ(), **kw)
        calc = oniom.ONIOM(SQM2(charge=1, multiplicity=2, device="cpu"),
                           LennardJones(device="cpu"), **kw)
    assert calc.device == torch.device("cpu")
    _check_eg(ref_calc, calc, _pair_of(_ETHANE, 6), _Z_ETHANE,
              compiled=False)
    xm, zm = calc._model_system(torch.as_tensor(_ETHANE)[None], _Z_ETHANE)
    assert xm.shape == (1, 5, 3) and list(zm) == [6, 1, 1, 1, 1]


_H2O = np.array([[0.0, 0.0, 0.0], [0.0, 1.5, 1.1], [0.0, -1.4, 1.2]])
_Z_H2O = np.array([8, 1, 1])


@pytest.mark.parametrize("kind", ["seam", "avoiding", "conical", "meci",
                                  "mesx", "mesx2"])
def test_two_state_model_functions_match_reference(kind):
    ref_calc = ref_ts.TwoStateModelFunction(RefLJ(), ref_emt.EMT(),
                                            kind=kind)
    calc = ts.TwoStateModelFunction(LennardJones(device="cpu"),
                                    emt.EMT(device="cpu"), kind=kind)
    # seam: the composite's central-difference Hessian (D3) against the
    # reference's exact one; mesx2: its explicit projected Hessian
    _check_eg(ref_calc, calc, _pair_of(_H2O, 7), _Z_H2O,
              hessian={"seam": 1e-6, "mesx2": 1e-9}.get(kind))
    gap = calc.gap(torch.as_tensor(_H2O)[None], _Z_H2O)
    assert float(gap[0]) == pytest.approx(
        float(ref_calc.gap(jnp.asarray(_H2O), _Z_H2O)), rel=1e-10)


def test_bitss_matches_reference():
    a = np.array([[MB_MIN_A[0], MB_MIN_A[1], 0.0]])
    b = np.array([[MB_MIN_C[0], MB_MIN_C[1], 0.0]])
    ref_calc = ref_ts.BITSSCalculator(RefMB(), 1, kappa_e=5.0, kappa_d=2.0)
    calc = ts.BITSSCalculator(MullerBrown(device="cpu"), 1, kappa_e=5.0,
                              kappa_d=2.0)
    pair = np.concatenate([a, b])
    for c_ in (ref_calc, calc):
        c_.d_target = 1.3
    _check_eg(ref_calc, calc, _pair_of(pair, 8), np.array([1, 1]))
    k_ref = ref_calc.update_kappas(jnp.asarray(pair), np.array([1]))
    k = calc.update_kappas(torch.as_tensor(pair), np.array([1]))
    np.testing.assert_allclose(k, k_ref, rtol=1e-10)
    assert calc.contract(torch.as_tensor(pair)) == pytest.approx(
        ref_calc.contract(jnp.asarray(pair)), rel=1e-12)

    kw = dict(n_stages=1, kappa_e=50.0, kappa_d=2.0, shrink=0.4)
    mid_ref, e_ref = ref_ts.bitss_search(
        RefMB(), jnp.asarray(a), jnp.asarray(b), np.array([1]),
        opt_config=RefConfig(method="fire", nsteps=15,
                             project_tr_rot=False), **kw)
    mid, e = ts.bitss_search(
        MullerBrown(device="cpu"), a, b, np.array([1]),
        opt_config=OptimizeConfig(method="fire", nsteps=15,
                                  project_tr_rot=False), **kw)
    np.testing.assert_allclose(mid.numpy(), np.asarray(mid_ref), rtol=0,
                               atol=1e-8)
    assert e == pytest.approx(e_ref, rel=1e-10)


def test_f9_reference_bitss_stages_start_from_stale_strengths():
    """F9: the reference's driver glue compiles a calculator's energy and
    gradient once per instance (ops/hosteval.py), so a BITSS stage after
    the first starts from the first stage's kappa_e, kappa_d and target
    distance; the port evaluates the current ones."""
    from multioptpy_tpu.ops import hosteval as ref_hosteval
    from multioptpy_tpu_torch.ops import hosteval

    a = np.array([[MB_MIN_A[0], MB_MIN_A[1], 0.0]])
    b = np.array([[MB_MIN_C[0], MB_MIN_C[1], 0.0]])
    pair, zz = np.concatenate([a, b]), np.array([1, 1])
    ref_calc = ref_ts.BITSSCalculator(RefMB(), 1, d0=1.0)
    calc = ts.BITSSCalculator(MullerBrown(device="cpu"), 1, d0=1.0)
    e0 = float(ref_hosteval.energy_and_gradient(ref_calc, jnp.asarray(pair),
                                                jnp.asarray(zz))[0])
    for c_ in (ref_calc, calc):
        c_.kappa_e, c_.d_target = 40.0, 0.5      # the next stage's
    fresh = float(ref_calc.energy(jnp.asarray(pair), zz))
    stale = float(ref_hosteval.energy_and_gradient(
        ref_calc, jnp.asarray(pair), jnp.asarray(zz))[0])
    got = float(hosteval.energy_and_gradient(
        calc, torch.as_tensor(pair)[None], zz)[0][0])
    assert stale == e0 and abs(fresh - e0) > 1e-3
    assert got == pytest.approx(fresh, rel=1e-10)


def test_optimize_model_function_matches_reference():
    # an identity start: the composite's Hessian is seminumerical (D3)
    cfg = dict(method="rfo_fsb", nsteps=4, project_tr_rot=False,
               init_hessian="identity")
    res_ref, _ = ref_ts.optimize_model_function(
        RefLJ(), ref_emt.EMT(), jnp.asarray(_H2O), _Z_H2O, kind="mesx",
        opt_config=RefConfig(**cfg))
    res, mf = ts.optimize_model_function(
        LennardJones(device="cpu"), emt.EMT(device="cpu"), _H2O, _Z_H2O,
        kind="mesx", opt_config=OptimizeConfig(**cfg))
    assert isinstance(mf, ts.TwoStateModelFunction)
    np.testing.assert_allclose(res.energy_history,
                               np.asarray(res_ref.energy_history),
                               rtol=1e-10)
    np.testing.assert_allclose(res.coords.numpy(), np.asarray(res_ref.coords),
                               rtol=0, atol=1e-8)


# two O2 (atoms 1-2, donor; 3-4, acceptor): O2, O2+ and O2- all have a
# partly filled pi* level
_O4 = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 2.3], [0.3, 0.2, 5.6],
                [0.1, 2.2, 6.1]])
_CHARGES = dict(d_init=0, a_init=0, d_final=1, a_final=-1)


def test_edeel_matches_reference():
    """The seam target's energy and gradient, and the two diabatic
    surfaces (the 'reactant' and 'product' targets)."""
    kw = dict(donor_atoms=[1, 2], acceptor_atoms=[3, 4], charges=_CHARGES)
    pieces = {}     # one compiled reference SQM per charge
    ref_calc = ref_edeel.EDEELCalculator(
        lambda **k: pieces.setdefault(k["charge"], _Jitted(RefSQM(**k))),
        **kw)
    calc = edeel.EDEELCalculator(lambda **k: SQM(device="cpu", **k), **kw)
    _check_eg(ref_calc, calc, _pair_of(_O4, 9), np.full(4, 8),
              compiled=False)
    x = torch.as_tensor(_O4)[None]
    v = calc.diabatic_energies(x, np.full(4, 8))
    v_ref = ref_calc.diabatic_energies(jnp.asarray(_O4), np.full(4, 8))
    np.testing.assert_allclose([float(v[0][0]), float(v[1][0])],
                               [float(v_ref[0]), float(v_ref[1])],
                               rtol=1e-10)
    for target, want in (("reactant", v[0]), ("product", v[1])):
        calc.target = target
        assert torch.equal(calc.energy(x, np.full(4, 8)), want)


def test_fragment_grad_wrapper_matches_reference():
    c, z = _cu_cluster(6)
    frags = [[1, 2, 3], [5, 6]]
    ref_calc = ref_base.FragmentGradWrapper(RefLJ(), frags, 6)
    calc = base.FragmentGradWrapper(LennardJones(device="cpu"), frags, 6)
    _check_eg(ref_calc, calc, _pair_of(c, 10), np.full(6, 18))
    g = calc.energy_and_gradient(torch.as_tensor(c)[None], np.full(6, 18))[1]
    assert torch.allclose(g[0, 0], g[0, 2]) and torch.allclose(g[0, 4],
                                                                g[0, 5])
