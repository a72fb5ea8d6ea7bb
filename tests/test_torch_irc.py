"""Port parity: normal modes, the host-level evaluators and the LQA IRC of
multioptpy_tpu_torch against the JAX package, on Muller-Brown from its AB
saddle and on a bridged HCN+ geometry (SQM2)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.analysis import vibrations as ref_vib
from multioptpy_tpu.calculators import sqm as ref_sqm
from multioptpy_tpu.calculators.model_surfaces import MullerBrown as RefMB
from multioptpy_tpu.ops import hosteval as ref_hosteval
from multioptpy_tpu.potentials import BiasEngine as RefEngine
from multioptpy_tpu.potentials import get_potential as ref_get
from multioptpy_tpu_torch.analysis import vibrations as vib
from multioptpy_tpu_torch.calculators import sqm
from multioptpy_tpu_torch.calculators.model_surfaces import (MB_TS_AB,
                                                             MullerBrown)
from multioptpy_tpu_torch.ops import hosteval
from multioptpy_tpu_torch.potentials import BiasEngine, get_potential

ref_irc = importlib.import_module("multioptpy_tpu.drivers.irc")
irc = importlib.import_module("multioptpy_tpu_torch.drivers.irc")

torch.set_num_threads(1)

_ANG = 1.8897261254578281
# H bridging C and N: near the HCN <-> HNC saddle
_BRIDGED = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.18],
                     [1.1, 0.05, 0.45]]) * _ANG
_Z = np.array([6, 7, 1])
_MB_TS = np.array([[MB_TS_AB[0], MB_TS_AB[1], 0.0]])


def _hcn_hessian():
    h = ref_sqm.SQM2(charge=1).hessian(jnp.asarray(_BRIDGED),
                                        jnp.asarray(_Z))
    return np.asarray(h)


def _compare_freqs(got, ref):
    """The imaginary mode and the vibrations to 1e-10 relative; the six
    TR/rot frequencies (square roots of ~1e-12 eigenvalues, whatever their
    sign) below 1 cm^-1 on both sides."""
    ref = np.asarray(ref)
    order = np.argsort(np.abs(ref))
    vibr, trrot = order[6:], order[:6]
    np.testing.assert_allclose(got[vibr], ref[vibr], rtol=1e-10, atol=0)
    assert np.abs(got[trrot]).max() < 1.0 and np.abs(ref[trrot]).max() < 1.0


def test_normal_modes_match_reference_single_and_batched():
    h = _hcn_hessian()
    ref = ref_vib.normal_modes(jnp.asarray(h), jnp.asarray(_BRIDGED),
                               jnp.asarray(_Z))
    got = vib.normal_modes(torch.as_tensor(h), torch.as_tensor(_BRIDGED), _Z)
    _compare_freqs(got.frequencies_cm1.numpy(), ref.frequencies_cm1)
    np.testing.assert_allclose(got.eigenvalues.numpy(),
                               np.asarray(ref.eigenvalues), rtol=1e-10,
                               atol=1e-12)
    assert vib.count_imaginary(got.frequencies_cm1) == \
        ref_vib.count_imaginary(ref.frequencies_cm1) == 1
    both = vib.normal_modes(torch.as_tensor(np.stack([h, h])),
                            torch.as_tensor(np.stack([_BRIDGED] * 2)), _Z)
    assert both.modes.shape == (2, 9, 3, 3)
    torch.testing.assert_close(both.frequencies_cm1[1], got.frequencies_cm1)
    assert vib.count_imaginary(both.frequencies_cm1).tolist() == [1, 1]


def test_hosteval_with_bias_matches_reference():
    pots = [("afir", dict(gamma=100.0, fragm_1=[1], fragm_2=[3],
                          element_z=_Z))]
    ref_bias = RefEngine([ref_get(n, **kw) for n, kw in pots])
    bias = BiasEngine([get_potential(n, **kw) for n, kw in pots])
    ref_calc, calc = ref_sqm.SQM2(charge=1), sqm.SQM2(charge=1, device="cpu")
    x = torch.as_tensor(_BRIDGED)[None]
    e = hosteval.energy(calc, x, _Z, bias)
    h, f = hosteval.hessian_and_modes(calc, x, _Z, bias)
    e_r = ref_hosteval.energy(ref_calc, jnp.asarray(_BRIDGED),
                              jnp.asarray(_Z), ref_bias)
    h_r, f_r = ref_hosteval.hessian_and_modes(
        ref_calc, jnp.asarray(_BRIDGED), jnp.asarray(_Z), ref_bias)
    assert e[0].item() == pytest.approx(float(e_r), rel=1e-10)
    np.testing.assert_allclose(h[0].numpy(), np.asarray(h_r), rtol=0,
                               atol=1e-10 * np.abs(h_r).max())
    _compare_freqs(f[0].numpy(), f_r)


def test_initial_displacements_match_reference():
    h = _hcn_hessian()
    ref_f, ref_b = ref_irc.initial_displacements(
        jnp.asarray(h), jnp.asarray(_BRIDGED), jnp.asarray(_Z), 0.1)
    got_f, got_b = irc.initial_displacements(
        torch.as_tensor(h)[None], torch.as_tensor(_BRIDGED)[None], _Z, 0.1)
    # the eigenvector's sign is a convention of each eigensolver
    sign = np.sign(np.vdot(got_f[0].numpy() - _BRIDGED,
                           np.asarray(ref_f) - _BRIDGED))
    if sign < 0:
        got_f, got_b = got_b, got_f
    np.testing.assert_allclose(got_f[0].numpy(), np.asarray(ref_f), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(got_b[0].numpy(), np.asarray(ref_b), rtol=0,
                               atol=1e-10)


def _compare(ref, got, atol):
    # the eigenvector sign may put either branch first
    same = np.abs(got.forward_path[0] - ref.forward_path[0]).max() < 1e-6
    pairs = ((got.forward_path, got.forward_energies),
             (got.backward_path, got.backward_energies))
    if not same:
        pairs = pairs[::-1]
    for (p, e), rp, re in zip(pairs,
                              (ref.forward_path, ref.backward_path),
                              (ref.forward_energies, ref.backward_energies)):
        assert p.shape == np.asarray(rp).shape
        np.testing.assert_allclose(p, np.asarray(rp), rtol=0, atol=atol)
        np.testing.assert_allclose(e, np.asarray(re), rtol=1e-10, atol=0)
    assert got.ts_energy == pytest.approx(ref.ts_energy, rel=1e-10)


def test_lqa_irc_on_muller_brown_matches_reference():
    cfg = dict(method="lqa", step_size=0.05, n_steps=3)
    ref = ref_irc.irc(RefMB(), jnp.asarray(_MB_TS), jnp.array([1]),
                      config=ref_irc.IRCConfig(**cfg))
    got = irc.irc(MullerBrown(device="cpu"), _MB_TS, np.array([1]),
                  config=irc.IRCConfig(**cfg), device="cpu")
    _compare(ref, got, 1e-12)


def test_lqa_irc_on_muller_brown_segments_and_stops_like_reference():
    """Both branches stop on an energy rise inside the first segment of 8
    steps; the frozen tail up to the segment boundary is part of the
    path."""
    cfg = dict(method="lqa", step_size=0.3, n_steps=20)
    ref = ref_irc.irc(RefMB(), jnp.asarray(_MB_TS), jnp.array([1]),
                      config=ref_irc.IRCConfig(**cfg))
    got = irc.irc(MullerBrown(device="cpu"), _MB_TS, np.array([1]),
                  config=irc.IRCConfig(**cfg), device="cpu")
    _compare(ref, got, 1e-10)


def test_lqa_irc_on_hcn_cation_matches_reference():
    cfg = dict(method="lqa", step_size=0.1, n_steps=3)
    h = _hcn_hessian()
    ref = ref_irc.irc(ref_sqm.SQM2(charge=1), jnp.asarray(_BRIDGED),
                      jnp.asarray(_Z), hessian=jnp.asarray(h),
                      config=ref_irc.IRCConfig(**cfg))
    got = irc.irc(sqm.SQM2(charge=1, device="cpu"), _BRIDGED, _Z,
                  hessian=h, config=irc.IRCConfig(**cfg), device="cpu")
    _compare(ref, got, 1e-8)


def test_other_irc_methods_raise():
    """Every integrator of the reference's `make_irc_step` runs in the port;
    other names raise as in the reference."""
    with pytest.raises(ValueError, match="unknown IRC method"):
        irc.irc(MullerBrown(device="cpu"), _MB_TS, np.array([1]),
                config=irc.IRCConfig(method="gs"), device="cpu")


@pytest.mark.parametrize("method", ["euler", "rk4", "dvv", "hpc"])
def test_irc_integrators_on_muller_brown_match_reference(method):
    """9 steps (past the first segment of 8) of each integrator from the AB
    saddle: paths to 1e-12 Bohr, energies to 1e-10 relative."""
    cfg = dict(method=method, step_size=0.05, n_steps=9)
    ref = ref_irc.irc(RefMB(), jnp.asarray(_MB_TS), jnp.array([1]),
                      config=ref_irc.IRCConfig(**cfg))
    got = irc.irc(MullerBrown(device="cpu"), _MB_TS, np.array([1]),
                  config=irc.IRCConfig(**cfg), device="cpu")
    assert len(got.forward_path) == len(ref.forward_path) == 9
    _compare(ref, got, 1e-12)


@pytest.mark.parametrize("method", ["euler", "rk4", "dvv", "hpc"])
def test_irc_integrators_on_hcn_cation_match_reference(method):
    """3 steps of each integrator on SQM2 from the bridged HCN+ geometry
    with the reference's TS Hessian (the F1 cation): paths to 1e-8 Bohr,
    energies to 1e-10 relative."""
    cfg = dict(method=method, step_size=0.1, n_steps=3)
    h = _hcn_hessian()
    ref = ref_irc.irc(ref_sqm.SQM2(charge=1), jnp.asarray(_BRIDGED),
                      jnp.asarray(_Z), hessian=jnp.asarray(h),
                      config=ref_irc.IRCConfig(**cfg))
    got = irc.irc(sqm.SQM2(charge=1, device="cpu"), _BRIDGED, _Z,
                  hessian=h, config=irc.IRCConfig(**cfg), device="cpu")
    _compare(ref, got, 1e-8)
    for name in ("forward_gradients", "backward_gradients"):
        assert getattr(got, name).shape == (3, 3, 3)
