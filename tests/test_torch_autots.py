"""Port parity: the AutoTS workflow of multioptpy_tpu_torch against the JAX
package: the whole pipeline on Muller-Brown with a product (the
configuration of tests/test_autots.py with fewer steps), the candidate
tiers, the stage-wise scan_chunk default and the v1 config translation."""

import dataclasses
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.calculators.model_surfaces import MullerBrown as RefMB
from multioptpy_tpu.drivers.optimize import OptimizeConfig as RefOptConfig
from multioptpy_tpu.workflows import autots as ref_autots
from multioptpy_tpu_torch.calculators.model_surfaces import (MB_MIN_A,
                                                             MB_MIN_C,
                                                             MB_TS_AB,
                                                             MullerBrown)
from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig
from multioptpy_tpu_torch.workflows import autots

torch.set_num_threads(1)

_REPO = pathlib.Path(__file__).resolve().parent.parent
_TIGHT = dict(max_force=1e-7, rms_force=7e-8, max_displacement=1e-5,
              rms_displacement=7e-6)


def _config(module, opt_cls):
    return module.AutoTSConfig(
        n_images=14,
        neb=dataclasses.replace(module.AutoTSConfig().neb, n_steps=120),
        saddle=opt_cls(method="rfo_bofill", saddle_order=1, nsteps=60,
                       fc_count=3, init_hessian="exact",
                       trust_radius_ang=0.1, **_TIGHT),
        endpoint_opt=opt_cls(method="rfo_fsb", nsteps=80, **_TIGHT))


def test_autots_on_muller_brown_matches_reference():
    r = np.array([[MB_MIN_A[0], MB_MIN_A[1], 0.0]])
    p = np.array([[MB_MIN_C[0], MB_MIN_C[1], 0.0]])
    ref = ref_autots.autots(RefMB(), jnp.asarray(r), jnp.array([1]),
                            _config(ref_autots, RefOptConfig),
                            product_coords=jnp.asarray(p))
    got = autots.autots(MullerBrown(device="cpu"), r, np.array([1]),
                        _config(autots, OptimizeConfig), product_coords=p,
                        device="cpu")
    assert got.n_imaginary == ref.n_imaginary == 1
    np.testing.assert_allclose(got.ts_coords.numpy(),
                               np.asarray(ref.ts_coords), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.ts_coords[0, :2].numpy(), MB_TS_AB,
                               atol=1e-5)
    for key in ("ts_energy", "barrier_forward", "barrier_backward",
                "reactant_energy", "product_energy"):
        assert getattr(got, key) == pytest.approx(getattr(ref, key),
                                                  abs=1e-10), key
    np.testing.assert_allclose(got.neb_energies,
                               np.asarray(ref.neb_energies), rtol=0,
                               atol=1e-10)
    assert [c["index"] for c in got.candidates] == \
        [c["index"] for c in ref.candidates]
    assert set(got.stage_seconds) == set(ref.stage_seconds)
    assert got.barrier_forward > 0 and got.barrier_backward > 0


def test_select_candidate_tiers_match_reference():
    def cand(n_imag, conv, idx):
        return (np.zeros((1, 3)), -float(idx), n_imag, None, conv, idx)

    cases = [
        [cand(2, True, 1), cand(1, False, 2), cand(1, True, 3)],
        [cand(2, True, 1), cand(1, False, 2)],
        [cand(0, False, 1), cand(2, True, 2)],
        [cand(0, False, 1), cand(3, False, 2)],
    ]
    for refined in cases:
        got = autots._select_candidate(refined)
        assert got is ref_autots._select_candidate(refined)
    assert [autots._select_candidate(c)[5] for c in cases] == [3, 2, 2, 1]


def test_stage_scan_chunk_default():
    cfg = autots.AutoTSConfig(
        saddle=OptimizeConfig(method="rfo_bofill", saddle_order=1,
                              scan_chunk=1))
    out = autots._chunked_stages(cfg)
    assert (out.afir_opt.scan_chunk, out.saddle.scan_chunk,
            out.endpoint_opt.scan_chunk, out.neb.scan_chunk) == (16, 1, 16, 16)
    assert autots._chunked_stages(
        dataclasses.replace(cfg, scan_chunk=0)).afir_opt.scan_chunk == 0


def _fields(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return [_fields(v) for v in obj]
    return obj


def test_v1_config_translation_matches_reference():
    cfg = json.loads((_REPO / "examples/ab/config_autots_sqm2_ab.json")
                     .read_text())
    ref_cfg, ref_flow = ref_autots.autots_config_from_v1(cfg, 10)
    got_cfg, got_flow = autots.autots_config_from_v1(cfg, 10)
    assert _fields(got_cfg) == _fields(ref_cfg)
    assert got_flow == ref_flow
    assert got_cfg.afir_fragm_1 == (3,) and got_cfg.irc.n_steps == 10
    extra = dict(cfg, step1_settings=dict(
        cfg["step1_settings"], manual_AFIR=["300", "1", "11", "300", "4",
                                            "12"]))
    extra["step2_settings"] = dict(cfg["step2_settings"], align_distances=25,
                                   partition=16)
    assert _fields(autots.autots_config_from_v1(extra)[0]) == \
        _fields(ref_autots.autots_config_from_v1(extra)[0])


def test_mesh_and_idpp_raise():
    calc = MullerBrown(device="cpu")
    r = np.array([[MB_MIN_A[0], MB_MIN_A[1], 0.0]])
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 17"):
        autots.autots(calc, r, [1], product_coords=r, mesh=object(),
                      device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 11"):
        autots.autots(calc, r, [1], autots.AutoTSConfig(use_idpp=True),
                      product_coords=r, device="cpu")
