"""Port parity: multioptpy_tpu_torch.workflows.autots_v2 against the JAX
package on Muller-Brown: validate_workflow's errors, a repeated opt step
with a parameter override, the neb -> saddle -> freq -> irc pipeline and
the reference's own v2 vocabulary (step2..step4, stepN_settings with
interface.py dest names), each with the same step reports (1e-10 Ha) and
artifacts (1e-8 Bohr)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.calculators.model_surfaces import MullerBrown as RefMB
from multioptpy_tpu.workflows import autots_v2 as ref
from multioptpy_tpu_torch.calculators.model_surfaces import (MB_MIN_A,
                                                             MB_MIN_B,
                                                             MB_MIN_C,
                                                             MB_TS_AB,
                                                             MullerBrown)
from multioptpy_tpu_torch.workflows import autots_v2

torch.set_num_threads(1)

_A = np.array([[MB_MIN_A[0], MB_MIN_A[1], 0.0]])
_C = np.array([[MB_MIN_C[0], MB_MIN_C[1], 0.0]])


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _both(config, start=_A, product=None):
    z = np.array([1])
    r_eng, r_rep = ref.run_autots_v2(
        RefMB(), jnp.asarray(start), jnp.asarray(z), config,
        product_coords=None if product is None else jnp.asarray(product))
    p_eng, p_rep = autots_v2.run_autots_v2(
        MullerBrown(device="cpu"), torch.as_tensor(start), z, config,
        product_coords=None if product is None else torch.as_tensor(product),
        device="cpu")
    assert [r["step"] for r in p_rep] == [r["step"] for r in r_rep]
    for got, want in zip(p_rep, r_rep):
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, (float, np.floating)) or (
                    hasattr(v, "shape") and not isinstance(v, str)):
                assert abs(float(got[k]) - float(v)) <= 1e-10, k
            elif isinstance(v, list):
                np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-10)
            else:
                assert got[k] == v, k
    for key in ("geometry", "product", "ts_guess", "ts"):
        if r_eng.ctx.get(key) is not None:
            assert np.abs(_host(p_eng.ctx[key])
                          - np.asarray(r_eng.ctx[key])).max() <= 1e-8, key
    return p_eng, p_rep


def test_validation_errors_match_reference():
    autots_v2.validate_workflow([{"step": "opt", "repeat": 2},
                                 {"step": "step3"}])
    for bad in ([{"step": "nonsense"}], [{"step": "opt", "repeat": 0}],
                [{"step": "opt", "repeat": 1,
                  "repeat_settings": ["a", "b"]}]):
        with pytest.raises(autots_v2.WorkflowError) as got:
            autots_v2.validate_workflow(bad)
        with pytest.raises(ref.WorkflowError) as want:
            ref.validate_workflow(bad)
        assert str(got.value) == str(want.value)
    assert autots_v2.REF_STEP_ALIASES == ref.REF_STEP_ALIASES
    engine = autots_v2.AutoTSv2(MullerBrown(device="cpu"),
                                torch.as_tensor(_A), [1],
                                {"workflow": [{"step": "saddle"}]},
                                device="cpu")
    with pytest.raises(autots_v2.WorkflowError, match="ts_guess"):
        engine.run()


def test_repeat_with_param_override_matches_reference():
    start = _A + np.array([[0.15, -0.1, 0.0]])
    engine, reports = _both({"workflow": [
        {"step": "opt", "repeat": 2, "param_override": {"nsteps": 40}},
        {"step": "opt", "repeat": 2, "repeat_settings": [
            "opt_settings", {"param_override": {"nsteps": 3}}]}],
        "opt_settings": {"nsteps": 5}}, start=start)
    assert len(reports) == 4
    np.testing.assert_allclose(engine.ctx["geometry"][0, :2].numpy(),
                               MB_MIN_A, atol=1e-4)


def test_neb_saddle_freq_irc_pipeline_matches_reference():
    config = {
        "workflow": [
            {"step": "neb", "settings_key": "neb_settings"},
            {"step": "saddle", "param_override": {"trust_radius": 0.1}},
            {"step": "freq"},
            {"step": "irc", "settings_key": "irc_settings"},
        ],
        "neb_settings": {"n_images": 12, "nsteps": 300, "k_spring": 5e-4,
                         "climbing_start": 40, "from_path": False},
        "irc_settings": {"nsteps": 120, "step_size": 0.05},
    }
    engine, reports = _both(config, product=_C)
    np.testing.assert_allclose(engine.ctx["ts"][0, :2].numpy(), MB_TS_AB,
                               atol=1e-4)
    assert reports[2]["n_imaginary"] == 1
    assert engine.ctx["irc_ends"] is not None


def test_reference_vocabulary_workflow_matches_reference():
    config = {
        "workflow": [{"step": "step2"}, {"step": "step3"},
                     {"step": "step4"}],
        "step2_settings": {"NSTEP": 300, "n_images": 12, "k_spring": 5e-4,
                           "climbing_start": 40, "from_path": False},
        "step3_settings": {"opt_method": ["rsirfo_bofill"],
                           "calc_exact_hess": 3, "max_trust_radius": 0.1,
                           "frequency_analysis": True},
        "step4_settings": {
            "intrinsic_reaction_coordinates": ["0.05", "120", "lqa"],
            "step4b_opt_method": ["rsirfo_fsb"]},
    }
    engine, reports = _both(config, product=_C)
    assert [r["step"] for r in reports] == ["neb", "saddle", "irc"]
    assert reports[1]["n_imaginary"] == 1
    ends = sorted(tuple(e[0, :2].numpy()) for e in engine.ctx["irc_ends"])
    np.testing.assert_allclose(np.asarray(ends),
                               np.asarray(sorted([tuple(MB_MIN_A),
                                                  tuple(MB_MIN_B)])),
                               atol=5e-3)
    norm = autots_v2.AutoTSv2._normalize(config["step4_settings"])
    assert norm == ref.AutoTSv2._normalize(config["step4_settings"])
