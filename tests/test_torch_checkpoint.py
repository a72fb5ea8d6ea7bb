"""The port's checkpoints: an npz of the state's tensors plus a JSON
description of its tree (no pickle).

For every kind of engine state in `fo_state` (block windows, followed
modes, the DIIS histories, the switch engine, FIRE, L-BFGS, CG, GP, Eve,
Adam, GAN, the RL policy and its generator, DIC's primitive-space state)
a run on the 4-atom Lennard-Jones cluster that writes a checkpoint after 2
steps and is resumed from it for 3 more takes the same trajectory as the
run of 5 steps without a stop, to the last bit. A batched state of every
kind comes back leaf for leaf."""

import importlib

import numpy as np
import pytest
import torch

from multioptpy_tpu_torch.calculators.lj import LennardJones
from multioptpy_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

opt = importlib.import_module("multioptpy_tpu_torch.drivers.optimize")

torch.set_num_threads(1)

_TET = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                float) * 6.6 / np.sqrt(8)
_X0 = _TET + 0.6 * np.random.default_rng(0).standard_normal((4, 3))
_Z = np.array([18, 18, 18, 18])

_RUNS = [
    ("rfo_fsb", {}), ("rsirfo_block_fsb", {}),
    ("mf_rsirfo_fsb", {"saddle_order": 1, "fc_count": 2}),
    ("rfo_fsb", {"diis_variant": "gediis"}),
    ("rfo_fsb", {"diis_variant": "kdiis"}),
    ("rfo_fsb", {"switch_method": "fire"}),
    ("dic_rsirfo_fsb", {}),
    *[(m, {}) for m in ("fire", "lbfgs", "cg", "gpmin", "eve", "adam", "gan",
                        "rl")],
]


def _optimize(kw, nsteps, **extra):
    return opt.optimize(LennardJones(device="cpu"), _X0, _Z,
                        config=opt.OptimizeConfig(nsteps=nsteps, **kw),
                        record_trajectory=True, device="cpu", **extra)


@pytest.mark.parametrize("method,extra", _RUNS,
                         ids=[f"{m}-{'-'.join(map(str, e.values()))}"
                              for m, e in _RUNS])
def test_resumed_run_takes_the_same_trajectory(method, extra, tmp_path):
    kw = dict(method=method, init_hessian="identity", **extra)
    whole = _optimize(kw, 5)
    path = str(tmp_path / "state.npz")
    first = _optimize(kw, 2, checkpoint_path=path, checkpoint_every=2)
    resumed = _optimize(kw, 3, resume_from=path)
    assert first.n_iterations == 2 and resumed.n_iterations == 3
    np.testing.assert_array_equal(resumed.energy_history,
                                  whole.energy_history[2:])
    np.testing.assert_array_equal(resumed.coords_history,
                                  whole.coords_history[2:])
    _, meta = load_checkpoint(path, device="cpu")
    assert meta == {"iteration": 2, "method": method}
    with np.load(path, allow_pickle=False) as data:
        assert "__manifest__" in data.files


def _leaves(tree):
    if isinstance(tree, torch.Generator):
        return [tree.get_state()]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [tree]


@pytest.mark.parametrize("method,extra", _RUNS[:4] + _RUNS[-4:],
                         ids=[m for m, _ in _RUNS[:4] + _RUNS[-4:]])
def test_batched_state_round_trips(method, extra, tmp_path):
    batch = _X0[None] + 0.1 * np.random.default_rng(1).standard_normal(
        (3, 4, 3))
    cfg = opt.OptimizeConfig(method=method, init_hessian="identity",
                             **extra)
    calc = LennardJones(device="cpu")
    state = opt.init_state(torch.as_tensor(batch), _Z, calc, config=cfg)
    step = opt.make_step_fn(calc, _Z, config=cfg)
    for _ in range(2):
        state = step(state)
    path = str(tmp_path / "batch.npz")
    save_checkpoint(path, state, meta={"note": "batched"})
    back, meta = load_checkpoint(path, device="cpu")
    assert meta == {"note": "batched"}
    assert type(back) is opt.OptState
    assert [type(x) for x in back.fo_state] == [type(x)
                                                for x in state.fo_state]
    got, want = _leaves(back), _leaves(state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_load_checkpoint_defaults_to_the_card(tmp_path):
    """Like every public entry point of the port, loading puts the state on
    the card unless the caller asks for the CPU."""
    path = str(tmp_path / "state.npz")
    save_checkpoint(path, {"x": torch.zeros(2)}, meta={})
    if torch.cuda.is_available():
        assert load_checkpoint(path)[0]["x"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            load_checkpoint(path)
    assert load_checkpoint(path, device="cpu")[0]["x"].device.type == "cpu"
