"""Port parity: the optimize drivers of multioptpy_tpu_torch against the JAX
package, plus the port's import and device rules.

The optimizations run on H2O+ (see tests/test_torch_sqm.py: the open-shell
cation keeps the reference's Fermi search well conditioned)."""

import ast
import importlib
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.calculators import sqm as ref_sqm
from multioptpy_tpu_torch.calculators import sqm

ref_opt = importlib.import_module("multioptpy_tpu.drivers.optimize")
opt = importlib.import_module("multioptpy_tpu_torch.drivers.optimize")

torch.set_num_threads(1)

_REPO = pathlib.Path(__file__).resolve().parent.parent
_BASE = np.array([[0.0, 0.0, 0.1173], [0.0, 0.7572, -0.4692],
                  [0.0, -0.7572, -0.4692]]) * 1.8897261254578281
_Z = np.array([8, 1, 1])


def _waters(n, seed=3):
    rng = np.random.default_rng(seed)
    return _BASE[None] + 0.1 * rng.standard_normal((n, 3, 3))


def test_optimize_batch_matches_reference():
    batch = _waters(4)
    kw = dict(method="rfo_fsb", init_hessian="exact", eigh_impl="pallas")
    ref = ref_opt.optimize_batch(
        ref_sqm.SQM2(charge=1, eigh_impl="pallas"), jnp.asarray(batch),
        jnp.asarray(_Z), config=ref_opt.OptimizeConfig(**kw), n_steps=10)
    got = opt.optimize_batch(
        sqm.SQM2(charge=1, eigh_impl="pallas", device="cpu"), batch, _Z,
        config=opt.OptimizeConfig(**kw), n_steps=10, device="cpu")
    assert got.energy_history.shape == (10, 4)
    np.testing.assert_allclose(got.energy_history,
                               np.asarray(ref.energy_history), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(ref.coords),
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(ref.converged))


def test_optimize_with_exact_hessian_refresh_matches_reference():
    x0 = _waters(1, seed=5)[0]
    kw = dict(method="rfo_fsb", fc_count=5, nsteps=30)
    ref = ref_opt.optimize(ref_sqm.SQM2(charge=1), jnp.asarray(x0),
                           jnp.asarray(_Z),
                           config=ref_opt.OptimizeConfig(**kw))
    got = opt.optimize(sqm.SQM2(charge=1, device="cpu"), x0, _Z,
                       config=opt.OptimizeConfig(**kw), device="cpu")
    assert got.n_iterations == ref.n_iterations
    np.testing.assert_allclose(got.energy_history,
                               np.asarray(ref.energy_history), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(ref.coords),
                               rtol=0, atol=1e-8)


def test_step_from_shared_state_matches_reference():
    """Both packages continue from one mid-run state (iteration > 0, a
    quasi-Newton pair in hand) handed over through state_from_numpy."""
    x0 = _waters(1, seed=7)[0]
    cfg_kw = dict(method="rfo_bofill", init_hessian="identity")
    ref_calc = ref_sqm.SQM2(charge=1)
    ref_cfg = ref_opt.OptimizeConfig(**cfg_kw)
    ref_step = jax.jit(ref_opt.make_step_fn(ref_calc, jnp.asarray(_Z),
                                            config=ref_cfg))
    state = ref_opt.init_state(jnp.asarray(x0), jnp.asarray(_Z), ref_calc,
                               config=ref_cfg)
    for _ in range(2):
        state = ref_step(state)
    fields = {k: np.asarray(v) for k, v in state._asdict().items()
              if k != "fo_state"}
    mine = opt.state_from_numpy(fields, device="cpu")
    assert mine.coords.shape == (1, 3, 3) and int(mine.iteration[0]) == 2
    step = opt.make_step_fn(sqm.SQM2(charge=1, device="cpu"), _Z,
                            config=opt.OptimizeConfig(**cfg_kw))
    ref_next, got = ref_step(state), step(mine)
    for key in ("coords", "energy", "hessian", "trust_radius",
                "predicted_change", "move"):
        np.testing.assert_allclose(getattr(got, key)[0].numpy(),
                                   np.asarray(getattr(ref_next, key)),
                                   rtol=1e-10, atol=1e-12, err_msg=key)
    assert bool(got.converged[0]) == bool(ref_next.converged)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every port module leaves no `jax` and no `multioptpy_tpu`
    (exact name or `multioptpy_tpu.` prefix) in sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import multioptpy_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'multioptpy_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n in ('jax', 'multioptpy_tpu')\n"
        "       or n.startswith(('jax.', 'multioptpy_tpu.'))]\n"
        "print(len([n for n in sys.modules if n.startswith('multioptpy_tpu_torch')]))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    tree = ast.parse((_REPO / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    top = {n.split(".")[0] for n in names}
    assert "jax" not in top and "multioptpy_tpu" not in top, names


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        sqm.SQM2()
    calc = sqm.SQM2(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        opt.optimize(calc, _BASE, _Z)
    with pytest.raises(RuntimeError, match="CUDA"):
        opt.optimize_batch(calc, _waters(2), _Z, n_steps=1)


def test_unported_methods_and_options_raise():
    calc = sqm.SQM2(device="cpu")
    for cfg in (opt.OptimizeConfig(method="fire"),
                opt.OptimizeConfig(method="rfo_fsb", use_gdiis=True),
                opt.OptimizeConfig(method="rfo_fsb",
                                   init_hessian="model:lindh")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            opt.optimize(calc, _BASE, _Z, config=cfg, device="cpu")


def test_f32_input_runs_in_f32():
    got = opt.optimize_batch(
        sqm.SQM(device="cpu"), _waters(2).astype(np.float32), _Z,
        config=opt.OptimizeConfig(method="rfo_fsb", init_hessian="exact",
                                  eigh_impl="pallas"),
        n_steps=3, device="cpu")
    assert got.coords.dtype == torch.float32
    assert np.isfinite(got.energy_history).all()
    assert (got.energy_history[-1] < got.energy_history[0] + 1e-4).all()


_AFIR = [(300.0, [1], [11]), (300.0, [4], [12])]


def test_afir_biased_model_hessian_steps_match_reference():
    """3 AFIR-biased rfo_fsb steps from the lindh2007d3_raw model Hessian,
    rebuilt every 2 steps (mfc_count), on the Diels-Alder +1 cation."""
    from multioptpy_tpu.io.fixtures import diels_alder_reactant
    from multioptpy_tpu.potentials import BiasEngine as RefEngine
    from multioptpy_tpu.potentials import get_potential as ref_get
    from multioptpy_tpu_torch.potentials import BiasEngine, get_potential

    coords, z = diels_alder_reactant()
    ref_bias = RefEngine([ref_get("afir", gamma=g, fragm_1=f1, fragm_2=f2,
                                  element_z=z) for g, f1, f2 in _AFIR])
    bias = BiasEngine([get_potential("afir", gamma=g, fragm_1=f1,
                                     fragm_2=f2, element_z=z)
                       for g, f1, f2 in _AFIR])
    kw = dict(method="rfo_fsb", nsteps=3, mfc_count=2,
              init_hessian="model:lindh2007d3_raw")
    ref = ref_opt.optimize(ref_sqm.SQM2(charge=1), jnp.asarray(coords),
                           jnp.asarray(z), bias_engine=ref_bias,
                           config=ref_opt.OptimizeConfig(**kw),
                           record_trajectory=True)
    got = opt.optimize(sqm.SQM2(charge=1, device="cpu"), coords, z,
                       bias_engine=bias, config=opt.OptimizeConfig(**kw),
                       record_trajectory=True, device="cpu")
    assert got.n_iterations == ref.n_iterations == 3
    np.testing.assert_allclose(got.energy_history,
                               np.asarray(ref.energy_history), rtol=1e-10,
                               atol=0)
    np.testing.assert_allclose(got.coords_history,
                               np.asarray(ref.coords_history), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got.gradient.numpy(), np.asarray(ref.gradient),
                               rtol=0, atol=1e-9)


_RUNAWAY_RADIUS = 2.0


def _ref_runaway_calc():
    from multioptpy_tpu.calculators.base import Calculator as RefCalculator

    class Runaway(RefCalculator):
        """A well centered far out whose energy is NaN past a radius."""

        def energy(self, coords, z):
            e = 0.5 * jnp.sum((coords - 6.0) ** 2)
            r = jnp.sqrt(jnp.sum(coords ** 2))
            return jnp.where(r > _RUNAWAY_RADIUS, jnp.nan, e)

    return Runaway()


def _runaway_calc():
    from multioptpy_tpu_torch.calculators.base import Calculator

    class Runaway(Calculator):
        def energy(self, coords, z):
            e = 0.5 * ((coords - 6.0) ** 2).sum((-2, -1))
            r = torch.sqrt((coords ** 2).sum((-2, -1)))
            return torch.where(r > _RUNAWAY_RADIUS, torch.nan, e)

    return Runaway(device="cpu")


@pytest.mark.parametrize("chunk", [3, 4])
def test_scan_chunk_keeps_the_last_finite_state(chunk):
    """The chunked driver rejects the step that goes non-finite and returns
    the last finite state, as the reference's `_optimize_chunked` does."""
    x0 = np.array([[0.1, -0.2, 0.05]])
    kw = dict(method="rfo_fsb", nsteps=20, scan_chunk=chunk,
              init_hessian="identity")
    ref = ref_opt.optimize(_ref_runaway_calc(), jnp.asarray(x0),
                           jnp.array([1]),
                           config=ref_opt.OptimizeConfig(**kw),
                           record_trajectory=True)
    got = opt.optimize(_runaway_calc(), x0, np.array([1]),
                       config=opt.OptimizeConfig(**kw),
                       record_trajectory=True, device="cpu")
    assert np.isfinite(float(ref.energy)) and np.isfinite(float(got.energy))
    assert got.n_iterations == ref.n_iterations < 20
    np.testing.assert_allclose(got.energy_history,
                               np.asarray(ref.energy_history), rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(ref.coords),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.coords_history,
                               np.asarray(ref.coords_history), rtol=0,
                               atol=1e-12)


def test_scan_chunk_convergence_latch_matches_reference():
    """n_iterations is the step where convergence latched inside a chunk."""
    x0 = _waters(1, seed=11)[0]
    kw = dict(method="rfo_fsb", nsteps=40, scan_chunk=16,
              max_force=3e-3, rms_force=2e-3, max_displacement=1e-2,
              rms_displacement=7e-3)
    ref = ref_opt.optimize(ref_sqm.SQM2(charge=1), jnp.asarray(x0),
                           jnp.asarray(_Z),
                           config=ref_opt.OptimizeConfig(**kw))
    got = opt.optimize(sqm.SQM2(charge=1, device="cpu"), x0, _Z,
                       config=opt.OptimizeConfig(**kw), device="cpu")
    assert bool(got.converged) and bool(ref.converged)
    assert got.n_iterations == ref.n_iterations < 16
    np.testing.assert_allclose(got.energy_history,
                               np.asarray(ref.energy_history), rtol=0,
                               atol=1e-9)
