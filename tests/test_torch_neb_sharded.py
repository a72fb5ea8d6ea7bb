"""Port parity: the sharded band of multioptpy_tpu_torch (drivers/neb.py's
NEBState, neb_init, neb_sharded_step, neb_sharded, aneb_sharded, and
drivers/gpneb.py's gpneb(mesh=)) on meshes of the CPU repeated 8 times,
against the JAX package's single-device functions: its make_neb_step loop
(tests/test_neb_sharded.py's cases: coordinates and energies to 1e-10,
fmax to 1e-12; L-BFGS to 1e-9 and 1e-10 over 8 iterations), its
aneb_sharded on a one-device mesh and its unsharded gpneb (1e-10). The
reference never runs a collective over more than one device here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.calculators.lj import LennardJones as RefLJ
from multioptpy_tpu.calculators.model_surfaces import (MB_MIN_A, MB_MIN_C,
                                                       MullerBrown as RefMB)
from multioptpy_tpu.drivers import gpneb as ref_gpneb
from multioptpy_tpu.drivers import neb as ref_neb
from multioptpy_tpu.parallel.mesh import ensemble_mesh as ref_mesh
from multioptpy_tpu.steppers.first_order import fire_init as ref_fire_init
from multioptpy_tpu.steppers.first_order import lbfgs_init as ref_lbfgs_init
from multioptpy_tpu_torch.calculators.lj import LennardJones
from multioptpy_tpu_torch.calculators.model_surfaces import MullerBrown
from multioptpy_tpu_torch.drivers import gpneb, neb
from multioptpy_tpu_torch.parallel import ShardedTree, ensemble_mesh

torch.set_num_threads(1)

_Z = np.array([18, 18, 18])
_A = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 6.8], [0.0, 6.8, 0.0]])
_B = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 9.0], [0.0, 7.4, 3.0]])
_SCALARS = ("dt", "alpha", "n_good", "iteration", "fmax", "rho", "hist_len")


def _mesh(k=8):
    return ensemble_mesh(devices=["cpu"] * k)


def _band(n_images=16, spike=0.0):
    """tests/test_neb_sharded.py's LJ-trimer band (noise from seed 7),
    image 3 raised by `spike` Bohr."""
    t = np.linspace(0.0, 1.0, n_images)[:, None, None]
    path = (1 - t) * _A[None] + t * _B[None]
    noise = 0.05 * np.random.default_rng(7).standard_normal(path.shape)
    noise[0] = noise[-1] = 0.0
    path = path + noise
    path[3] += spike
    return path


def _reference_loop(path0, cfg_kw, n_steps):
    """The JAX package's single-device make_neb_step loop: (path, energies
    of the last step, fmax of the last step, the climbing images seen)."""
    config = ref_neb.NEBConfig(n_steps=n_steps, **cfg_kw)
    step = jax.jit(ref_neb.make_neb_step(RefLJ(), jnp.asarray(_Z), config))
    path = jnp.asarray(path0)
    clock = (ref_lbfgs_init(path.size, dtype=path.dtype)
             if config.optimizer == "lbfgs"
             else ref_fire_init(path.size, path.dtype, dt0=config.dt0))
    seen = set()
    for it in range(1, n_steps + 1):
        path, clock, e, _, fmax = step(path, clock, jnp.asarray(it))
        seen.add(int(np.argmax(np.asarray(e)[1:-1])) + 1)
    return np.asarray(path), np.asarray(e), float(fmax), seen


# (force law, clock, iterations, climbing_start, spike, tolerances
# (coords and energies, fmax))
_CASES = {
    "cineb": ("cineb", "fire", 20, 5, 0.0, (1e-10, 1e-12)),
    # the climbing image moves across shard boundaries mid-run
    "cineb_ci_moves": ("cineb", "fire", 60, 3, 0.35, (1e-10, 1e-12)),
    "bneb": ("bneb", "fire", 25, 10, 0.0, (1e-10, 1e-12)),
    "nesb": ("nesb", "fire", 10, 10, 0.0, (1e-10, 1e-12)),
    "neb_lbfgs": ("neb", "lbfgs", 8, 10, 0.0, (1e-9, 1e-10)),
    "qsm2": ("qsm2", "fire", 10, 10, 0.0, (1e-10, 1e-12)),
    "ewbneb": ("ewbneb", "fire", 10, 10, 0.0, (1e-10, 1e-12)),
    "dmf": ("dmf", "fire", 10, 10, 0.0, (1e-10, 1e-12)),
    "om": ("om", "fire", 10, 10, 0.0, (1e-10, 1e-12)),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_sharded_step_matches_reference_single_device(case):
    variant, opt, n, ci_start, spike, (tol, tol_f) = _CASES[case]
    path0 = _band(spike=spike)
    cfg_kw = dict(variant=variant, optimizer=opt, climbing_start=ci_start)
    if opt == "lbfgs":
        cfg_kw.update(sd_step=0.5, max_move=0.3)
    ref_path, ref_e, ref_fmax, seen = _reference_loop(path0, cfg_kw, n)

    mesh = _mesh()
    calc = LennardJones(device="cpu")
    config = neb.NEBConfig(n_steps=n, **cfg_kw)
    step = neb.neb_sharded_step(calc, _Z, config, mesh)
    state = neb.shard_neb_state(
        neb.neb_init(torch.as_tensor(path0), config=config, device="cpu"),
        mesh)
    for _ in range(n):
        state = step(state)
        # the scalars agree on every shard, and every shard stays on its
        # device
        for sh in state.shards:
            for name in _SCALARS:
                assert torch.equal(getattr(sh, name),
                                   getattr(state.shards[0], name))
            assert sh.coords.shape[0] == 2
    for sh, dev in zip(state.shards, mesh.devices):
        assert all(t.device == dev for t in sh)
    full = state.gather()
    assert full.s_hist.shape[0] == (8 if opt == "lbfgs" else 0)
    assert np.abs(full.coords.numpy() - ref_path).max() <= tol
    assert np.abs(full.energies.numpy() - ref_e).max() <= tol
    assert abs(float(full.fmax) - ref_fmax) <= tol_f
    assert int(full.iteration) == n
    if case == "cineb_ci_moves":
        assert len(seen) >= 2


def test_unsupported_variants_and_clocks_raise():
    calc = LennardJones(device="cpu")
    mesh = _mesh(4)
    for kw in (dict(variant="qsm"), dict(variant="gpneb"),
               dict(optimizer="afire"), dict(optimizer="rfo")):
        with pytest.raises(ValueError, match="neb_sharded_step supports"):
            neb.neb_sharded_step(calc, _Z, neb.NEBConfig(**kw), mesh)
    step = neb.neb_sharded_step(calc, _Z, neb.NEBConfig(), mesh)
    with pytest.raises(ValueError, match="does not divide"):
        step(neb.neb_init(torch.as_tensor(_band(10)), device="cpu"))
    with pytest.raises(ValueError, match="NEBState"):
        step(neb.shard_neb_state(
            neb.neb_init(torch.as_tensor(_band()), device="cpu"), _mesh(8)))
    with pytest.raises(TypeError, match="Mesh"):
        neb.neb_sharded_step(calc, _Z, neb.NEBConfig(), mesh=object())


def _mb_band(n_images):
    """A straight band between the Muller-Brown minima A and C."""
    start = np.array([[MB_MIN_A[0], MB_MIN_A[1], 0.0]])
    end = np.array([[MB_MIN_C[0], MB_MIN_C[1], 0.0]])
    t = np.linspace(0.0, 1.0, n_images)[:, None, None]
    return (1 - t) * start[None] + t * end[None]


def test_neb_sharded_and_aneb_sharded_match_reference():
    """neb_sharded (fixed iterations) on the LJ band against the
    reference's neb_scan; aneb_sharded on 8 shards against the reference's
    aneb_sharded on a one-device mesh with the same round_to, on a
    Muller-Brown band that grows from 8 images to 16 (its two barriers are
    densified after 6 iterations and the band resampled to a multiple of
    8)."""
    cfg_kw = dict(variant="cineb", optimizer="fire", climbing_start=5,
                  n_steps=12, fmax=1e-9)
    path0 = _band(16)
    ref_scan = ref_neb.neb_scan(RefLJ(), jnp.asarray(path0), jnp.asarray(_Z),
                                ref_neb.NEBConfig(**cfg_kw))
    got = neb.neb_sharded(LennardJones(device="cpu"), torch.as_tensor(path0),
                          _Z, neb.NEBConfig(**cfg_kw), mesh=_mesh(),
                          device="cpu")
    assert got.n_iterations == 12 and got.ts_index == ref_scan.ts_index
    assert np.abs(got.path.numpy() - np.asarray(ref_scan.path)).max() <= 1e-10
    assert np.abs(got.energy_history
                  - np.asarray(ref_scan.energy_history)).max() <= 1e-10

    cfg_kw.update(dt0=0.05, dt_max=0.2, k_spring=5e-4)
    kw = dict(interpolation_num=1, frequency=6, max_images=32, round_to=8)
    path0 = _mb_band(8)
    ref = ref_neb.aneb_sharded(RefMB(), jnp.asarray(path0), jnp.asarray([1]),
                               ref_neb.NEBConfig(**cfg_kw),
                               mesh=ref_mesh(1, axis="batch"), **kw)
    got = neb.aneb_sharded(MullerBrown(device="cpu"), torch.as_tensor(path0),
                           [1], neb.NEBConfig(**cfg_kw), mesh=_mesh(),
                           device="cpu", **kw)
    assert got.path.shape == ref.path.shape and got.path.shape[0] == 16
    assert np.abs(got.path.numpy() - np.asarray(ref.path)).max() <= 1e-10
    assert np.abs(got.energies.numpy()
                  - np.asarray(ref.energies)).max() <= 1e-10


def test_gpneb_on_a_mesh_matches_reference():
    """A Muller-Brown band of 16 images on 8 shards against the reference's
    unsharded gpneb, 3 rounds of 10 surrogate steps, to 1e-10. At
    tests/test_sharded_gpneb_aneb.py's 30 steps a round the GP solve's
    conditioning (gpneb's docstring) parts the two packages by 1.7e-7 Bohr
    with or without a mesh, so there the sharded run is held to the port's
    own unsharded run instead, to 1e-12."""
    path0 = _mb_band(16)
    kw = dict(n_outer=3, n_inner=10, k_spring=5e-4, lengthscale=0.6,
              dt0=0.05, dt_max=0.2, fmax=2e-3)
    calc = MullerBrown(device="cpu")
    ref = ref_gpneb.gpneb(RefMB(), jnp.asarray(path0), jnp.asarray([1]),
                          ref_gpneb.GPNEBConfig(**kw))
    got = gpneb.gpneb(calc, torch.as_tensor(path0), [1],
                      gpneb.GPNEBConfig(**kw), mesh=_mesh(), device="cpu")
    assert got.n_true_evaluations == ref.n_true_evaluations == 48
    assert got.ts_index == ref.ts_index
    assert np.abs(got.path.numpy() - np.asarray(ref.path)).max() <= 1e-10
    assert np.abs(got.energies.numpy()
                  - np.asarray(ref.energies)).max() <= 1e-10

    cfg = gpneb.GPNEBConfig(**dict(kw, n_inner=30))
    one = gpneb.gpneb(calc, torch.as_tensor(path0), [1], cfg, device="cpu")
    got = gpneb.gpneb(calc, torch.as_tensor(path0), [1], cfg, mesh=_mesh(),
                      device="cpu")
    assert np.abs(got.path.numpy() - one.path.numpy()).max() <= 1e-12
    assert np.abs(got.energies.numpy() - one.energies.numpy()).max() <= 1e-12
    with pytest.raises(ValueError, match="not divisible"):
        gpneb.gpneb(calc, torch.as_tensor(path0[:12]), [1], cfg,
                    mesh=_mesh(), device="cpu")


def test_sharded_tree_of_a_band_gathers_in_shard_order():
    state = neb.neb_init(torch.as_tensor(_band()),
                         config=neb.NEBConfig(optimizer="lbfgs"),
                         device="cpu")
    sharded = neb.shard_neb_state(state, _mesh(4))
    assert isinstance(sharded, ShardedTree)
    assert [tuple(s.s_hist.shape) for s in sharded.shards] == \
        [(8, 4, 3, 3)] * 4
    assert torch.equal(sharded.shards[2].coords, state.coords[8:12])
    back = sharded.gather()
    for name in state._fields:
        assert torch.equal(getattr(back, name), getattr(state, name))
