"""Port parity: multioptpy_tpu_torch.parallel (the Mesh, shard_batch,
sharded_optimize_batch) and the mesh of optimize_batch, conformer_search,
map_network and autots, on meshes of the CPU repeated 4 or 8 times,
against the JAX package's single-device functions:
- optimize_batch on tests/test_parallel.py's LJ batch, rtol 1e-10;
- the LJ6 search of tests/test_parallel.py (2 rounds of 8), held to ten
  times the port's own witness (the same sharded search from a start moved
  by 1e-14 Bohr), never looser than 1e-10 Ha / 1e-8 Bohr, the witness
  capped at 1e-8 Ha / 1e-4 Bohr (ROADMAP Queue 3);
- map_network with each package's AutoTS replaced by one canned answer, so
  that the network depends on the queue and the batched AFIR executor
  alone: the seed node of the reference's sequential network, the nodes
  and edges of its batched one (1e-10), and the executor's products and
  trajectories against the reference's executor (1e-10);
- autots on the LJ trimer of __graft_entry__.py (8 images) and on
  Muller-Brown (8 images, two candidates refined in parallel) against the
  reference's autots on a one-device mesh: the band, the candidates, the
  TS and the endpoints (1e-10 Ha, 1e-8 Bohr);
- the tensor-parallel SQM2 gradient on "tp" meshes of the CPU: ethane,
  propane (rows split 3+3+3+2) and the S8 crown (d shells) against the
  reference's unsharded jitted SQM2 (1e-10 relative) and the port's
  unsharded run (1e-12), rfo_fsb steps under SQM2(tp_mesh=...), and the
  refusals."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.calculators import LennardJones as RefLJ
from multioptpy_tpu.calculators.model_surfaces import MullerBrown as RefMB
from multioptpy_tpu.calculators.sqm import SQM2 as RefSQM2
from multioptpy_tpu.drivers.irc import IRCConfig as RefIRCConfig
from multioptpy_tpu.drivers.neb import NEBConfig as RefNEBConfig
from multioptpy_tpu.drivers.optimize import OptimizeConfig as RefOptConfig
from multioptpy_tpu.drivers.optimize import optimize_batch as ref_batch
from multioptpy_tpu.parallel.mesh import ensemble_mesh as ref_mesh
from multioptpy_tpu.periodic import UFF_VDW_R
from multioptpy_tpu.workflows import autots as ref_autots
from multioptpy_tpu.workflows import confsearch as ref_confsearch
from multioptpy_tpu.workflows import mapper as ref_mapper
from multioptpy_tpu.workflows.autots import AutoTSResult
from multioptpy_tpu_torch.calculators import sqm as sqm_mod
from multioptpy_tpu_torch.calculators.lj import LennardJones
from multioptpy_tpu_torch.calculators.model_surfaces import (MB_MIN_A,
                                                             MB_MIN_C,
                                                             MullerBrown)
from multioptpy_tpu_torch.calculators.sqm import SQM2
from multioptpy_tpu_torch.drivers.irc import IRCConfig
from multioptpy_tpu_torch.drivers.neb import NEBConfig
from multioptpy_tpu_torch.drivers.optimize import (OptimizeConfig, optimize,
                                                   optimize_batch)
from multioptpy_tpu_torch.io.fixtures import alkane_chain, s8_crown
from multioptpy_tpu_torch.parallel import (Mesh, ShardedTree, ensemble_mesh,
                                           shard_batch,
                                           sharded_optimize_batch,
                                           tp_energy_and_gradient)
from multioptpy_tpu_torch.workflows import autots, confsearch, mapper

torch.set_num_threads(1)

RMIN = float(UFF_VDW_R[18])
_R = 7.1
_TRIMER = np.array([[0.0, 0.0, 0.0], [_R, 0.0, 0.0], [_R / 2, _R * 0.9, 0.0]])
_TIGHT = dict(method="rfo_fsb", max_force=1e-6, rms_force=7e-7,
              max_displacement=1e-4, rms_displacement=7e-5)
WITNESS_CAP = (1e-8, 1e-4)


def _mesh(k):
    return ensemble_mesh(devices=["cpu"] * k)


def _batch16():
    """tests/test_parallel.py's 16 perturbed Ar3 triangles."""
    rng = np.random.default_rng(11)
    base = np.array([[0.0, 0.0, 0.0], [RMIN * 1.1, 0.0, 0.0],
                     [RMIN * 0.5, RMIN * 0.95, 0.05]])
    return np.stack([base + 0.1 * rng.standard_normal(base.shape)
                     for _ in range(16)])


# --------------------------------------------------------------------------
# the Mesh and shard_batch
# --------------------------------------------------------------------------

def test_mesh_reads_like_the_reference():
    mesh = _mesh(8)
    assert isinstance(mesh, Mesh) and mesh.devices.size == 8
    assert mesh.axis_names == ("batch",) and mesh.shape["batch"] == 8
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert ensemble_mesh(3, devices=["cpu"] * 8).shape["batch"] == 3
    assert ensemble_mesh(devices=["cpu"] * 2, axis="x").axis_names == ("x",)


def test_mesh_limits_raise():
    with pytest.raises(ValueError, match="n_devices"):
        ensemble_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="n_devices"):
        ensemble_mesh(0, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        # no mesh is ever made of the CPU unless the caller names it
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ensemble_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            ensemble_mesh(devices=["cuda"] * 2)
    with pytest.raises(TypeError, match="Mesh"):
        shard_batch(torch.zeros(8, 3), object())
    with pytest.raises(ValueError, match="axis"):
        shard_batch(torch.zeros(8, 3), _mesh(4), axis="images")


def test_shard_batch_splits_in_shard_order_and_replicates():
    mesh = _mesh(4)
    x = torch.arange(8 * 3, dtype=torch.float64).reshape(8, 3)
    odd = torch.arange(6, dtype=torch.float64)
    scalar = torch.tensor(2.5)
    tree = (x, odd, scalar)
    sharded = shard_batch(tree, mesh)
    assert isinstance(sharded, ShardedTree) and sharded.split
    assert sharded.axes == (0, None, None)
    for i, (xs, os_, ss) in enumerate(sharded.shards):
        assert torch.equal(xs, x[2 * i:2 * i + 2])      # contiguous blocks
        assert torch.equal(os_, odd) and torch.equal(ss, scalar)
        assert xs.device == mesh.devices[i]
    back = sharded.gather()
    assert torch.equal(back[0], x) and torch.equal(back[1], odd)
    assert torch.equal(back[2], scalar)
    # numpy leaves become tensors; a tree with nothing to split stays whole
    whole = shard_batch(np.ones((3, 2)), mesh)
    assert not whole.split
    assert torch.equal(whole.gather(), torch.ones(3, 2, dtype=torch.float64))


def test_non_mesh_objects_are_refused():
    z = np.full(3, 18)
    with pytest.raises(TypeError, match="Mesh"):
        optimize_batch(LennardJones(device="cpu"), _batch16()[:2], z,
                       n_steps=1, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        sharded_optimize_batch(LennardJones(device="cpu"), _batch16()[:2], z,
                               mesh=object())


# --------------------------------------------------------------------------
# the tensor-parallel SQM gradient (item 17c)
# --------------------------------------------------------------------------

def _tp_mesh(k):
    return ensemble_mesh(devices=["cpu"] * k, axis="tp")


@functools.lru_cache(maxsize=None)
def _ref_eg(name):
    """The reference's unsharded, jitted SQM2(charge=1).energy_and_gradient
    of a fixture (a +1 cation: F1 limits closed shells to ~1e-7 Ha)."""
    coords, z = _TP_MOLS[name]()
    fn = jax.jit(lambda c: RefSQM2(charge=1).energy_and_gradient(c, z))
    e, g = fn(jnp.asarray(coords))
    return float(e), np.asarray(g)


_TP_MOLS = {"ethane": lambda: alkane_chain(2),
            "propane": lambda: alkane_chain(3), "s8": s8_crown}


@pytest.mark.parametrize("name,k,rows", [
    ("ethane", 4, [2, 2, 2, 2]), ("propane", 4, [3, 3, 3, 2]),
    ("s8", 2, [4, 4])])
def test_tp_gradient_matches_reference_and_unsharded(name, k, rows,
                                                     monkeypatch):
    """tp_energy_and_gradient on k CPU shards against the reference's
    unsharded SQM2 (1e-10 relative) and the port's unsharded run (1e-12):
    ethane; propane, whose 11 rows split unevenly; the S8 crown, whose row-3
    atoms take the d-shell (nob = 9) blocks."""
    coords, z = _TP_MOLS[name]()
    calc = SQM2(charge=1, device="cpu")
    seen = []
    build = sqm_mod._overlap_full

    def spy(x, prm, nob, rows=sqm_mod.ALL_ROWS):
        seen.append((nob, rows))
        return build(x, prm, nob, rows)

    monkeypatch.setattr(sqm_mod, "_overlap_full", spy)
    e, g = tp_energy_and_gradient(calc, coords, z, mesh=_tp_mesh(k))
    assert calc.tp_mesh is None and calc.tp_axis == "tp"
    assert e.shape == () and g.shape == (len(z), 3)
    assert [r.stop - r.start for _, r in seen] == rows
    assert {nob for nob, _ in seen} == {9 if name == "s8" else 4}
    e_ref, g_ref = _ref_eg(name)
    assert abs(float(e) - e_ref) <= 1e-10 * abs(e_ref)
    assert np.abs(g.numpy() - g_ref).max() <= 1e-10 * np.abs(g_ref).max()
    e1, g1 = calc.energy_and_gradient(torch.as_tensor(coords)[None], z)
    assert abs(float(e) - float(e1[0])) <= 1e-12
    assert (g - g1[0]).abs().max() <= 1e-12


def test_tp_calculator_through_rfo_fsb_steps():
    """SQM2(tp_mesh=4 CPU shards) through 3 rfo_fsb steps of ethane from
    the default model Hessian (Lindh), and its seminumerical Hessian (the
    6N displaced gradients in one sharded batch), against the same
    unsharded, 1e-12. The shards sum the gradient in another order (~3e-17
    Ha/Bohr apart); from the exact initial Hessian, whose 1e-4 Bohr central
    differences amplify that, the 3 steps part by 6e-12 Bohr."""
    coords, z = alkane_chain(2)
    cfg = OptimizeConfig(method="rfo_fsb", nsteps=3,
                         init_hessian="model:lindh")
    tp_calc = SQM2(charge=1, device="cpu", tp_mesh=_tp_mesh(4),
                   tp_axis="tp")
    one_calc = SQM2(charge=1, device="cpu")
    tp, one = (optimize(c, coords, z, config=cfg, device="cpu")
               for c in (tp_calc, one_calc))
    assert tp.n_iterations == one.n_iterations == 3
    assert np.abs(np.asarray(tp.energy_history)
                  - np.asarray(one.energy_history)).max() <= 1e-12
    assert (tp.coords - one.coords).abs().max() <= 1e-12
    x = torch.as_tensor(coords)[None]
    assert (tp_calc.hessian(x, z) - one_calc.hessian(x, z)).abs().max() \
        <= 1e-12


def test_tp_refusals():
    """A non-Mesh, an axis the mesh lacks, and coordinates (or a
    calculator) on another device than the mesh's first are refused; the
    calculator comes back unsharded."""
    coords, z = alkane_chain(2)
    calc = SQM2(charge=1, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        tp_energy_and_gradient(calc, coords, z, mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        SQM2(tp_mesh=["cpu"], device="cpu")
    with pytest.raises(ValueError, match="axis"):
        tp_energy_and_gradient(calc, coords, z, mesh=_tp_mesh(2),
                               axis="batch")
    with pytest.raises(ValueError, match="axis"):
        SQM2(tp_mesh=_tp_mesh(2), tp_axis="batch", device="cpu")
    # a mesh gathering on a card: the CPU coordinates are refused by the
    # calculator's pair builds, the CPU calculator by the entry point
    card = _tp_mesh(2)
    card.devices[0] = torch.device("cuda", 0)
    sharded = SQM2(charge=1, tp_mesh=card, device="cpu")
    with pytest.raises(ValueError, match="disagree"):
        sharded.energy(torch.as_tensor(coords)[None], z)
    with pytest.raises(ValueError, match="calculator lives on"):
        tp_energy_and_gradient(calc, torch.as_tensor(coords), z, mesh=card)
    assert calc.tp_mesh is None


# --------------------------------------------------------------------------
# ensembles
# --------------------------------------------------------------------------

def test_sharded_optimize_batch_matches_reference():
    """tests/test_parallel.py's sharded optimization: 16 members on 8
    shards (and on 4 through optimize_batch(mesh=)), 50 RS-RFO steps,
    against the reference's unsharded optimize_batch, rtol 1e-10."""
    z = np.full(3, 18)
    batch = _batch16()
    ref = ref_batch(RefLJ(), jnp.asarray(batch), jnp.asarray(z),
                    config=RefOptConfig(**_TIGHT), n_steps=50)
    calc = LennardJones(device="cpu")
    got = sharded_optimize_batch(calc, torch.as_tensor(batch), z,
                                 mesh=_mesh(8),
                                 config=OptimizeConfig(**_TIGHT), n_steps=50)
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(ref.energy),
                               rtol=1e-10)
    assert bool(got.converged.all()) and got.coords.shape == (16, 3, 3)
    got4 = optimize_batch(calc, torch.as_tensor(batch), z,
                          config=OptimizeConfig(**_TIGHT), n_steps=50,
                          mesh=_mesh(4), device="cpu")
    np.testing.assert_allclose(got4.energy.numpy(), np.asarray(ref.energy),
                               rtol=1e-10)
    np.testing.assert_allclose(got4.energy_history,
                               np.asarray(ref.energy_history), rtol=1e-10)
    np.testing.assert_allclose(got4.coords.numpy(), np.asarray(ref.coords),
                               rtol=0, atol=1e-8)


def _search(coords, cfg, mesh):
    return confsearch.conformer_search(
        LennardJones(device="cpu"), torch.as_tensor(coords), np.full(6, 18),
        confsearch.ConfSearchConfig(**cfg), mesh=mesh, device="cpu")


def test_conformer_search_on_a_mesh_matches_reference():
    """tests/test_torch_confsearch.py's LJ6 search (2 rounds of 8, tight
    RS-RFO) on 4 shards of 2 members against the reference, held by the
    witness rule (the witness: the port's search from a start moved by
    1e-14 Bohr). tests/test_parallel.py's LJ6 search moves 1.0e-3 Bohr from
    such a start, above the witness cap, so there one round of the sharded
    search is held to the port's unsharded one instead (1e-12)."""
    coords = np.random.default_rng(5).standard_normal((6, 3)) * RMIN * 0.5
    cfg = dict(batch_size=8, n_rounds=2, base_gamma=60.0, kick_steps=40,
               relax_steps=60, preserve_bonds=False, dedupe_threshold=0.05,
               seed=1)
    ref = ref_confsearch.conformer_search(
        RefLJ(), jnp.asarray(coords), jnp.full(6, 18),
        ref_confsearch.ConfSearchConfig(**cfg, opt=RefOptConfig(**_TIGHT)))
    cfg["opt"] = OptimizeConfig(**_TIGHT)
    got = _search(coords, cfg, _mesh(4))
    wit = _search(coords + 1e-14 * np.random.default_rng(0).standard_normal(
        coords.shape), cfg, None)
    assert got.n_nonfinite == 0 and got.n_generated == ref.n_generated
    assert len(got.energies) == len(ref.energies) == len(wit.energies) >= 2
    w_e = np.abs(wit.energies - got.energies).max()
    w_x = np.abs(wit.conformers - got.conformers).max()
    assert w_e <= WITNESS_CAP[0] and w_x <= WITNESS_CAP[1]
    assert np.abs(got.energies - ref.energies).max() <= max(1e-10, 10 * w_e)
    assert np.abs(got.conformers - np.asarray(ref.conformers)).max() <= \
        max(1e-8, 10 * w_x)

    coords = np.random.default_rng(3).normal(size=(6, 3)) * 2.5
    cfg = dict(batch_size=8, n_rounds=1, kick_steps=30, relax_steps=40,
               base_gamma=120.0, preserve_bonds=False, seed=11)
    one, got = _search(coords, cfg, None), _search(coords, cfg, _mesh(4))
    assert len(got.energies) == len(one.energies) >= 2
    assert np.abs(got.energies - one.energies).max() <= 1e-12
    assert np.abs(got.conformers - one.conformers).max() <= 1e-12


def _canned_autots(monkeypatch, mod, to_host):
    """Replace `mod.autots` by one answer: the task's start as one end, the
    start pushed apart along the task's pair as the other, a TS between."""
    def fake(calc, reactant, zz, cfg, **kwargs):
        x = to_host(reactant)
        i, j = cfg.afir_fragm_1[0] - 1, cfg.afir_fragm_2[0] - 1
        y = x.copy()
        y[j] += 0.6 * (x[j] - x[i])
        ts = 0.5 * (x + y)
        e = [float(np.sum(c ** 2)) * 1e-6 - 0.001 for c in (x, y, ts)]
        return AutoTSResult(
            ts_coords=ts, ts_energy=e[2] + 0.002, n_imaginary=1,
            barrier_forward=0.0, barrier_backward=0.0, irc_result=None,
            reactant_coords=x, product_coords=y, reactant_energy=e[0],
            product_energy=e[1], neb_path=None, neb_energies=None,
            afir_trajectory=None, candidates=(), stage_seconds={})
    monkeypatch.setattr(mod, "autots", fake)


def test_map_network_on_a_mesh_matches_reference(tmp_path, monkeypatch):
    """The LJ trimer of tests/test_torch_mapper.py, 4 tasks a round on 4
    shards (one task a shard), AutoTS canned in both packages."""
    z = np.full(3, 18)
    _canned_autots(monkeypatch, ref_mapper, np.asarray)
    _canned_autots(monkeypatch, mapper, lambda x: x.numpy())
    kw = dict(max_nodes=8, max_explorations=8, queue="rcmc",
              include_negative_gamma=True)

    def cfg(mod, name, batch):
        opt = OptimizeConfig if mod is mapper else RefOptConfig
        return mod.MapperConfig(
            afir_gamma=30.0, dist_lower_ang=0.5, dist_upper_ang=9.0,
            work_dir=str(tmp_path / name), batch_size=batch, afir_steps=30,
            opt=opt(method="rfo_fsb", nsteps=40), **kw)

    seq = ref_mapper.map_network(RefLJ(), jnp.asarray(_TRIMER),
                                 jnp.asarray(z), cfg(ref_mapper, "seq", 1))
    want = ref_mapper.map_network(RefLJ(), jnp.asarray(_TRIMER),
                                  jnp.asarray(z), cfg(ref_mapper, "ref", 4))
    sizes, batches = [], []
    make = mapper.make_afir_task_relax

    def counted(*a, **k):
        run = make(*a, **k)

        def go(coords_b, *rest):
            sizes.append(coords_b.shape[0])
            return run(coords_b, *rest)
        return go

    monkeypatch.setattr(mapper, "make_afir_task_relax", counted)
    got = mapper.map_network(
        LennardJones(device="cpu"), torch.as_tensor(_TRIMER), z,
        cfg(mapper, "port", 4), mesh=_mesh(4), device="cpu",
        stage_hook=lambda name, **d: batches.append(d)
        if name == "afir_batch" else None)
    assert got.skipped == {}
    assert abs(got.nodes[0].energy - seq.nodes[0].energy) <= 1e-10
    assert len(got.nodes) == len(want.nodes) > 2
    for g, w in zip(got.nodes, want.nodes):
        assert abs(g.energy - w.energy) <= 1e-10
        assert np.abs(g.coords - np.asarray(w.coords)).max() <= 1e-8
    assert [(e.node_a, e.node_b) for e in got.edges] == \
        [(e.node_a, e.node_b) for e in want.edges]
    # a round of 4 tasks ran one task on each shard, any other round whole
    n_tasks = [b["coords"].shape[0] for b in batches]
    assert 4 in n_tasks
    assert sizes == [k for n in n_tasks for k in ([1] * 4 if n % 4 == 0
                                                  else [n])]
    run = ref_mapper.make_afir_task_relax(RefLJ(), jnp.asarray(z), 30)
    for b in batches:
        prods, trajs = run(*(jnp.asarray(b[k].numpy())
                             for k in ("coords", "w1", "w2", "gamma")))
        assert np.abs(b["products"].numpy() - np.asarray(prods)).max() <= 1e-10
        assert np.abs(b["trajs"].numpy() - np.asarray(trajs)).max() <= 1e-10


# --------------------------------------------------------------------------
# AutoTS on a mesh
# --------------------------------------------------------------------------

_TRIMER_A = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 7.0], [0.0, 7.0, 0.0]])
_TRIMER_B = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 7.0], [0.0, 7.0, 7.0]])
_MB_A = np.array([[MB_MIN_A[0], MB_MIN_A[1], 0.0]])
_MB_C = np.array([[MB_MIN_C[0], MB_MIN_C[1], 0.0]])
_MB_TIGHT = dict(max_force=1e-7, rms_force=7e-8, max_displacement=1e-5,
                 rms_displacement=7e-6)


def _autots_case(case, mod, neb_cls, opt_cls, irc_cls):
    """(calculator class name, z, reactant, product, config). lj_trimer:
    __graft_entry__.py's sharded-AutoTS configuration at 8 images (its band
    has one maximum). muller_brown: 8 images between minima A and C, whose
    band has two maxima, so step 3 refines two candidates in parallel; its
    band asks for a redistribution every 10 iterations, which the mesh
    path drops in both packages (ROADMAP Queue 3, F11)."""
    if case == "lj_trimer":
        return ("LennardJones", np.full(3, 18), _TRIMER_A, _TRIMER_B,
                mod.AutoTSConfig(
                    n_images=8,
                    neb=neb_cls(variant="cineb", optimizer="fire", n_steps=6,
                                climbing_start=3),
                    top_n_candidates=2,
                    saddle=opt_cls(method="rfo_bofill", saddle_order=1,
                                   nsteps=6, init_hessian="exact"),
                    irc=irc_cls(method="euler", step_size=0.05, n_steps=4),
                    endpoint_opt=opt_cls(method="rfo_fsb", nsteps=5)))
    return ("MullerBrown", np.array([1]), _MB_A, _MB_C, mod.AutoTSConfig(
        n_images=8,
        neb=neb_cls(variant="cineb", n_steps=40, k_spring=5e-4,
                    climbing_start=20, dt0=0.05, dt_max=0.2,
                    redistribute="linear", redistribute_every=10),
        top_n_candidates=2,
        saddle=opt_cls(method="rfo_bofill", saddle_order=1, nsteps=30,
                       fc_count=3, init_hessian="exact",
                       trust_radius_ang=0.1, **_MB_TIGHT),
        irc=irc_cls(method="euler", step_size=0.05, n_steps=10),
        endpoint_opt=opt_cls(method="rfo_fsb", nsteps=30, **_MB_TIGHT)))


@pytest.mark.parametrize("case", ["lj_trimer", "muller_brown"])
def test_autots_on_a_mesh_matches_reference(case):
    """AutoTS on 4 shards (2 images a shard; the candidates padded to 4)
    against the reference's autots on a one-device mesh, which runs the
    same 8-image band and the same candidate-parallel refinement."""
    name, z, a, b, cfg = _autots_case(case, ref_autots, RefNEBConfig,
                                      RefOptConfig, RefIRCConfig)
    ref_calc = {"LennardJones": RefLJ, "MullerBrown": RefMB}[name]()
    ref = ref_autots.autots(ref_calc, jnp.asarray(a), jnp.asarray(z), cfg,
                            product_coords=jnp.asarray(b), mesh=ref_mesh(1))
    cfg = _autots_case(case, autots, NEBConfig, OptimizeConfig, IRCConfig)[4]
    calc = {"LennardJones": LennardJones,
            "MullerBrown": MullerBrown}[name](device="cpu")
    stages = []
    got = autots.autots(calc, a, z, cfg, product_coords=b, mesh=_mesh(4),
                        device="cpu",
                        stage_hook=lambda n, **d: stages.append((n, d)))
    assert len(got.candidates) == len(ref.candidates) == \
        (2 if case == "muller_brown" else 1)
    assert [c["index"] for c in got.candidates] == \
        [c["index"] for c in ref.candidates]
    assert got.n_imaginary == ref.n_imaginary
    np.testing.assert_allclose(got.neb_energies, np.asarray(ref.neb_energies),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.neb_path.numpy(), np.asarray(ref.neb_path),
                               rtol=0, atol=1e-8)
    for g, w in zip(got.candidates, ref.candidates):
        assert g["energy"] == pytest.approx(w["energy"], abs=1e-10)
        assert np.abs(g["coords"] - np.asarray(w["coords"])).max() <= 1e-8
    np.testing.assert_allclose(got.ts_coords.numpy(),
                               np.asarray(ref.ts_coords), rtol=0, atol=1e-8)
    for key in ("ts_energy", "reactant_energy", "product_energy",
                "barrier_forward", "barrier_backward"):
        assert getattr(got, key) == pytest.approx(getattr(ref, key),
                                                  abs=1e-10), key
    for end in ("reactant_coords", "product_coords"):
        np.testing.assert_allclose(getattr(got, end).numpy(),
                                   np.asarray(getattr(ref, end)), rtol=0,
                                   atol=1e-8)
    assert [n for n, _ in stages] == list(got.stage_seconds)
    assert dict(stages)["step2_neb"]["neb"].n_iterations == cfg.neb.n_steps


@pytest.mark.parametrize("n_images,n_dev,n_cand", [(7, 4, 3), (5, 8, 1),
                                                   (16, 2, 2), (2, 3, 5)])
def test_image_rounding_and_candidate_padding_follow_reference(
        n_images, n_dev, n_cand):
    """autots' rules for a count that does not divide: the reference's
    formulas (workflows/autots.py's mesh branches)."""
    want_images = max(((n_images + n_dev - 1) // n_dev) * n_dev, n_dev)
    assert autots.mesh_images(n_images, n_dev) == want_images
    cands = list(range(10, 10 + n_cand))
    want = list(cands)
    while len(want) % n_dev:
        want.append(cands[-1])
    assert autots.pad_candidates(cands, n_dev) == want
