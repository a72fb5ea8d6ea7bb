"""Port parity: multioptpy_tpu_torch.workflows.mapper against the JAX
package. The checkers, the queues (same seeds, same pops and acceptance
draws), the explored-pairs log and the pair generator give the same
answers; each package reads the other's network JSON; the reference's
mapper config translates to the same MapperConfig; the batched AFIR
executor agrees to 1e-10 Bohr; map_network on the LJ trimer of
tests/test_mapper_machinery.py finds the same nodes and edges (energies
1e-10 Ha, geometries 1e-8 Bohr), and, with each package's AutoTS replaced
by one canned answer, grows the same network through the batched
executor. A task whose AutoTS raises a CUDA error stops the run; one that
raises a ValueError is skipped and counted."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.calculators.lj import LennardJones as RefLJ
from multioptpy_tpu.drivers.irc import IRCConfig as RefIRCConfig
from multioptpy_tpu.drivers.neb import NEBConfig as RefNEBConfig
from multioptpy_tpu.drivers.optimize import OptimizeConfig as RefOptConfig
from multioptpy_tpu.workflows import mapper as ref
from multioptpy_tpu.workflows.autots import AutoTSConfig as RefAutoTSConfig
from multioptpy_tpu.workflows.autots import AutoTSResult
from multioptpy_tpu_torch.calculators.lj import LennardJones
from multioptpy_tpu_torch.drivers.irc import IRCConfig
from multioptpy_tpu_torch.drivers.neb import NEBConfig
from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig
from multioptpy_tpu_torch.workflows import mapper
from multioptpy_tpu_torch.workflows.autots import AutoTSConfig

torch.set_num_threads(1)

_WATER = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.81], [1.75, 0.0, -0.48]])
_ZW = np.array([8, 1, 1])
_R = 7.1
_TRIMER = np.array([[0.0, 0.0, 0.0], [_R, 0.0, 0.0], [_R / 2, _R * 0.9, 0.0]])


def _cluster(seed, n=6, z=None):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 3)) * 2.5, (np.array(z) if z is not None
                                               else rng.choice([1, 6, 8], n))


def test_checkers_match_reference():
    sc, rsc = mapper.StructureChecker(), ref.StructureChecker()
    bt, rbt = mapper.BondTopologyChecker(), ref.BondTopologyChecker()
    rng = np.random.default_rng(1)
    for seed in range(4):
        a, z = _cluster(seed)
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        b = (a + 0.05 * rng.standard_normal(a.shape))[::-1] @ q.T
        zb = z[::-1]
        assert sc.compute_rmsd(z, a, zb, b) == rsc.compute_rmsd(z, a, zb, b)
        assert bt.fingerprint(z, a) == rbt.fingerprint(z, a)
        assert bt.has_rearrangement(z, a, zb, b) == \
            rbt.has_rearrangement(z, a, zb, b)
    line = np.array([[0.0, 0, 0], [0, 0, 2.2], [0, 0, 4.4]])
    assert sc.compute_rmsd(_ZW, line, _ZW, line[::-1]) == \
        rsc.compute_rmsd(_ZW, line, _ZW, line[::-1])


@pytest.mark.parametrize("kind", ["boltzmann", "random", "rcmc"])
def test_queues_pop_and_accept_alike(kind):
    def make(mod):
        return {"boltzmann": lambda: mod.BoltzmannQueue(350.0, 5),
                "random": lambda: mod.RandomQueue(5),
                "rcmc": lambda: mod.RCMCQueue(350.0, 1e-3, 5)}[kind]()

    rng = np.random.default_rng(2)
    des = rng.uniform(-0.002, 0.01, 12)
    queues = (make(mapper), make(ref))
    for q, mod in zip(queues, (mapper, ref)):
        if kind == "rcmc":
            x = np.zeros((1, 3))
            q.set_network(mod.Network(
                [mod.EQNode(x, -1.0), mod.EQNode(x, -0.995),
                 mod.EQNode(x, -0.99)],
                [mod.TSEdge(0, 1, x, -0.97), mod.TSEdge(1, 2, x, -0.975)]))
        for k, de in enumerate(des):
            q.push(mod.ExplorationTask(
                node_id=k % 3, pair=(k % 4, 4 + k % 2), gamma=100.0,
                metadata={"delta_E_hartree": float(de),
                          "source_node_energy": -1.0 + float(de)}))
        assert not q.push(mod.ExplorationTask(node_id=0, pair=(0, 4),
                                              gamma=100.0))
        q.refresh_priorities(-1.001)
    accepts = [[q.should_add(float(de)) for de in des] for q in queues]
    assert accepts[0] == accepts[1]
    pops = [[(t.node_id, t.pair, t.priority) for t in iter(q.pop, None)]
            for q in queues]
    assert pops[0] == pops[1]


def test_pairs_log_and_generator_match_reference(tmp_path):
    for mod, name in ((mapper, "port.log"), (ref, "ref.log")):
        log = mod.ExploredPairsLog(str(tmp_path / name))
        log.record(3, 1, 4, "+")
        log.record(3, 1, 4, "+")
        log.record(12, 2, 5, "-")
    port = (tmp_path / "port.log").read_text()
    assert port == (tmp_path / "ref.log").read_text()
    assert mapper.ExploredPairsLog(str(tmp_path / "ref.log")).has(12, 2, 5,
                                                                  "-")
    coords, z = _cluster(9, n=8, z=[6, 6, 8, 1, 1, 1, 1, 1])
    for kw in (dict(dist_lower_ang=0.3, dist_upper_ang=9.0, max_pairs=4,
                    include_negative_gamma=True, rng_seed=3),
               dict(dist_lower_ang=1.0, dist_upper_ang=3.0, max_pairs=10,
                    active_atoms=[1, 2, 4, 6], rng_seed=1)):
        got = mapper.PerturbationGenerator(**kw)
        want = ref.PerturbationGenerator(**kw)
        assert got.candidate_pairs(z, coords) == want.candidate_pairs(
            z, coords)
        for _ in range(3):
            assert got.generate(z, coords) == want.generate(z, coords)


def test_network_json_reads_both_ways(tmp_path):
    nodes = [np.random.default_rng(k).standard_normal((3, 3))
             for k in range(3)]
    for mod, name in ((mapper, "port.json"), (ref, "ref.json")):
        mod.Network([mod.EQNode(c, -1.0 - 0.01 * k)
                     for k, c in enumerate(nodes)],
                    [mod.TSEdge(0, 2, nodes[1], -0.95)]).save(
            str(tmp_path / name), symbols=["Ar"] * 3)
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()
    for reader, name in ((mapper, "ref.json"), (ref, "port.json")):
        net = reader.Network.load(str(tmp_path / name))
        assert [n.energy for n in net.nodes] == [-1.0, -1.01, -1.02]
        np.testing.assert_array_equal(net.nodes[2].coords, nodes[2])
        assert (net.edges[0].node_a, net.edges[0].node_b,
                net.edges[0].ts_energy) == (0, 2, -0.95)
    (tmp_path / "profile.txt").write_text(
        "# label, index, energy\nTS, 4, -0.5\nEndpoint_1, 0, -0.7\n")
    assert mapper.parse_profile(str(tmp_path / "profile.txt")) == \
        ref.parse_profile(str(tmp_path / "profile.txt"))


def _fields(cfg):
    """A MapperConfig as nested plain values, for comparing the packages'."""
    if dataclasses.is_dataclass(cfg):
        return {f.name: _fields(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [_fields(x) for x in cfg]
    return cfg


def test_mapper_config_from_v1_matches_reference():
    v1 = {
        "mapper_settings": {
            "temperature_K": 450.0, "rmsd_threshold": 0.25,
            "max_iterations": 7, "afir_gamma_kJmol": 80.0, "max_pairs": 3,
            "dist_lower_ang": 1.2, "dist_upper_ang": 4.5,
            "output_dir": "netmap", "rng_seed": 11, "active_atoms": [1, 2, 5],
            "include_negative_gamma": True, "excluded_node_ids": [2, 4],
            "exclude_bond_rearrangement": True, "use_rcmc": True,
            "rcmc_temperature_K": 500.0, "rcmc_reaction_time_s": 2.5,
            "rcmc_start_node_id": 1},
        "step2_settings": {"NSTEP": 25},
        "step3_settings": {"opt_method": ["rsirfo_block_bofill"],
                           "calc_exact_hess": 4},
    }
    for overrides in ({}, dict(temperature_k=600.0, seed=99, max_nodes=3)):
        got = _fields(mapper.mapper_config_from_v1(v1, **overrides))
        want = _fields(ref.mapper_config_from_v1(v1, **overrides))
        assert got == want


def test_afir_task_executor_matches_reference():
    z = np.full(3, 18)
    rng = np.random.default_rng(6)
    cb = _TRIMER[None] + 0.2 * rng.standard_normal((2, 3, 3))
    w1 = np.array([[1.0, 0, 0], [0, 1.0, 0]])
    w2 = np.array([[0, 1.0, 0], [0, 0, 1.0]])
    gam = np.array([30.0, -60.0])
    want = ref.make_afir_task_relax(RefLJ(), jnp.asarray(z), 12)(
        *(jnp.asarray(a) for a in (cb, w1, w2, gam)))
    got = mapper.make_afir_task_relax(LennardJones(device="cpu"), z, 12)(
        *(torch.as_tensor(a) for a in (cb, w1, w2, gam)))
    assert got[1].shape == (2, 3, 3, 3)
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() < 1e-10


def _lj_configs(mod, work_dir, batch_size):
    neb_cls, opt_cls, irc_cls, ats_cls, map_cls = (
        (NEBConfig, OptimizeConfig, IRCConfig, AutoTSConfig,
         mapper.MapperConfig) if mod is mapper else
        (RefNEBConfig, RefOptConfig, RefIRCConfig, RefAutoTSConfig,
         ref.MapperConfig))
    return map_cls(
        max_nodes=4, max_explorations=2, afir_gamma=30.0,
        dist_lower_ang=0.5, dist_upper_ang=9.0, queue="boltzmann",
        work_dir=str(work_dir), batch_size=batch_size, afir_steps=30,
        opt=opt_cls(method="rfo_fsb", nsteps=40),
        autots=ats_cls(
            n_images=6,
            neb=neb_cls(variant="cineb", n_steps=15, k_spring=5e-4,
                        climbing_start=8, dt0=0.05, dt_max=0.4),
            saddle=opt_cls(method="rfo_bofill", saddle_order=1, nsteps=30,
                           fc_count=5, init_hessian="exact"),
            irc=irc_cls(n_steps=15),
            endpoint_opt=opt_cls(method="rfo_fsb", nsteps=40)))


def test_map_network_lj_trimer_matches_reference(tmp_path):
    batch_size = 1
    z = np.full(3, 18)
    want = ref.map_network(RefLJ(), jnp.asarray(_TRIMER), jnp.asarray(z),
                           _lj_configs(ref, tmp_path / "ref", batch_size))
    got = mapper.map_network(
        LennardJones(device="cpu"), torch.as_tensor(_TRIMER), z,
        _lj_configs(mapper, tmp_path / "port", batch_size), device="cpu")
    assert got.skipped == {}
    assert len(got.nodes) == len(want.nodes)
    assert len(got.edges) == len(want.edges)
    for g, w in zip(got.nodes, want.nodes):
        assert abs(g.energy - w.energy) <= 1e-10
        assert np.abs(g.coords - np.asarray(w.coords)).max() <= 1e-8
    for g, w in zip(got.edges, want.edges):
        assert (g.node_a, g.node_b) == (w.node_a, w.node_b)
        assert abs(g.ts_energy - w.ts_energy) <= 1e-10
    assert (tmp_path / "port" / "explored_pairs.log").read_text() == \
        (tmp_path / "ref" / "explored_pairs.log").read_text()
    # the restart reads the persisted network
    again = mapper.map_network(
        LennardJones(device="cpu"), torch.as_tensor(_TRIMER), z,
        dataclasses.replace(_lj_configs(mapper, tmp_path / "port",
                                        batch_size), max_explorations=0),
        device="cpu")
    assert len(again.nodes) == len(got.nodes)


def test_task_errors_are_narrowed(tmp_path, monkeypatch):
    z = np.full(3, 18)
    cfg = _lj_configs(mapper, tmp_path, 1)

    def cuda_fault(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(mapper, "autots", cuda_fault)
    with pytest.raises(RuntimeError, match="CUDA error"):
        mapper.map_network(LennardJones(device="cpu"),
                           torch.as_tensor(_TRIMER), z, cfg, device="cpu")

    def undoable(*args, **kwargs):
        raise ValueError("give product_coords or AFIR fragments")

    monkeypatch.setattr(mapper, "autots", undoable)
    net = mapper.map_network(
        LennardJones(device="cpu"), torch.as_tensor(_TRIMER), z,
        dataclasses.replace(cfg, work_dir=str(tmp_path / "b")), device="cpu")
    assert net.skipped == {"ValueError": 2}
    assert len(net.nodes) == 1
    with pytest.raises(NotImplementedError, match="item 17"):
        mapper.map_network(LennardJones(device="cpu"),
                           torch.as_tensor(_TRIMER), z, cfg, mesh=object(),
                           device="cpu")


def test_absorbed_results_grow_the_same_network(tmp_path, monkeypatch):
    """Each package's AutoTS replaced by the same canned answer (the task's
    start as one end, the start pushed apart along the task's pair as the
    other, a TS between them): map_network, with the batched AFIR executor
    (batch_size 2) in front, absorbs the ends into the same nodes and
    edges, and seeds the same new tasks."""
    z = np.full(3, 18)

    def canned(mod, to_host):
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

    canned(ref, np.asarray)
    canned(mapper, lambda x: x.numpy())
    kw = dict(max_nodes=6, max_explorations=5, queue="rcmc")
    want = ref.map_network(RefLJ(), jnp.asarray(_TRIMER), jnp.asarray(z),
                           dataclasses.replace(
                               _lj_configs(ref, tmp_path / "ref", 2), **kw))
    batches = []
    got = mapper.map_network(LennardJones(device="cpu"),
                             torch.as_tensor(_TRIMER), z,
                             dataclasses.replace(
                                 _lj_configs(mapper, tmp_path / "port", 2),
                                 **kw), device="cpu",
                             stage_hook=lambda name, **d: batches.append(d))
    assert batches and batches[0]["trajs"].shape[:2] == (2, 6)
    assert len(got.nodes) > 2 and len(got.edges) > 1
    assert [n.energy for n in got.nodes] == pytest.approx(
        [n.energy for n in want.nodes], rel=0, abs=1e-10)
    assert [(e.node_a, e.node_b) for e in got.edges] == \
        [(e.node_a, e.node_b) for e in want.edges]
    assert (tmp_path / "port" / "explored_pairs.log").read_text() == \
        (tmp_path / "ref" / "explored_pairs.log").read_text()
