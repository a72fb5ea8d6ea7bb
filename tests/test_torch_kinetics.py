"""Port parity: multioptpy_tpu_torch.workflows.kinetics against the JAX
package's copy on a random 6-node network (numpy only): every function to
1e-12 relative."""

import numpy as np
import pytest
import torch

from multioptpy_tpu.workflows import kinetics as ref
from multioptpy_tpu.workflows.mapper import (EQNode as RefEQNode,
                                             Network as RefNetwork,
                                             TSEdge as RefTSEdge)
from multioptpy_tpu_torch.workflows import kinetics
from multioptpy_tpu_torch.workflows.mapper import EQNode, Network, TSEdge

torch.set_num_threads(1)


def _networks(seed=3, m=6):
    rng = np.random.default_rng(seed)
    energies = rng.uniform(-0.02, 0.0, m)
    pairs = [(0, 1), (1, 2), (2, 3), (1, 4), (4, 5), (0, 5), (3, 5)]
    ts = [max(energies[a], energies[b]) + rng.uniform(0.005, 0.03)
          for a, b in pairs]
    x = np.zeros((2, 3))
    nets = []
    for node, edge, net in ((RefEQNode, RefTSEdge, RefNetwork),
                            (EQNode, TSEdge, Network)):
        nets.append(net(nodes=[node(x, float(e)) for e in energies],
                        edges=[edge(a, b, x, float(t))
                               for (a, b), t in zip(pairs, ts)]))
    return nets


def _rel(got, want):
    want = np.asarray(want, dtype=float)
    return np.abs(np.asarray(got, dtype=float) - want).max() \
        / max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("temperature", [250.0, 300.0, 1200.0])
def test_rates_and_populations_match_reference(temperature):
    ref_net, net = _networks()
    assert _rel(kinetics.eyring_rate(np.linspace(-0.01, 0.05, 7),
                                     temperature),
                ref.eyring_rate(np.linspace(-0.01, 0.05, 7),
                                temperature)) < 1e-12
    k_ref = ref.rate_matrix(ref_net, temperature)
    k = kinetics.rate_matrix(net, temperature)
    assert _rel(k, k_ref) < 1e-12
    p0 = np.eye(len(net.nodes))[0]
    for t in (1e-9, 1e-3, 1.0):
        assert _rel(kinetics.populations(k, p0, t),
                    ref.populations(k_ref, p0, t)) < 1e-12
    assert _rel(kinetics.kinetic_priorities(net, temperature, 1e-3, 2),
                ref.kinetic_priorities(ref_net, temperature, 1e-3,
                                       2)) < 1e-12


@pytest.mark.parametrize("time_scale", [1e-12, 1e-6, 1.0])
def test_rcmc_contraction_matches_reference(time_scale):
    ref_net, net = _networks(seed=7)
    k = kinetics.rate_matrix(net, 300.0)
    got = kinetics.rcmc_contract(k, time_scale)
    want = ref.rcmc_contract(ref.rate_matrix(ref_net, 300.0), time_scale)
    assert got.superstates == want.superstates
    np.testing.assert_array_equal(got.slow_indices, want.slow_indices)
    assert _rel(got.contracted_rates, want.contracted_rates) < 1e-12


def test_priorities_of_small_networks():
    x = np.zeros((2, 3))
    assert kinetics.kinetic_priorities(Network([], [])).shape == (0,)
    lone = Network([EQNode(x, -1.0), EQNode(x, -0.5)], [])
    np.testing.assert_array_equal(kinetics.kinetic_priorities(lone),
                                  [0.5, 0.5])
