"""Kinetics-guided exploration: rate constants, RCMC contraction, populations.

ref: multioptpy/Utils/rcmc.py:26 RCMCQueue — the mapper's kinetics-driven
priority queue: Eyring rate constants over the current EQ/TS network, a
rate-constant-matrix-contraction (RCMC) step that lumps fast-equilibrating
states into super-states (K-matrix :58), and steady populations (:135) that
prioritize which node to explore next.

Here the numerics are standalone pure functions over a `Network` (from
workflows.mapper); `kinetic_priorities` plugs them into the mapper loop.
Counterpart of `multioptpy_tpu/workflows/kinetics.py` (numpy only; the
port keeps its own copy).
"""

from typing import NamedTuple

import numpy as np

from multioptpy_tpu_torch.units import KB_HARTREE, PLANCK_J_S, HARTREE2J


def eyring_rate(barrier_hartree, temperature=300.0):
    """k = (kB T / h) exp(-dG^/kB T), barrier in Hartree -> 1/s."""
    kt = KB_HARTREE * temperature
    prefactor = KB_HARTREE * HARTREE2J * temperature / PLANCK_J_S
    return prefactor * np.exp(-np.maximum(barrier_hartree, 0.0) / kt)


def rate_matrix(network, temperature=300.0):
    """(M, M) first-order rate matrix K: K[j, i] = rate i->j from the TS
    edges; diagonal = -sum of outflows (ref: rcmc.py K-matrix :58)."""
    m = len(network.nodes)
    k = np.zeros((m, m))
    for e in network.edges:
        ea = network.nodes[e.node_a].energy
        eb = network.nodes[e.node_b].energy
        k_ab = eyring_rate(e.ts_energy - ea, temperature)  # a -> b
        k_ba = eyring_rate(e.ts_energy - eb, temperature)  # b -> a
        k[e.node_b, e.node_a] += k_ab
        k[e.node_a, e.node_b] += k_ba
    np.fill_diagonal(k, 0.0)
    np.fill_diagonal(k, -k.sum(axis=0))
    return k


class RCMCResult(NamedTuple):
    contracted_rates: np.ndarray    # (S, S) super-state rate matrix
    superstates: list               # list of member-index lists
    slow_indices: np.ndarray


def rcmc_contract(k_matrix, time_scale=1.0):
    """Rate-constant matrix contraction: states whose escape rate exceeds
    1/time_scale are lumped into the super-state of their fastest sink
    (simplified Sumiya-Maeda contraction; ref: rcmc.py)."""
    m = k_matrix.shape[0]
    escape = -np.diag(k_matrix)
    fast = escape > 1.0 / max(time_scale, 1e-300)

    # union-find lumping of fast states into their dominant product state
    parent = list(range(m))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in np.where(fast)[0]:
        off = k_matrix[:, i].copy()
        off[i] = -np.inf
        j = int(np.argmax(off))
        if off[j] > 0:
            parent[find(i)] = find(j)

    roots = sorted({find(i) for i in range(m)})
    superstates = [[i for i in range(m) if find(i) == r] for r in roots]
    s = len(roots)
    d = np.zeros((s, s))
    for a, mem_a in enumerate(superstates):
        for b, mem_b in enumerate(superstates):
            if a == b:
                continue
            d[b, a] = sum(k_matrix[j, i] for i in mem_a for j in mem_b)
    np.fill_diagonal(d, -d.sum(axis=0))
    return RCMCResult(contracted_rates=d, superstates=superstates,
                      slow_indices=np.asarray(roots))


def populations(k_matrix, p0, t):
    """p(t) = expm(K t) p0 via eigen-decomposition (ref: rcmc.py :135)."""
    w, v = np.linalg.eig(k_matrix)
    vinv = np.linalg.pinv(v)
    return np.real(v @ (np.exp(w * t) * (vinv @ p0)))


def kinetic_priorities(network, temperature=300.0, reaction_time=1.0,
                       start_node=0):
    """Exploration priority per node: population reachable from the start
    node after `reaction_time` seconds — under-explored but kinetically
    accessible nodes rank first (ref: rcmc.py pop())."""
    m = len(network.nodes)
    if m == 0:
        return np.zeros(0)
    if not network.edges:
        return np.ones(m) / m
    k = rate_matrix(network, temperature)
    p0 = np.zeros(m)
    p0[start_node] = 1.0
    p = np.clip(populations(k, p0, reaction_time), 0.0, None)
    total = p.sum()
    return p / total if total > 0 else np.ones(m) / m
