"""Port parity: the O(1)-gradient seminumerical Hessians of
multioptpy_tpu_torch.hessian.o1numhess against the JAX package on SQM2:
the probe-and-project variant with given probe directions on HCN+, and
the published algorithm's pieces and whole on the same cation, 1e-10
relative (measured 1.9e-12 and 8.7e-13)."""

import jax.numpy as jnp
import numpy as np
import torch

from multioptpy_tpu.calculators import sqm as ref_sqm
from multioptpy_tpu.hessian import o1numhess as ref
from multioptpy_tpu_torch.calculators import sqm
from multioptpy_tpu_torch.hessian import o1numhess

torch.set_num_threads(1)

_ANG = 1.8897261254578281
_HCN = np.array([[0.0, 0.0, 0.0], [0.0, 0.05, 1.18], [1.0, 0.1, -0.6]]) * _ANG
_Z = np.array([6, 7, 1])


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def test_probe_and_project_matches_reference():
    rng = np.random.default_rng(0)
    dirs = rng.standard_normal((4, 9))
    want = ref.o1numhess(ref_sqm.SQM2(charge=1), jnp.asarray(_HCN), _Z,
                         n_probes=4, directions=dirs)
    got = o1numhess.o1numhess(sqm.SQM2(charge=1, device="cpu"),
                              torch.as_tensor(_HCN), _Z, n_probes=4,
                              directions=dirs)
    assert got.shape == (9, 9)
    assert _rel(got.numpy(), want) < 1e-10


def test_published_algorithm_matches_reference():
    coords = _HCN
    dist, cutoff = o1numhess._adaptive_cutoffs(coords, _Z, 2.5)
    rd, rc = ref._adaptive_cutoffs(coords, _Z, 2.5)
    np.testing.assert_array_equal(cutoff, rc)
    adj = o1numhess._atom_adjacency(dist, cutoff)
    np.testing.assert_array_equal(adj, ref._atom_adjacency(rd, rc))
    want = ref.o1numhess_full(ref_sqm.SQM2(charge=1), jnp.asarray(coords), _Z)
    got = o1numhess.o1numhess_full(sqm.SQM2(charge=1, device="cpu"),
                                   torch.as_tensor(coords), _Z)
    assert got.shape == (9, 9) and got.dtype == torch.float64
    assert _rel(got.numpy(), want) < 1e-10
    # a far fragment bridges through the minimum spanning tree
    far = np.concatenate([coords, coords + 40.0])
    z2 = np.concatenate([_Z, _Z])
    d2, c2 = o1numhess._adaptive_cutoffs(far, z2, 2.5)
    np.testing.assert_array_equal(o1numhess._atom_adjacency(d2, c2),
                                  ref._atom_adjacency(d2, c2))
