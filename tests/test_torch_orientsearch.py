"""Port parity: multioptpy_tpu_torch.workflows.orientsearch against the
JAX package on an Ar4 cluster (Lennard-Jones): the same numpy draws give
the same placements (to 1e-14 Bohr), with and without -dist, and the same
energy-sorted optimized batch. The batched relaxation of a loosely placed
fragment amplifies rounding, so energies and geometries are held to 1e-10
Ha and 1e-8 Bohr or to ten times how far the port itself moves when its
placements are perturbed by 1e-14 Bohr (the witness), if that is
larger; the witness must stay within 1e-8 Ha and 1e-6 Bohr. (The draws
of seed 3 place the fragment where 30 steps do not branch: from those of
seed 2 at 4 Angstrom, 1e-14 Bohr moves the result 0.1 Bohr.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.calculators import LennardJones as RefLJ
from multioptpy_tpu.drivers.optimize import OptimizeConfig as RefOptConfig
from multioptpy_tpu.periodic import UFF_VDW_R
from multioptpy_tpu.workflows import orientsearch as ref
from multioptpy_tpu_torch.calculators.lj import LennardJones
from multioptpy_tpu_torch.drivers.optimize import (OptimizeConfig,
                                                   optimize_batch)
from multioptpy_tpu_torch.workflows import orientsearch

torch.set_num_threads(1)

_R = float(UFF_VDW_R[18])
_AR4 = np.array([[0.0, 0.0, 0.0], [_R, 0.1, 0.0], [_R / 2, _R * 0.866, 0.2],
                 [_R / 2, _R * 0.289, _R * 0.816]])
_Z = np.full(4, 18)


def test_random_rotation_matches_reference():
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(4):
        np.testing.assert_array_equal(orientsearch._random_rotation(a),
                                      ref._random_rotation(b))


@pytest.mark.parametrize("distance", [None, 4.0])
def test_orientation_search_matches_reference(distance):
    kw = dict(n_samples=6, n_opt_steps=30, seed=3, distance_ang=distance)
    want = ref.orientation_search(RefLJ(), jnp.asarray(_AR4),
                                  jnp.asarray(_Z), [3, 4],
                                  config=RefOptConfig(), **kw)
    calc = LennardJones(device="cpu")
    got = orientsearch.orientation_search(calc, torch.as_tensor(_AR4), _Z,
                                          [3, 4], config=OptimizeConfig(),
                                          device="cpu", **kw)
    assert np.all(np.diff(got.energies) >= 0)
    # the witness: the same batch from placements moved by 1e-14 Bohr
    starts = orientsearch.orientation_samples(_AR4, [3, 4], 6, 2.0, 3,
                                              distance)
    moved = starts + 1e-14 * np.random.default_rng(0).standard_normal(
        starts.shape)
    base, wit = (optimize_batch(calc, x, _Z, config=OptimizeConfig(),
                                n_steps=30, device="cpu") for x in (starts,
                                                                    moved))
    w_e = (wit.energy - base.energy).abs().max().item()
    w_x = (wit.coords - base.coords).abs().max().item()
    assert w_e <= 1e-8 and w_x <= 1e-6
    tol_e, tol_x = max(1e-10, 10 * w_e), max(1e-8, 10 * w_x)
    assert np.abs(got.energies - want.energies).max() <= tol_e
    assert np.abs(got.geometries - np.asarray(want.geometries)).max() <= tol_x
    # the port's search is that batch, sorted by energy
    order = np.argsort(base.energy.numpy())
    np.testing.assert_array_equal(got.energies, base.energy.numpy()[order])
