"""Port parity: the chain Z-matrix and the local force constants of
multioptpy_tpu_torch.coords.internals against the JAX package (1e-12
relative), on a perturbed aldol reactant with its Swart model Hessian."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.coords import internals as ref_ic
from multioptpy_tpu.hessian import model as ref_model
from multioptpy_tpu_torch.coords import internals as ic
from multioptpy_tpu_torch.io.fixtures import aldol_reactant

torch.set_num_threads(1)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("n_atoms", [1, 2, 3, 4, 11])
def test_z_matrix_matches_reference(n_atoms):
    coords, _ = aldol_reactant()
    rng = np.random.default_rng(n_atoms)
    x = coords[:n_atoms] + 0.1 * rng.standard_normal((n_atoms, 3))
    want = np.asarray(ref_ic.cartesian_to_z_matrix(jnp.asarray(x)))
    got = ic.cartesian_to_z_matrix(torch.as_tensor(x))
    assert got.shape == want.shape
    if want.size:
        assert _rel(got.numpy(), want) < 1e-12


def test_local_force_constants_match_reference():
    coords, z = aldol_reactant()
    x = coords + 0.03 * np.random.default_rng(1).standard_normal(coords.shape)
    prims = ref_ic.detect_primitives(x, z)
    b = np.asarray(ref_ic.InternalCoordinates(*prims, len(z)).b_matrix(
        jnp.asarray(x)))
    h = np.asarray(ref_model.model_hessian(jnp.asarray(x), z, kind="swart"))
    for method in ("compliance", "projection"):
        want = ref_ic.local_force_constants(jnp.asarray(h), jnp.asarray(b),
                                            method)
        got = ic.local_force_constants(torch.as_tensor(h),
                                       torch.as_tensor(b), method)
        assert _rel(got.numpy(), want) < 1e-10, method
    with pytest.raises(ValueError, match="compliance"):
        ic.local_force_constants(torch.as_tensor(h), torch.as_tensor(b),
                                 "inverse")
