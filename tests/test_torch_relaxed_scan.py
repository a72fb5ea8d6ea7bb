"""Port parity: multioptpy_tpu_torch.workflows.relaxed_scan against the
JAX package: a bond scan and a two-target scan with -fo on an Ar4 cluster
(Lennard-Jones), and a bond scan of the open-shell H2O+ cation on SQM2,
the energies to 1e-10 Ha and the geometries to 1e-8 Bohr."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.calculators import LennardJones as RefLJ
from multioptpy_tpu.calculators.sqm import SQM2 as RefSQM2
from multioptpy_tpu.drivers.optimize import OptimizeConfig as RefOptConfig
from multioptpy_tpu.periodic import UFF_VDW_R
from multioptpy_tpu_torch import workflows
from multioptpy_tpu_torch.calculators.lj import LennardJones
from multioptpy_tpu_torch.calculators.sqm import SQM2
from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig

# the packages' `workflows.relaxed_scan` attribute is the function, which
# shadows the submodule
ref = importlib.import_module("multioptpy_tpu.workflows.relaxed_scan")
relaxed_scan = importlib.import_module(
    "multioptpy_tpu_torch.workflows.relaxed_scan")

torch.set_num_threads(1)

_R = float(UFF_VDW_R[18])
_AR4 = np.array([[0.0, 0.0, 0.0], [_R, 0.1, 0.0], [_R / 2, _R * 0.866, 0.2],
                 [_R / 2, _R * 0.289, _R * 0.816]])
_H2O = np.array([[0.0, 0.0, 0.2217], [0.0, 1.43, -0.8867],
                 [0.0, -1.43, -0.8867]])


def _assert_same(got, want):
    np.testing.assert_allclose(got.values, want.values, rtol=0, atol=1e-14)
    assert np.abs(got.energies - want.energies).max() <= 1e-10
    assert np.abs(got.geometries - np.asarray(want.geometries)).max() <= 1e-8
    np.testing.assert_array_equal(got.converged, want.converged)


def test_bond_scan_matches_reference():
    z = np.full(4, 18)
    want = ref.relaxed_scan(RefLJ(), jnp.asarray(_AR4), jnp.asarray(z),
                            "bond", [1, 2], 3.6, 4.4, 4,
                            config=RefOptConfig(nsteps=30))
    got = relaxed_scan.relaxed_scan(LennardJones(device="cpu"),
                                    torch.as_tensor(_AR4), z, "bond", [1, 2],
                                    3.6, 4.4, 4,
                                    config=OptimizeConfig(nsteps=30),
                                    device="cpu")
    _assert_same(got, want)
    # the package attribute is the function, as in the reference
    assert workflows.relaxed_scan is relaxed_scan.relaxed_scan
    with pytest.raises(ValueError, match="unknown scan kind"):
        relaxed_scan.relaxed_scan(LennardJones(device="cpu"),
                                  torch.as_tensor(_AR4), z, "torsion",
                                  [1, 2], 1.0, 2.0, 2, device="cpu")


def test_multi_target_scan_first_only_matches_reference():
    z = np.full(4, 18)
    targets = [("bond", [1, 2], 3.6, 4.2), ("angle", [1, 2, 3], 55.0, 65.0)]
    want = ref.relaxed_scan_multi(RefLJ(), jnp.asarray(_AR4), jnp.asarray(z),
                                  targets, 3, config=RefOptConfig(nsteps=30),
                                  first_only=True)
    got = relaxed_scan.relaxed_scan_multi(
        LennardJones(device="cpu"), torch.as_tensor(_AR4), z, targets, 3,
        config=OptimizeConfig(nsteps=30), first_only=True, device="cpu")
    assert got.values.shape == (3, 2)
    _assert_same(got, want)


def test_sqm2_cation_bond_scan_matches_reference():
    z = np.array([8, 1, 1])
    want = ref.relaxed_scan(RefSQM2(charge=1, multiplicity=2),
                            jnp.asarray(_H2O), jnp.asarray(z), "bond",
                            [1, 2], 0.95, 1.05, 2,
                            config=RefOptConfig(nsteps=3))
    got = relaxed_scan.relaxed_scan(
        SQM2(charge=1, multiplicity=2, device="cpu"), torch.as_tensor(_H2O),
        z, "bond", [1, 2], 0.95, 1.05, 2, config=OptimizeConfig(nsteps=3),
        device="cpu")
    _assert_same(got, want)
