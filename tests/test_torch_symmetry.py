"""Port parity: analysis/symmetry.py of multioptpy_tpu_torch against the
JAX package: the same point group, symmetry number and linearity (equal
results) on water, HCN, the S8 crown, the Diels-Alder reactant, n-octane,
an atom, a slightly distorted S8 crown and an Oh octahedron; the errors a
degenerate input raises are the ones `optmain` reports (SYMMETRY_ERRORS)."""

import pathlib

import numpy as np
import pytest

from multioptpy_tpu.analysis.symmetry import analyze_symmetry as ref_analyze
from multioptpy_tpu_torch.analysis.symmetry import (SYMMETRY_ERRORS,
                                                    analyze_symmetry)
from multioptpy_tpu_torch.io import fixtures
from multioptpy_tpu_torch.io.xyz import read_xyz
from multioptpy_tpu_torch.periodic import symbols_to_z
from multioptpy_tpu_torch.units import ANGSTROM2BOHR


def _hcn():
    sym, c = read_xyz(pathlib.Path(__file__).resolve().parent.parent
                      / "examples" / "ab" / "hcn.xyz")
    return c * ANGSTROM2BOHR, np.asarray(symbols_to_z(sym))


def _octahedron():
    d = 3.0
    c = np.array([[0, 0, 0], [d, 0, 0], [-d, 0, 0], [0, d, 0], [0, -d, 0],
                  [0, 0, d], [0, 0, -d]], float)
    return c, np.array([16, 9, 9, 9, 9, 9, 9])


def _distorted_s8():
    c, z = fixtures.s8_crown()
    return c + 0.01 * np.random.default_rng(5).standard_normal(c.shape), z


_SYSTEMS = {
    "water": lambda: (np.array([[0.0, 0.0, 0.12], [0.0, 1.45, -0.93],
                                [0.0, -1.45, -0.93]]), np.array([8, 1, 1])),
    "hcn": _hcn,
    "s8": fixtures.s8_crown,
    "diels_alder": fixtures.diels_alder_reactant,
    "n_octane": lambda: fixtures.alkane_chain(8),
    "atom": lambda: (np.zeros((1, 3)), np.array([18])),
    "s8_distorted": _distorted_s8,
    "octahedron": _octahedron,
}


@pytest.mark.parametrize("name", list(_SYSTEMS))
def test_point_group_matches_reference(name):
    c, z = _SYSTEMS[name]()
    got = analyze_symmetry(c, z)
    assert got == ref_analyze(np.asarray(c), np.asarray(z))
    assert str(got) == str(ref_analyze(np.asarray(c), np.asarray(z)))


def test_degenerate_input_raises_a_symmetry_error():
    c = np.array([[0.0, 0.0, 0.0], [np.nan, 0.0, 1.0], [1.0, 0.0, 0.0]])
    with pytest.raises(SYMMETRY_ERRORS):
        analyze_symmetry(c, np.array([8, 1, 1]))
