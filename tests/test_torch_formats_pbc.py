"""Port parity: io/formats.py, pbc.py and analysis/visualization.py of
multioptpy_tpu_torch against the JAX package. Each input format (Gaussian .gjf/.com, MDL .mol, Tripos
.mol2, GAMESS/ORCA/Q-Chem .inp, and .xyz through read_any) gives the same
symbols, charge and multiplicity exactly and coordinates to 1e-12
Angstrom; an unrecognized .inp raises in both. The minimum-image helpers
agree to 1e-12 Bohr on orthorhombic and triclinic cells, with
displacements of exactly half a cell rounded half to even in both. The
three plots write the same CSVs (exactly) and a PNG each (where
matplotlib is installed)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu import pbc as ref_pbc
from multioptpy_tpu.io import formats as ref_fmt
from multioptpy_tpu_torch import pbc
from multioptpy_tpu_torch.io import formats

torch.set_num_threads(1)

_ATOMS = [("O", 0.0, 0.0, 0.1173), ("H", 0.0, 0.7572, -0.4692),
          ("H", 0.0, -0.7572, -0.4692)]


def _rows(fmt="{:s} {:.6f} {:.6f} {:.6f}"):
    return "\n".join(fmt.format(*a) for a in _ATOMS)


_FILES = {
    "w.gjf": "%chk=w\n# opt b3lyp\n\nwater\n\n1 2\n" + _rows() + "\n\n",
    "w.com": "# hf\n\ntitle\n\n0 1\n" + _rows() + "\n",
    "w.mol": "water\n  program\n\n  3  2  0  0  0  0  0  0  0  0999 V2000\n"
             + "\n".join(f"{x:10.4f}{y:10.4f}{z:10.4f} {s:<3} 0  0"
                         for s, x, y, z in _ATOMS)
             + "\nM  END\n",
    "w.mol2": "@<TRIPOS>MOLECULE\nwater\n@<TRIPOS>ATOM\n"
              + "\n".join(f"{i + 1} {s}{i + 1} {x} {y} {z} {s}.3 1 UNL 0.0"
                          for i, (s, x, y, z) in enumerate(_ATOMS))
              + "\n@<TRIPOS>BOND\n1 1 2 1\n",
    "gamess.inp": " $CONTRL RUNTYP=OPTIMIZE $END\n $DATA\nwater\nC1\n"
                  + "\n".join(f"{s} 8.0 {x} {y} {z}" for s, x, y, z in _ATOMS)
                  + "\n $END\n",
    "orca.inp": "! B3LYP def2-SVP\n* xyz -1 2\n" + _rows() + "\n*\n",
    "qchem.inp": "$molecule\n0 3\n" + _rows() + "\n$end\n",
    "w.xyz": "3\nwater\n" + _rows() + "\n",
}


@pytest.mark.parametrize("name", list(_FILES))
def test_read_any_matches_reference(name, tmp_path):
    path = tmp_path / name
    path.write_text(_FILES[name])
    s_ref, c_ref, q_ref, m_ref = ref_fmt.read_any(str(path))
    s, c, q, m = formats.read_any(str(path))
    assert list(s) == list(s_ref) and len(s) == 3
    assert (q, m) == (q_ref, m_ref)
    np.testing.assert_allclose(c, np.asarray(c_ref), rtol=0, atol=1e-12)


def test_unrecognized_inputs_raise_in_both(tmp_path):
    bad = tmp_path / "x.inp"
    bad.write_text("nothing here\n")
    for mod in (ref_fmt, formats):
        with pytest.raises(ValueError):
            mod.read_inp(str(bad))
    bad = tmp_path / "x.gjf"
    bad.write_text("# hf\n\ntitle\n")
    for mod in (ref_fmt, formats):
        with pytest.raises(ValueError):
            mod.read_gjf(str(bad))


@pytest.mark.parametrize("cell", [np.diag([10.0, 12.0, 9.0]),
                                  np.array([[10.0, 0.0, 0.0],
                                            [3.0, 11.0, 0.0],
                                            [1.0, 2.0, 9.5]])])
def test_minimum_image_helpers_match_reference(cell):
    rng = np.random.default_rng(2)
    x = rng.uniform(-25.0, 25.0, (7, 3))
    d = np.concatenate([rng.uniform(-20.0, 20.0, (5, 3)),
                        0.5 * cell[:1], -1.5 * cell[1:2]])   # ties
    np.testing.assert_allclose(
        pbc.wrap_coordinates(torch.as_tensor(x), cell).numpy(),
        np.asarray(ref_pbc.wrap_coordinates(jnp.asarray(x), cell)),
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        pbc.minimum_image_displacement(torch.as_tensor(d), cell).numpy(),
        np.asarray(ref_pbc.minimum_image_displacement(jnp.asarray(d), cell)),
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        pbc.pairwise_distances_pbc(torch.as_tensor(x), cell).numpy(),
        np.asarray(ref_pbc.pairwise_distances_pbc(jnp.asarray(x), cell)),
        rtol=0, atol=1e-12)


def test_plots_write_the_reference_csvs(tmp_path):
    pytest.importorskip("matplotlib")
    from multioptpy_tpu.analysis import visualization as ref_vis
    from multioptpy_tpu_torch.analysis import visualization as vis

    rng = np.random.default_rng(6)
    e = -5.4 + 0.01 * rng.random(7)
    bands = -5.4 + 0.02 * rng.random((3, 6))
    for mod, tag in ((ref_vis, "ref"), (vis, "port")):
        d = tmp_path / tag
        d.mkdir()
        mod.plot_energy_profile(e, str(d / "e.png"), csv_path=str(d / "e.csv"))
        mod.plot_neb_band(bands, str(d / "b.png"), csv_path=str(d / "b.csv"))
        mod.plot_reaction_profile(e[:3], ["R", "TS", "P"], str(d / "r.png"))
    for name in ("e.csv", "b.csv"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "ref" / name).read_text()
    for name in ("e.png", "b.png", "r.png"):
        assert (tmp_path / "port" / name).read_bytes()[:4] == b"\x89PNG"
