"""Port parity: analysis/vibrations.py of multioptpy_tpu_torch against the
JAX package, both fed the same Hessian (numpy): normal modes (up to a sign
per mode; degenerate modes by their subspace projector, on the S8 crown),
the mode metadata, normal_modes.txt and the animation files (numbers
compared after the same per-mode sign normalization, to half a unit of
the last printed digit), rotational constants and RRHO thermochemistry of
a bent and a linear molecule.

Tolerances: frequencies 1e-6 cm^-1 (|freq| > 10; the TR/rot residue
below 1 cm^-1 in both), modes and metadata 1e-9 relative, RRHO 1e-10 Ha
(entropy 1e-12 Ha/K), rotational constants 1e-10 relative."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.analysis import vibrations as ref
from multioptpy_tpu.io.fixtures import s8_crown
from multioptpy_tpu_torch.analysis import vibrations as vib
from multioptpy_tpu_torch.calculators.lj import LennardJones
from multioptpy_tpu_torch.calculators.sqm import SQM2
from multioptpy_tpu_torch.io.xyz import read_xyz
from multioptpy_tpu_torch.periodic import symbols_to_z
from multioptpy_tpu_torch.units import ANGSTROM2BOHR

torch.set_num_threads(1)

_WATER = (np.array([[0.0, 0.0, 0.12], [0.0, 1.45, -0.93],
                    [0.0, -1.43, -0.9]]), np.array([8, 1, 1]))


def _hcn():
    sym, c = read_xyz(pathlib.Path(__file__).resolve().parent.parent
                      / "examples" / "ab" / "hcn.xyz")
    return c * ANGSTROM2BOHR, np.asarray(symbols_to_z(sym))


def _hessian(calc, coords, z):
    x = torch.as_tensor(coords, dtype=torch.float64)[None]
    return calc.hessian(x, z)[0].numpy()


@pytest.fixture(scope="module")
def systems():
    """name -> (coords Bohr, z, Hessian): the water cation and HCN on the
    port's SQM2, the S8 crown on Lennard-Jones (D4d: degenerate pairs)."""
    out = {}
    for name, (c, z) in (("water", _WATER), ("hcn", _hcn())):
        out[name] = (c, z, _hessian(SQM2(charge=1, multiplicity=2,
                                         device="cpu"), c, z))
    c, z = s8_crown()
    out["s8"] = (c, z, _hessian(LennardJones(device="cpu"), c, z))
    return out


def _pair(c, z, h):
    # compiled: the reference's eager normal_modes costs seconds a shape
    nm_ref = jax.jit(ref.normal_modes)(jnp.asarray(h), jnp.asarray(c),
                                       jnp.asarray(z))
    nm = vib.normal_modes(torch.as_tensor(h), torch.as_tensor(c), z)
    return nm_ref, nm


def _blocks(freqs, tol=1e-3):
    """Index groups of (near-)equal frequencies."""
    order = np.argsort(freqs)
    groups, cur = [], [order[0]]
    for i in order[1:]:
        if abs(freqs[i] - freqs[cur[-1]]) < tol * max(1.0, abs(freqs[i])):
            cur.append(i)
        else:
            groups.append(cur)
            cur = [i]
    return groups + [cur]


@pytest.mark.parametrize("name", ["water", "hcn", "s8"])
def test_normal_modes_match_reference(systems, name):
    c, z, h = systems[name]
    nm_ref, nm = _pair(c, z, h)
    f_ref = np.asarray(nm_ref.frequencies_cm1)
    f = nm.frequencies_cm1.numpy()
    vibr = np.abs(f_ref) > 10.0
    np.testing.assert_array_equal(np.abs(f) > 10.0, vibr)
    np.testing.assert_allclose(f[vibr], f_ref[vibr], rtol=0, atol=1e-6)
    assert np.abs(f[~vibr]).max() < 1.0
    m_ref = np.asarray(nm_ref.modes).reshape(len(f), -1)
    m = nm.modes.numpy().reshape(len(f), -1)
    scale = np.abs(m_ref).max()
    for grp in _blocks(f_ref):
        if not vibr[grp[0]]:
            continue
        a, b = m_ref[grp], m[grp]
        # the Cartesian modes of one frequency span the same subspace
        pa = a.T @ np.linalg.pinv(a.T)
        pb = b.T @ np.linalg.pinv(b.T)
        np.testing.assert_allclose(pb, pa, rtol=0, atol=1e-9)
        if len(grp) == 1:
            sign = np.sign(a[0] @ b[0])
            np.testing.assert_allclose(sign * b[0], a[0], rtol=0,
                                       atol=1e-9 * scale)
    if name == "s8":
        assert any(len(g) == 2 for g in _blocks(f_ref) if vibr[g[0]])
    assert vib.count_imaginary(nm.frequencies_cm1) == \
        ref.count_imaginary(nm_ref.frequencies_cm1)


@pytest.mark.parametrize("name", ["water", "s8"])
def test_mode_metadata_matches_reference(systems, name):
    c, z, h = systems[name]
    nm_ref, nm = _pair(c, z, h)
    for imag in (True, False):
        a = ref.mode_metadata(nm_ref, include_imag=imag)
        b = vib.mode_metadata(nm, include_imag=imag)
        np.testing.assert_array_equal(b.indices, a.indices)
        for k in ("frequencies_cm1", "reduced_mass", "force_const_dyne",
                  "vib_temperature"):
            np.testing.assert_allclose(getattr(b, k), getattr(a, k),
                                       rtol=1e-9, atol=1e-9, err_msg=k)


def _numbers(line):
    out = []
    for tok in line.split():
        try:
            out.append(float(tok))
        except ValueError:
            pass
    return np.asarray(out)


def test_mode_files_match_reference(systems, tmp_path):
    """normal_modes.txt and the animations: the same labels, file names
    and frame headers; the numbers equal after flipping each port mode to
    the reference's sign, to half a unit of the last printed digit."""
    c, z, h = systems["water"]
    nm_ref, nm = _pair(c, z, h)
    meta = ref.mode_metadata(nm_ref)
    m_ref = np.asarray(nm_ref.modes)[meta.indices]
    m = nm.modes.numpy()[meta.indices]
    signs = np.sign(np.einsum("kij,kij->k", m_ref, m))
    flipped = vib.NormalModes(nm.frequencies_cm1, nm.modes.clone(),
                              nm.eigenvalues)
    flipped.modes[meta.indices] *= torch.as_tensor(signs)[:, None, None]

    ref.write_normal_modes(nm_ref, z, str(tmp_path / "ref.txt"))
    vib.write_normal_modes(flipped, z, str(tmp_path / "port.txt"))
    a = (tmp_path / "ref.txt").read_text().splitlines()
    b = (tmp_path / "port.txt").read_text().splitlines()
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        assert la.split()[:1] == lb.split()[:1]
        np.testing.assert_allclose(_numbers(lb), _numbers(la), rtol=0,
                                   atol=5.01e-5)

    pa = ref.write_mode_animations(nm_ref, jnp.asarray(c), z,
                                   str(tmp_path / "ref_anim"), n_frames=5)
    pb = vib.write_mode_animations(flipped, torch.as_tensor(c), z,
                                   str(tmp_path / "port_anim"), n_frames=5)
    assert [pathlib.Path(p).name for p in pb] == \
        [pathlib.Path(p).name for p in pa]
    for fa, fb in zip(pa, pb):
        a = pathlib.Path(fa).read_text().splitlines()
        b = pathlib.Path(fb).read_text().splitlines()
        assert len(a) == len(b)
        for la, lb in zip(a, b):
            if la.startswith("Mode") or la.strip().isdigit():
                assert la == lb
            else:
                assert la.split()[0] == lb.split()[0]
                np.testing.assert_allclose(_numbers(lb), _numbers(la),
                                           rtol=0, atol=5.01e-7)


@pytest.mark.parametrize("name", ["water", "hcn"])
def test_rrho_thermochemistry_matches_reference(systems, name):
    c, z, h = systems[name]
    for temp, press, mult, sigma in ((298.15, 101325.0, 1, 1),
                                     (500.0, 2.0e5, 2, 2)):
        a = ref.rrho_thermochemistry(jnp.asarray(h), jnp.asarray(c), z,
                                     temperature=temp, pressure=press,
                                     multiplicity=mult, sigma_rot=sigma)
        b = vib.rrho_thermochemistry(torch.as_tensor(h), torch.as_tensor(c),
                                     z, temperature=temp, pressure=press,
                                     multiplicity=mult, sigma_rot=sigma)
        for k in ("zpe", "e_thermal", "enthalpy", "gibbs"):
            assert abs(getattr(b, k) - getattr(a, k)) <= 1e-10, k
        assert abs(b.entropy - a.entropy) <= 1e-12
    bc, mom = vib.rotational_constants(torch.as_tensor(c), z)
    bc_ref, mom_ref = ref.rotational_constants(jnp.asarray(c), z)
    np.testing.assert_allclose(mom.numpy(), np.asarray(mom_ref), rtol=1e-10,
                               atol=1e-10 * float(np.max(mom_ref)))
    big = np.asarray(bc_ref) < 1e6   # a linear molecule's zero moment
    np.testing.assert_allclose(bc.numpy()[big], np.asarray(bc_ref)[big],
                               rtol=1e-10)
