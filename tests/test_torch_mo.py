"""Port parity: analysis/mo.py of multioptpy_tpu_torch against the JAX
package on the water and HCN +1 cations (open shells: the Fermi level lies
in a partly filled level, away from the reference's f32 electron count,
ROADMAP F1), SQM and SQM2 parameters: orbital energies, occupations and
the overlap to 1e-10, the density matrix (sign-free) to 1e-10, the MO
coefficients of each isolated orbital up to its sign, to 1e-9; the natural reaction orbitals
between two geometries (eigenvalues to 1e-10, vectors up to sign); the
NRO response on a host wavefunction (`_host_wavefunction`) through
`orbitals_of` and `nro_along`, to 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.analysis import mo as ref
from multioptpy_tpu.calculators.sqm import SQM as RefSQM
from multioptpy_tpu.calculators.sqm import SQM2 as RefSQM2
from multioptpy_tpu_torch.analysis import mo
from multioptpy_tpu_torch.calculators.sqm import SQM, SQM2

torch.set_num_threads(1)

_WATER = (np.array([[0.0, 0.0, 0.12], [0.0, 1.45, -0.93],
                    [0.0, -1.43, -0.9]]), np.array([8, 1, 1]))
_WATER_2 = _WATER[0] + np.array([[0.0, 0.05, 0.02], [0.0, 0.1, -0.2],
                                 [0.0, -0.15, 0.1]])
_HCN = (np.array([[0.0, 0.0, -2.0], [0.0, 0.0, 0.0], [0.0, 0.1, 2.2]]),
        np.array([1, 6, 7]))


def _calcs(kind):
    if kind == "sqm":
        return (RefSQM(charge=1, multiplicity=2),
                SQM(charge=1, multiplicity=2, device="cpu"))
    return (RefSQM2(charge=1, multiplicity=2),
            SQM2(charge=1, multiplicity=2, device="cpu"))


def _same_up_to_sign(a, b, tol):
    s = np.sign(np.einsum("ik,ik->k", a, b))
    np.testing.assert_allclose(b * s[None, :], a, rtol=0, atol=tol)


@pytest.mark.parametrize("kind,mol", [("sqm2", "water"), ("sqm", "hcn")])
def test_sqm_orbitals_match_reference(kind, mol):
    c, z = _WATER if mol == "water" else _HCN
    rc, pc = _calcs(kind)
    a = ref.sqm_orbitals(rc, jnp.asarray(c), z)
    b = mo.sqm_orbitals(pc, torch.as_tensor(c), z)
    np.testing.assert_allclose(b.energies, a.energies, rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(b.overlap, a.overlap, rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.occupations, a.occupations, rtol=0,
                               atol=1e-10)
    assert b.occupations.sum() == pytest.approx(a.occupations.sum(),
                                                abs=1e-10)
    np.testing.assert_allclose(mo.density_matrix(b), ref.density_matrix(a),
                               rtol=0, atol=1e-10)
    # coefficients of isolated orbitals up to sign (the absent p shells of
    # H form a degenerate block whose basis is arbitrary)
    gap = np.diff(a.energies)
    iso = np.ones(len(gap) + 1, bool)
    iso[:-1] &= gap > 1e-6
    iso[1:] &= gap > 1e-6
    _same_up_to_sign(a.coefficients[:, iso], b.coefficients[:, iso], 1e-9)


def test_natural_reaction_orbitals_match_reference():
    c, z = _WATER
    rc, pc = _calcs("sqm2")
    wa, va = ref.natural_reaction_orbitals(rc, jnp.asarray(c),
                                           jnp.asarray(_WATER_2), z)
    wb, vb = mo.natural_reaction_orbitals(pc, torch.as_tensor(c),
                                          torch.as_tensor(_WATER_2), z)
    np.testing.assert_allclose(wb, wa, rtol=0, atol=1e-10)
    big = np.abs(wa) > 1e-6     # distinct, well-separated eigenvalues
    _same_up_to_sign(va[:, big][:, :3], vb[:, big][:, :3], 1e-8)


class _HostWavefunction:
    """A host bridge's wavefunction contract, on a smooth model: orbitals
    of a 4x4 symmetric matrix that depends on the geometry."""

    def _host_wavefunction(self, coords, z):
        x = np.asarray(coords).ravel()
        m = np.diag([-1.0, -0.5, 0.3, 0.9]) + 0.05 * np.outer(
            np.sin(x[:4]), np.cos(x[:4]))
        m = 0.5 * (m + m.T)
        w, v = np.linalg.eigh(m)
        v = v * np.sign(v[0])[None, :]
        return w, v, np.eye(4), np.array([2.0, 2.0, 0.0, 0.0])


def test_nro_response_on_a_host_wavefunction_matches_reference():
    calc = _HostWavefunction()
    c, z = _WATER
    direction = np.linspace(-1.0, 1.0, 9).reshape(3, 3)
    a = ref.nro_along(calc, c, z, direction, delta=1e-3)
    b = mo.nro_along(calc, torch.as_tensor(c), z, torch.as_tensor(direction),
                     delta=1e-3)
    for k in ("lambda_singular", "d_orbital_energy", "d2_orbital_energy"):
        np.testing.assert_allclose(getattr(b, k), getattr(a, k), rtol=1e-10,
                                   atol=1e-12, err_msg=k)
    assert b.lambda_sum == pytest.approx(a.lambda_sum, rel=1e-10)
    assert mo.orbitals_of(calc, c, z).energies.shape == (4,)
