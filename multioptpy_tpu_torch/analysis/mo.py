"""Molecular-orbital analysis: SQM orbitals and natural reaction orbitals.

Counterpart of `multioptpy_tpu/analysis/mo.py`. `sqm_orbitals` solves the
SQM EHT problem of one geometry on the calculator's device and returns
(eps, C, S, occ); `natural_reaction_orbitals` diagonalizes the density
difference between two geometries along a reaction path; `nro_response`
and `nro_along` give the natural-reaction-orbital response between
displaced wavefunctions, on SQM or on a host bridge's wavefunction
(`_host_wavefunction`, calculators/host.py). The analysis after the
orbitals is host numpy, as in the reference.
"""

from typing import NamedTuple

import numpy as np
import torch

from multioptpy_tpu_torch.units import HARTREE2EV


class Orbitals(NamedTuple):
    energies: np.ndarray     # (M,)
    coefficients: np.ndarray  # (M, M) columns are MOs (S-orthonormal)
    overlap: np.ndarray      # (M, M)
    occupations: np.ndarray  # (M,)


def sqm_orbitals(calc, coords, z):
    """Solve the SQM EHT problem of coords (N, 3) Bohr once and return the
    orbitals (s and p shells, the reference's basis)."""
    from multioptpy_tpu_torch.calculators import sqm as S

    z_np = np.asarray(z)
    n = len(z_np)
    x = torch.as_tensor(coords, dtype=torch.float64, device=calc.device)
    opts = dict(dtype=x.dtype, device=x.device)
    alpha, cs, cp = (torch.as_tensor(a, **opts)
                     for a in S._primitive_params(z_np))
    s_blocks = S._overlap_blocks(x[None], alpha, cs, cp)[0]
    h_diag = torch.as_tensor(np.stack(
        [S._T["h_s"][z_np], S._T["h_p"][z_np], S._T["h_p"][z_np],
         S._T["h_p"][z_np]], axis=1).reshape(-1) / HARTREE2EV, **opts)
    m = 4 * n
    s_mat = s_blocks.permute(0, 2, 1, 3).reshape(m, m)
    eye_n = torch.eye(n, **opts)
    diag_mask = torch.kron(eye_n, torch.ones((4, 4), **opts))
    s_mat = s_mat * (1 - diag_mask) + torch.kron(eye_n, torch.eye(4, **opts))
    valid = torch.as_tensor(np.stack(
        [np.ones(n), S._T["has_p"][z_np], S._T["has_p"][z_np],
         S._T["has_p"][z_np]], axis=1).reshape(-1), **opts)
    vv = valid[:, None] * valid[None, :]
    s_mat = s_mat * vv + torch.diag(1.0 - valid)
    is_p = torch.as_tensor(np.tile([0.0, 1.0, 1.0, 1.0], n), **opts)
    pp = is_p[:, None] + is_p[None, :]
    k_pair = torch.where(pp == 0, calc.k_ss,
                         torch.where(pp == 1, calc.k_sp,
                                     torch.full_like(pp, calc.k_pp)))
    h_mat = 0.5 * k_pair * (h_diag[:, None] + h_diag[None, :]) * s_mat
    h_mat = torch.where(torch.eye(m, dtype=torch.bool, device=x.device),
                        h_diag, h_mat * vv)

    l_fac = torch.linalg.cholesky(s_mat + 1e-10 * torch.eye(m, **opts))
    tmp = torch.linalg.solve_triangular(l_fac, h_mat, upper=False)
    h_prime = torch.linalg.solve_triangular(l_fac, tmp.mT, upper=False).mT
    w, y = torch.linalg.eigh(0.5 * (h_prime + h_prime.mT))
    c = torch.linalg.solve_triangular(l_fac.mT, y, upper=True)

    n_elec = float(np.sum(S._T["n_val"][z_np]) - calc.charge)
    occ, _ = S._fermi_occupations(w[None], n_elec, calc.kt)
    return Orbitals(energies=w.cpu().numpy(), coefficients=c.cpu().numpy(),
                    overlap=s_mat.cpu().numpy(),
                    occupations=occ[0].cpu().numpy())


def density_matrix(orb):
    c_occ = orb.coefficients * orb.occupations[None, :]
    return c_occ @ orb.coefficients.T


def host_orbitals(calc, coords, z):
    """Orbitals from a host bridge's wavefunction:
    `calc._host_wavefunction(coords_bohr, z) -> (eps, C, S, occ)` numpy
    arrays (calculators/host.py)."""
    eps, c, s, occ = calc._host_wavefunction(_np(coords), np.asarray(z))
    return Orbitals(energies=np.asarray(eps), coefficients=np.asarray(c),
                    overlap=np.asarray(s), occupations=np.asarray(occ))


def orbitals_of(calc, coords, z):
    """The host bridge's wavefunction when the backend provides one, else
    the on-device SQM orbitals."""
    if hasattr(calc, "_host_wavefunction"):
        return host_orbitals(calc, coords, z)
    return sqm_orbitals(calc, coords, z)


class NROResponse(NamedTuple):
    lambda_singular: np.ndarray   # singular values of the response matrix
    lambda_sum: float             # the per-step LAMBDA scalar
    left: np.ndarray              # left natural reaction orbitals (columns)
    right: np.ndarray             # right NROs (columns)
    d_orbital_energy: np.ndarray   # d eps / d s along the direction
    d2_orbital_energy: np.ndarray  # d2 eps / d s2


def nro_response(orb_0, orb_plus, orb_minus, delta):
    """Natural-reaction-orbital response between displaced wavefunctions
    (Ebisawa et al., PCCP 24, 3532 (2022)): the first response matrix
    M = C0^H S dC/ds (dC from the +/-delta central difference) is
    SVD-decomposed; its singular values measure how strongly each orbital
    rotates along the displacement, and its singular vectors are the NRO
    pairs. Also returns the first and second orbital-energy
    derivatives."""
    dc = (orb_plus.coefficients - orb_minus.coefficients) / (2.0 * delta)
    d_eps = (orb_plus.energies - orb_minus.energies) / (2.0 * delta)
    d2_eps = (orb_plus.energies + orb_minus.energies
              - 2.0 * orb_0.energies) / (delta ** 2)
    m = (np.conjugate(orb_0.coefficients.T) @ orb_0.overlap @ dc)
    left, lam, right_h = np.linalg.svd(m)
    return NROResponse(lambda_singular=lam, lambda_sum=float(np.sum(lam)),
                       left=left, right=np.conjugate(right_h.T),
                       d_orbital_energy=d_eps, d2_orbital_energy=d2_eps)


def nro_along(calc, coords, z, direction, delta=1e-4):
    """NRO response at coords (N, 3) along `direction`, displacing by
    +/- delta * unit(direction), on any backend `orbitals_of` serves."""
    direction = _np(direction).astype(np.float64)
    step = delta * direction / (np.linalg.norm(direction) + 1e-300)
    coords = _np(coords).astype(np.float64)
    orb_0 = orbitals_of(calc, coords, z)
    orb_p = orbitals_of(calc, coords + step, z)
    orb_m = orbitals_of(calc, coords - step, z)
    return nro_response(orb_0, orb_p, orb_m, delta)


def natural_reaction_orbitals(calc, coords_1, coords_2, z):
    """NROs: eigenvectors of the density difference between two points
    on a reaction path, symmetrically orthogonalized with the mean
    overlap; a large |eigenvalue| marks the orbitals most involved in the
    electronic rearrangement. Returns (eigenvalues sorted by |.| desc,
    orbital vectors)."""
    o1 = sqm_orbitals(calc, coords_1, z)
    o2 = sqm_orbitals(calc, coords_2, z)
    dp = density_matrix(o2) - density_matrix(o1)
    s = 0.5 * (o1.overlap + o2.overlap)
    sw, sv = np.linalg.eigh(s)
    s_half = sv @ np.diag(np.sqrt(np.maximum(sw, 1e-12))) @ sv.T
    m = s_half @ dp @ s_half
    w, v = np.linalg.eigh(0.5 * (m + m.T))
    order = np.argsort(-np.abs(w))
    return w[order], v[:, order]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
