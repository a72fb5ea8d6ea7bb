"""Dispersion pieces the SQM calculators use: D3 coordination numbers and
the charge-scaled D4 two-body energy, on batched coordinates.

Counterpart of the parts of `multioptpy_tpu/hessian/dispersion.py` that
`calculators/sqm.py` reaches (D4_EN, d3_coordination_numbers, d4_energy).
The D2 C6 table feeds the D4 pair tables.
"""

import numpy as np
import torch

from multioptpy_tpu_torch.periodic import COVALENT_RADII_1, UFF_VDW_R

# Z-indexed (0..86): Grimme D2 C6 (J nm^6 / mol) and vdW radii (Angstrom)
D2_C6_JNM6 = np.array([
    0, 0.14, 0.08, 1.61, 1.61, 3.13, 1.75, 1.23,
    0.7, 0.75, 0.63, 5.71, 5.71, 10.79, 9.23, 7.84,
    5.57, 5.07, 4.61, 10.8, 10.8, 10.8, 10.8, 10.8,
    10.8, 10.8, 10.8, 10.8, 10.8, 10.8, 10.8, 16.99,
    17.1, 16.37, 12.64, 12.47, 12.01, 24.67, 24.67, 24.67,
    24.67, 24.67, 24.67, 24.67, 24.67, 24.67, 24.67, 24.67,
    24.67, 37.32, 38.71, 38.44, 31.74, 31.5, 29.99, 50,
    50, 50, 50, 50, 50, 50, 50, 50,
    50, 50, 50, 50, 50, 50, 50, 50,
    50, 50, 50, 50, 50, 50, 50, 50,
    50, 50, 50, 50, 50, 50, 50,
], dtype=np.float64)

D2_VDW_ANG = np.array([
    1, 1.001, 1.012, 0.825, 1.408, 1.485, 1.452, 1.397,
    1.342, 1.287, 1.243, 1.144, 1.364, 1.639, 1.716, 1.705,
    1.683, 1.639, 1.595, 1.485, 1.474, 1.562, 1.562, 1.562,
    1.562, 1.562, 1.562, 1.562, 1.562, 1.562, 1.562, 1.65,
    1.727, 1.76, 1.771, 1.749, 1.727, 1.628, 1.606, 1.639,
    1.639, 1.639, 1.639, 1.639, 1.639, 1.639, 1.639, 1.639,
    1.639, 1.672, 1.804, 1.881, 1.892, 1.892, 1.881, 1.802,
    1.762, 1.72, 1.753, 1.753, 1.753, 1.753, 1.753, 1.753,
    1.753, 1.753, 1.753, 1.753, 1.753, 1.753, 1.753, 1.753,
    1.788, 1.772, 1.772, 1.772, 1.772, 1.772, 1.772, 1.772,
    1.758, 1.989, 1.944, 1.898, 2.005, 1.991, 1.924,
], dtype=np.float64)

# J nm^6/mol -> Hartree Bohr^6
_C6_AU = D2_C6_JNM6 / 6.02214076e23 / 4.3597447222071e-18 / 0.052917721067 ** 6


# tad-dftd3 r4/r2 ratios, Z=1..56 (ref: Parameters/d4.py:31-57; default 10)
D4_R4R2 = np.full(87, 10.0)
D4_R4R2[1:57] = [
    8.0589, 3.4698, 29.0974, 14.8517, 11.8799, 7.8715, 5.5588, 4.7566,
    3.8025, 3.1036, 26.1552, 17.2304, 17.7210, 12.7442, 9.5361, 8.1652,
    6.7463, 5.6004, 29.2012, 22.3934, 19.0598, 16.8590, 15.4023, 12.5589,
    13.4788, 12.2309, 11.2809, 10.5569, 10.1428, 9.4907, 13.4606, 10.8544,
    8.9386, 8.1350, 7.1251, 6.1971, 30.0162, 24.4103, 20.3537, 17.4780,
    13.5528, 11.8451, 11.0355, 10.1997, 9.5414, 9.0061, 8.6417, 8.9975,
    14.0834, 11.8333, 10.0179, 9.3844, 8.4110, 7.5152, 32.7622, 27.5708,
]

# Pauling electronegativities for the charge estimate, Z=1..56
# (ref: Parameters/d4.py:60-69; default 2.0)
D4_EN = np.full(87, 2.0)
D4_EN[1:57] = [
    2.20, 0.00, 0.98, 1.57, 2.04, 2.55, 3.04, 3.44, 3.98, 0.00,
    0.93, 1.31, 1.61, 1.90, 2.19, 2.58, 3.16, 0.00, 0.82, 1.00,
    1.36, 1.54, 1.63, 1.66, 1.55, 1.83, 1.88, 1.91, 1.90, 1.65,
    1.81, 2.01, 2.18, 2.55, 2.96, 0.00, 0.82, 0.95, 1.22, 1.33,
    1.60, 2.16, 1.90, 2.20, 2.28, 2.20, 1.93, 1.69, 1.78, 1.96,
    2.05, 2.10, 2.66, 0.00, 0.79, 0.89,
]

# PBE0/def2-QZVP damping defaults (ref: Parameters/d4.py:8)
D4_S6, D4_S8, D4_A1, D4_A2 = 1.0, 1.03683, 0.4171, 4.5337
D4_GA, D4_GC = 3.0, 2.0




def _distances(coords):
    """(B,N,3) -> (B,N,N) distances with 1 on the diagonal (safe sqrt)."""
    n = coords.shape[-2]
    diff = coords[:, :, None, :] - coords[:, None, :, :]
    eye = torch.eye(n, dtype=coords.dtype, device=coords.device)
    return torch.sqrt((diff * diff).sum(-1) + eye)


def d3_coordination_numbers(coords, z, k1=16.0, k2=4.0 / 3.0):
    """Fractional D3 coordination numbers (Grimme JCP 132, 154104 eq. 15),
    (B,N,3) -> (B,N): CN_i = sum_j 1/(1+exp(-k1 (k2 rcov_ij / r_ij - 1)))."""
    n = coords.shape[-2]
    rcov = torch.as_tensor(COVALENT_RADII_1[np.asarray(z)], dtype=coords.dtype,
                           device=coords.device)
    r = _distances(coords)
    rcov_sum = rcov[:, None] + rcov[None, :]
    term = torch.clamp(-k1 * (k2 * (rcov_sum / r) - 1.0), -100.0, 100.0)
    f = 1.0 / (1.0 + torch.exp(term))
    eye = torch.eye(n, dtype=coords.dtype, device=coords.device)
    return (f * (1.0 - eye)).sum(-1)


def d4_pair_tables(z, dtype=np.float64):
    """Static per-pair (C6, C8, R0) matrices: C6 Casimir-Polder-combined
    from the D2 per-element values, C8 = 3 C6 sqrt(r4r2_i r4r2_j), R0 the
    UFF vdW radii sum divided by the Bohr length once more, as the
    reference does."""
    z = np.asarray(z)
    c6 = _C6_AU[z]
    c6_ij = 2.0 * c6[:, None] * c6[None, :] / (c6[:, None] + c6[None, :]
                                               + 1e-300)
    r4r2 = D4_R4R2[z]
    c8_ij = 3.0 * c6_ij * np.sqrt(r4r2[:, None] * r4r2[None, :])
    r_bohr = np.asarray(UFF_VDW_R)[z] / 0.52917721067
    r0_ij = r_bohr[:, None] + r_bohr[None, :]
    return (np.asarray(c6_ij, dtype), np.asarray(c8_ij, dtype),
            np.asarray(r0_ij, dtype))


def d4_pair_energy(r, c6, c8, r0, q_scaling=1.0,
                   s6=D4_S6, s8=D4_S8, a1=D4_A1, a2=D4_A2):
    """Per-pair D4 energy e6 + e8 with BJ-style damping
    f6 = r^6/(r^6 + ((R0+a1) a2)^6)."""
    bj = (r0 + a1) * a2
    f6 = r ** 6 / (r ** 6 + bj ** 6)
    f8 = r ** 8 / (r ** 8 + bj ** 8)
    e6 = -s6 * c6 * q_scaling * f6 / r ** 6
    e8 = -s8 * c8 * q_scaling * f8 / r ** 8
    return e6 + e8


def d4_energy(coords, z, charges, ga=D4_GA, **kw):
    """Two-body D4 dispersion (B,) with Gaussian charge scaling
    exp(-ga (q_i^2 + q_j^2)); `charges` (B,N) are the caller's EEQ charges."""
    n = coords.shape[-2]
    kind = dict(dtype=coords.dtype, device=coords.device)
    c6_ij, c8_ij, r0_ij = (torch.as_tensor(t, **kind)
                           for t in d4_pair_tables(z))
    mask = torch.ones(n, n, dtype=torch.bool, device=coords.device).triu(1)
    r = _distances(coords)
    q2 = charges[:, :, None] ** 2 + charges[:, None, :] ** 2
    qs = torch.exp(-ga * q2)
    e = d4_pair_energy(r, c6_ij, c8_ij, r0_ij, qs, **kw)
    return torch.where(mask, e, 0.0).sum((-2, -1))
