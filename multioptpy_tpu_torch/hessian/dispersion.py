"""Dispersion pieces on batched coordinates: D3 coordination numbers and
the charge-scaled D4 two-body energy (the SQM calculators), and the D2,
D3(BJ) (static, or with coordination-number-scaled C6) and D4 energies
with their autodiff gradients and exact autodiff Hessians, the D4 charge estimate and the D4 pair
force constant (the dispersion-corrected model Hessians,
`hessian/model.py`).

Counterpart of `multioptpy_tpu/hessian/dispersion.py`. The D2 C6 table
feeds the D3 and D4 pair tables.
"""

import numpy as np
import torch

from multioptpy_tpu_torch.periodic import COVALENT_RADII_1, UFF_VDW_R
from multioptpy_tpu_torch.units import ANGSTROM2BOHR as _ANG2BOHR

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

# Z-indexed <r^4>/<r^2> expectation values (a.u.), Grimme PBE0/def2-QZVP
# (2010), as shipped by tad-dftd3; unlisted elements fall back to 10.0
D3_R4R2 = np.full(87, 10.0)
D3_R4R2[:55] = [
    10.0,
    8.0589, 3.4698,
    29.0974, 14.8517, 11.8799, 7.8715, 5.5588, 4.7566, 3.8025, 3.1036,
    26.1552, 17.2304, 17.7210, 12.7442, 9.5361, 8.1652, 6.7463, 5.6004,
    29.2012, 22.3934,
    19.0598, 16.8590, 15.4023, 12.5589, 13.4788, 12.2309, 11.2809,
    10.5569, 10.1428, 9.4907,
    13.4606, 10.8544, 8.9386, 8.1350, 7.1251, 6.1971,
    30.0162, 24.4103,
    20.3537, 17.4780, 13.5528, 11.8451, 11.0355, 10.1997, 9.5414,
    9.0061, 8.6417, 8.9975,
    14.0834, 11.8333, 10.0179, 9.3844, 8.4110, 7.5152,
]
D3_R4R2[55:57] = [32.7622, 27.5708]
D3_R4R2[57:64] = [23.1671, 21.6003, 20.9615, 20.4562, 20.1010, 19.7475,
                  19.4828]
D3_R4R2[64:71] = [15.6013, 19.2362, 17.4717, 17.8321, 17.4237, 17.1954,
                  17.1631]
D3_R4R2[71:87] = [14.5716, 15.8758, 13.8989, 12.4834, 11.4421, 10.2671,
                  8.3549, 7.8496, 7.3278, 7.4820, 13.5124, 11.6554,
                  10.0959, 9.7340, 8.8584, 8.0125]


# typical-valency reference coordination numbers, Z-indexed (default 4)
_D3_REF_CN = np.full(87, 4.0)
for _z, _cn in {1: 1, 2: 0, 3: 4, 4: 4, 5: 3, 6: 4, 7: 3, 8: 2, 9: 1,
                10: 0, 11: 6, 12: 6, 13: 6, 14: 4, 15: 5, 16: 6, 17: 1,
                18: 0, 19: 8, 20: 6, 21: 12, 22: 12, 23: 12, 24: 6,
                25: 6, 26: 6, 27: 6, 28: 4, 29: 4, 30: 4, 31: 4, 32: 4,
                33: 3, 34: 2, 35: 1, 36: 0, 37: 8, 38: 6, 39: 12,
                40: 12, 41: 12, 42: 6, 43: 6, 44: 6, 45: 6, 46: 4,
                47: 4, 48: 4, 49: 6, 50: 4, 51: 3, 52: 2, 53: 1,
                54: 0}.items():
    _D3_REF_CN[_z] = float(_cn)


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


def d4_energy(coords, z, charges=None, ga=D4_GA, **kw):
    """Two-body D4 dispersion (B,) with Gaussian charge scaling
    exp(-ga (q_i^2 + q_j^2)); `charges` (B,N) are the caller's (EEQ)
    charges, by default the electronegativity estimate `d4_charges`."""
    n = coords.shape[-2]
    if charges is None:
        charges = d4_charges(coords, z)
    kind = dict(dtype=coords.dtype, device=coords.device)
    c6_ij, c8_ij, r0_ij = (torch.as_tensor(t, **kind)
                           for t in d4_pair_tables(z))
    mask = torch.ones(n, n, dtype=torch.bool, device=coords.device).triu(1)
    r = _distances(coords)
    q2 = charges[:, :, None] ** 2 + charges[:, None, :] ** 2
    qs = torch.exp(-ga * q2)
    e = d4_pair_energy(r, c6_ij, c8_ij, r0_ij, qs, **kw)
    return torch.where(mask, e, 0.0).sum((-2, -1))


def d3_energy(coords, z, s6=1.0, s8=0.7875, a1=0.4289, a2=4.4407,
              dynamic_cn=False):
    """D3(BJ)-style dispersion (B,) with the D2 C6 values (sqrt
    combination), C8 = 3 C6 sqrt(r4r2_i r4r2_j) and Becke-Johnson damping
    with R0 = sqrt(C8/C6). `dynamic_cn` scales each C6 by its coordination-
    number deviation from typical valency, clip(1 - 0.05 (CN - CN_ref),
    0.75, 1.25) (the fischerd3 flavour); without it this is the static form
    of fischerd3old and the lindh2007d3 family."""
    z = np.asarray(z)
    n = len(z)
    kind = dict(dtype=coords.dtype, device=coords.device)
    c6 = torch.as_tensor(_C6_AU[z], **kind).expand(coords.shape[0], n)
    if dynamic_cn:
        cn = d3_coordination_numbers(coords, z)
        ref_cn = torch.as_tensor(_D3_REF_CN[z], **kind)
        c6 = c6 * torch.clamp(1.0 - 0.05 * (cn - ref_cn), 0.75, 1.25)
    r4r2 = torch.as_tensor(D3_R4R2[z], **kind)
    mask = torch.ones(n, n, dtype=torch.bool, device=coords.device).triu(1)
    r = _distances(coords)
    c6_ij = torch.sqrt(c6[:, :, None] * c6[:, None, :])
    c8_ij = 3.0 * c6_ij * torch.sqrt(r4r2[:, None] * r4r2[None, :])
    r0_ij = torch.sqrt(c8_ij / (c6_ij + 1e-300))
    bj = a1 * r0_ij + a2
    e6 = -s6 * c6_ij / (r ** 6 + bj ** 6)
    e8 = -s8 * c8_ij / (r ** 8 + bj ** 8)
    return torch.where(mask, e6 + e8, 0.0).sum((-2, -1))


def d2_energy(coords, z, s6=1.2, damping=20.0):
    """Grimme D2 dispersion (B,) (Hartree, coords in Bohr):
    -s6 sum_{i<j} C6_ij / r^6 f_damp, f_damp = 1/(1+exp(-d(r/R0-1)))."""
    z = np.asarray(z)
    n = len(z)
    kind = dict(dtype=coords.dtype, device=coords.device)
    c6 = torch.as_tensor(_C6_AU[z], **kind)
    r0 = torch.as_tensor(D2_VDW_ANG[z] * _ANG2BOHR, **kind)
    mask = torch.ones(n, n, dtype=torch.bool, device=coords.device).triu(1)
    r = _distances(coords)
    c6_ij = torch.sqrt(c6[:, None] * c6[None, :])
    r0_ij = r0[:, None] + r0[None, :]
    f = 1.0 / (1.0 + torch.exp(-damping * (r / r0_ij - 1.0)))
    return torch.where(mask, -s6 * c6_ij / r ** 6 * f, 0.0).sum((-2, -1))


def _hessian_of(energy_fn, coords, z, **kw):
    """(B, 3N, 3N) autodiff Hessians of energy_fn(coords (B,N,3), z)."""
    b, n, _ = coords.shape

    def one(x_flat):
        return energy_fn(x_flat.reshape(1, n, 3), z, **kw)[0]

    return torch.func.vmap(torch.func.hessian(one))(
        coords.detach().reshape(b, 3 * n))


def d2_hessian(coords, z, s6=1.2):
    """(B, 3N, 3N) exact D2 Hessians by autodiff."""
    return _hessian_of(d2_energy, coords, z, s6=s6)


def _gradient_of(energy_fn, coords, z, **kw):
    """(B, N, 3) autodiff gradients of energy_fn(coords (B,N,3), z)."""
    with torch.enable_grad():
        x = coords.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(energy_fn(x, z, **kw).sum(), x)
    return g


def d2_gradient(coords, z, s6=1.2):
    """(B, N, 3) gradient of `d2_energy`."""
    return _gradient_of(d2_energy, coords, z, s6=s6)


def d3_gradient(coords, z, **kw):
    """(B, N, 3) gradient of `d3_energy`."""
    return _gradient_of(d3_energy, coords, z, **kw)


def d3_hessian(coords, z, **kw):
    """(B, 3N, 3N) exact D3(BJ) Hessians by autodiff."""
    return _hessian_of(d3_energy, coords, z, **kw)


def d4_charges(coords, z, bond_scale=1.3):
    """Electronegativity-equilibration charge estimate (B, N) for the D4
    scaling: per detected bond (r < bond_scale * rcov sum) transfer
    0.1 tanh(0.2 (EN_j - EN_i)) from j to i, then remove the mean."""
    z = np.asarray(z)
    n = len(z)
    kind = dict(dtype=coords.dtype, device=coords.device)
    en = torch.as_tensor(D4_EN[z], **kind)
    rcov = torch.as_tensor(np.asarray(COVALENT_RADII_1)[z], **kind)
    r = _distances(coords)
    eye = torch.eye(n, dtype=torch.bool, device=coords.device)
    bonded = (r < bond_scale * (rcov[:, None] + rcov[None, :])) & ~eye
    transfer = torch.where(bonded,
                           0.1 * torch.tanh(0.2 * (en[None, :] - en[:, None])),
                           0.0)
    q = transfer.sum(-1)
    return q - q.mean(-1, keepdim=True)


def d4_pair_force_const(r, c6, c8, r0, q_scaling=1.0, **kw):
    """-(e6 + e8): the pairwise force-constant term the D4-flavoured model
    Hessians add to long pairs."""
    return -d4_pair_energy(r, c6, c8, r0, q_scaling, **kw)


def d4_gradient(coords, z, **kw):
    """(B, N, 3) gradient of `d4_energy` (charges from `d4_charges`,
    differentiated through)."""
    return _gradient_of(d4_energy, coords, z, **kw)


def d4_hessian(coords, z, **kw):
    """(B, 3N, 3N) exact charge-scaled D4 Hessians by autodiff (charges from
    `d4_charges`)."""
    return _hessian_of(d4_energy, coords, z, **kw)
