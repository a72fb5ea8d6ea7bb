"""SQM — on-device semiempirical quantum chemistry (tight-binding EHT),
batched over structures.

Counterpart of `multioptpy_tpu/calculators/sqm.py` (see its docstring for
the physics and the parameter sources): STO-3G overlaps with d shells via
closed-form Gaussian-product integrals, a Wolfsberg-Helmholz EHT
Hamiltonian, Loewdin orthogonalization, a Fermi-smeared band free energy
with a Hellmann-Feynman backward pass, EEQ charges, GFN0-style repulsion,
D2 or charge-scaled D4 dispersion and the GFN0 SRB term.

Every function takes coordinates with a leading batch axis (B, N, 3) and
returns per-structure values (B,), so the band eigensolver receives one
(B, M, M) tensor per call and the Jacobi kernel sees the whole ensemble.
The parameter tables are this package's own copies (`tables()`);
`params_from_numpy` turns numpy tables into tensors on a device.
"""

import math

import numpy as np
import torch

from multioptpy_tpu_torch.calculators.base import Calculator, register_calculator
from multioptpy_tpu_torch.device import bmv
from multioptpy_tpu_torch.hessian.dispersion import (
    D2_C6_JNM6, D2_VDW_ANG, D4_A1, D4_A2, D4_EN, D4_GA, D4_GC, D4_R4R2, D4_S6,
    D4_S8, d3_coordination_numbers, d4_energy)
from multioptpy_tpu_torch.logging_utils import span, to_card
from multioptpy_tpu_torch.ops.eigh64 import eigh, eigh_solve, inv_sqrt_psd
from multioptpy_tpu_torch.parallel.mesh import check_mesh, mesh_device
from multioptpy_tpu_torch.periodic import COVALENT_RADII_1, UFF_VDW_R
from multioptpy_tpu_torch.units import HARTREE2EV

# --- STO-3G expansion (scale-1 exponents; multiply by zeta^2) -------------
_G1S_A = np.array([2.227660584, 0.405771156, 0.109818])
_G1S_C = np.array([0.154328967, 0.535328142, 0.444634542])
_G2SP_A = np.array([0.994203122, 0.231031402, 0.0751386])
_G2S_C = np.array([-0.09996723, 0.39951283, 0.70011547])
_G2P_C = np.array([0.15591627, 0.60768372, 0.39195739])
_G3SP_A = np.array([0.499663, 0.1331, 0.0519573])
_G3S_C = np.array([-0.2196204, 0.2255954, 0.9003984])
_G3P_C = np.array([0.01058760, 0.59516700, 0.46200100])
# 3-Gaussian expansion of the Slater 3d radial (zeta=1), fitted in-repo by
# maximizing <STO|sum c_i g_i> (tools/fit_d_expansion rationale; overlap
# 0.99998). Matches the Stewart JCP 52 (1970) 431 construction.
_G3D_A = np.array([0.52291121, 0.16395958, 0.0638663])
_G3D_C = np.array([0.16865962, 0.58479851, 0.40567791])

# Z -> (n_shell, zeta_s(=zeta_p), VSIP_s eV, VSIP_p eV, n_valence)
# zetas: Slater rules; VSIPs: Hoffmann extended-Hueckel tables.
_ELEMENTS = {
    1:  (1, 1.240, -13.60, None,  1),
    2:  (1, 1.700, -23.40, None,  2),
    3:  (2, 0.650, -5.40, -3.50,  1),
    4:  (2, 0.975, -10.00, -6.00, 2),
    5:  (2, 1.300, -15.20, -8.50, 3),
    6:  (2, 1.625, -21.40, -11.40, 4),
    7:  (2, 1.950, -26.00, -13.40, 5),
    8:  (2, 2.275, -32.30, -14.80, 6),
    9:  (2, 2.600, -40.00, -18.10, 7),
    10: (2, 2.925, -43.20, -20.00, 8),
    11: (3, 0.733, -5.10, -3.00,  1),
    12: (3, 0.950, -9.00, -4.50,  2),
    13: (3, 1.167, -12.30, -6.50, 3),
    14: (3, 1.383, -17.30, -9.20, 4),
    15: (3, 1.600, -18.60, -14.00, 5),
    16: (3, 1.817, -20.00, -13.30, 6),
    17: (3, 2.033, -26.30, -14.20, 7),
    18: (3, 2.250, -29.20, -15.80, 8),
}

# 3d polarization shells for row 3 (Na-Ar): Z -> (zeta_d, h_d eV).
# The valence d shell is EMPTY in the ground state; it contributes by
# MIXING into occupied MOs (hypervalent S/P/Cl bonding, SO2/S8/PF5-class
# chemistry the reference's SQM2 covers via its per-shell STO basis,
# ref: SQM/sqm2/sqm2_basis.py). zeta_d: single-zeta 3d STO exponents
# (EHT-style polarization values); h_d: shallow virtual-level VSIPs.
_D_SHELL = {
    11: (1.00, -2.0), 12: (1.10, -3.0), 13: (1.15, -4.0),
    14: (1.20, -5.0), 15: (1.40, -6.0), 16: (1.50, -6.5),
    17: (1.60, -7.0), 18: (1.70, -7.5),
}

# EEQ electronegativity / hardness (eV, Parr-Pearson) + charge radius (Bohr)
_EEQ = {
    1: (7.18, 12.85, 1.4), 2: (12.3, 25.0, 1.3),
    3: (3.01, 4.77, 2.6), 4: (4.90, 8.90, 2.0), 5: (4.29, 8.02, 1.7),
    6: (6.27, 10.00, 1.6), 7: (7.30, 14.46, 1.5), 8: (7.54, 12.16, 1.4),
    9: (10.41, 14.02, 1.3), 10: (10.6, 21.0, 1.3),
    11: (2.85, 4.60, 3.0), 12: (3.75, 7.80, 2.6), 13: (3.23, 5.54, 2.2),
    14: (4.77, 6.76, 2.0), 15: (5.62, 9.76, 1.9), 16: (6.22, 8.28, 1.8),
    17: (8.30, 9.36, 1.7), 18: (7.7, 14.0, 1.7),
}

# effective repulsion charges (GFN0-flavoured: sub-valence for N/O/F so a
# single global prefactor balances X-H vs X-X walls; tuned here on
# H2 / H2O / CH4 / NH3 equilibrium geometries)
_Z_EFF_REP = {
    1: 1.6, 2: 1.2, 3: 1.0, 4: 1.8, 5: 2.4, 6: 4.0, 7: 3.0, 8: 3.4,
    9: 3.8, 10: 3.5, 11: 1.2, 12: 2.0, 13: 2.6, 14: 3.8, 15: 4.4,
    16: 4.6, 17: 4.4, 18: 4.0,
}

# Grimme D2 C6 (J mol^-1 nm^6) and vdW radii (Angstrom), JCC 27, 1787
_D2 = {
    1: (0.14, 1.001), 2: (0.08, 1.012),
    3: (1.61, 0.825), 4: (1.61, 1.408), 5: (3.13, 1.485),
    6: (1.75, 1.452), 7: (1.23, 1.397), 8: (0.70, 1.342),
    9: (0.75, 1.287), 10: (0.63, 1.243),
    11: (5.71, 1.144), 12: (5.71, 1.364), 13: (10.79, 1.639),
    14: (9.23, 1.716), 15: (7.84, 1.705), 16: (5.57, 1.683),
    17: (5.07, 1.639), 18: (4.61, 1.595),
}

_K_WH = 1.75         # Wolfsberg-Helmholz constant (ss pairs)
_K_SP = 2.2          # s-p pairs: controls hybridized/directional bonding —
                     # 1.75 leaves water nearly linear, 2.2 bends it to 110
                     # degrees (exp 104.5)
_K_PP = 2.2          # p-p pairs (heavy-heavy only — H has no p): round-2
                     # recalibration. At the old 1.75 the pi system was too
                     # weak to resist bending: CO2 minimized at ~140 deg
                     # (the round-1 documented defect). 2.2 makes CO2
                     # linear AND shortens r_CO (1.35 -> 1.25 ang) while
                     # leaving every X-H fixture (H2O/NH3/CH4 angles and
                     # bonds, ethane staggered preference) unchanged.
# repulsion constants calibrated against experimental r_e of H2 (1.40),
# H2O (1.81), CH4 (2.06), NH3 (1.91 Bohr): minima land within ~0.1 Bohr
_REP_K = 0.4         # global repulsion prefactor
_REP_R0_SCALE = 0.42  # scale on summed covalent radii
_REP_HH = 0.1        # short-range Gaussian H-H wall strength
_REP_EXP = 1.5       # GFN0-style exponent

# reference coordination numbers for the CN-dependent repulsion wall
# (rep_cn): the NEUTRAL point of the wall scaling — atoms at this D3 CN
# keep the calibrated radius, under-coordinated ones (sp carbon,
# terminal N, carbonyl O) get a wider wall. Values are the coordination
# at which the r4 calibration was already correct: C at its sp2/sp3
# midpoint 3 (C2H4 was spot-on, C2H6 long, C2H2 short), N 3 (NH3 good,
# HCN nitrile short), O 1 (carbonyl/CO2 good, hydroxyl slightly long),
# halogens/S/P at typical valence.
_REP_CN0 = np.full(87, 4.0)
for _z5, _cn5 in {1: 1, 2: 0, 3: 1, 4: 2, 5: 3, 6: 3, 7: 3, 8: 1,
                  9: 1, 10: 0, 11: 1, 12: 2, 13: 3, 14: 3, 15: 3,
                  16: 2, 17: 1, 18: 0}.items():
    _REP_CN0[_z5] = float(_cn5)
_D2_S6 = 1.2
_D2_D = 20.0
_FERMI_KT = 0.005    # Hartree electronic temperature (smearing)


def _tables(max_z=19):
    shell_n = np.zeros(max_z, np.int32)
    zeta = np.ones(max_z)
    zeta_p = np.ones(max_z)
    zeta_d = np.ones(max_z)
    h_s = np.zeros(max_z)
    h_p = np.full(max_z, 50.0)  # +50 eV pushes absent p shells far above
    h_d = np.full(max_z, 50.0)
    n_val = np.zeros(max_z)
    has_p = np.zeros(max_z)
    has_d = np.zeros(max_z)
    chi = np.zeros(max_z)
    eta = np.ones(max_z)
    r_q = np.ones(max_z)
    c6 = np.zeros(max_z)
    r0 = np.ones(max_z)
    z_eff = np.ones(max_z)
    for z, v in _Z_EFF_REP.items():
        z_eff[z] = v
    for z, (n, zt, hs, hp, nv) in _ELEMENTS.items():
        shell_n[z] = n
        zeta[z] = zt
        zeta_p[z] = zt   # Slater rules give identical 2s/2p, 3s/3p zetas;
        h_s[z] = hs      # kept as SEPARATE table columns so per-shell
        if hp is not None:  # calibration (and the sqm2 basis) can split them
            h_p[z] = hp
            has_p[z] = 1.0
        n_val[z] = nv
    for z, (zd, hd) in _D_SHELL.items():
        zeta_d[z] = zd
        h_d[z] = hd
        has_d[z] = 1.0
    for z, (x, e, r) in _EEQ.items():
        chi[z], eta[z], r_q[z] = x, e, r
    nm_per_bohr = 0.052917721067
    for z, (c, r) in _D2.items():
        # J mol^-1 nm^6 -> Hartree Bohr^6:
        # /NA (J nm^6) /Eh (Ha nm^6) * (Bohr/nm)^-6 = * (1/nm_per_bohr)^6
        c6[z] = (c / 6.02214076e23 / 4.3597447222071e-18
                 / nm_per_bohr ** 6)
        r0[z] = r / 0.52917721067  # Angstrom -> Bohr
    return dict(shell_n=shell_n, zeta=zeta, zeta_p=zeta_p, zeta_d=zeta_d,
                h_s=h_s, h_p=h_p, h_d=h_d, n_val=n_val,
                has_p=has_p, has_d=has_d, chi=chi / HARTREE2EV,
                eta=eta / HARTREE2EV,
                r_q=r_q, c6=c6, r0=r0, z_eff=z_eff)



_MONO = {0: [(0, 0, 0)],
         1: [(1, 0, 0), (0, 1, 0), (0, 0, 1)],
         2: [(2, 0, 0), (0, 2, 0), (0, 0, 2),
             (1, 1, 0), (1, 0, 1), (0, 1, 1)]}
_DFACT = {0: 1.0, 1: 1.0, 2: 3.0}  # (2k-1)!! of a per-axis power

# normalized-Cartesian [xx,yy,zz,xy,xz,yz] -> real spherical
# [z2, xz, yz, x2-y2, xy]; rows normalized against the same-center
# normalized-Cartesian metric (<xx|yy> = 1/3)
_C2S_D = np.array([
    [-0.5, -0.5, 1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 1.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0, 1.0],
    [np.sqrt(3.0) / 2.0, -np.sqrt(3.0) / 2.0, 0.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0, 0.0, 0.0],
])



def _f1d(i, j, pa, pb, u):
    """1D Cartesian-Gaussian overlap factor S(i,j)/S(0,0) from the
    Obara-Saika transfer recursion S(i+1,j) = PA S(i,j) + u(i S(i-1,j)
    + j S(i,j-1)), u = 1/(2p), written in closed form for i,j <= 2."""
    if (i, j) == (0, 0):
        return 1.0
    if (i, j) == (1, 0):
        return pa
    if (i, j) == (0, 1):
        return pb
    if (i, j) == (1, 1):
        return pa * pb + u
    if (i, j) == (2, 0):
        return pa * pa + u
    if (i, j) == (0, 2):
        return pb * pb + u
    if (i, j) == (2, 1):
        return pa * pa * pb + u * (2.0 * pa + pb)
    if (i, j) == (1, 2):
        return pa * pb * pb + u * (pa + 2.0 * pb)
    if (i, j) == (2, 2):
        return (pa * pa * pb * pb
                + u * (pa * pa + pb * pb + 4.0 * pa * pb)
                + 3.0 * u * u)
    raise ValueError((i, j))



# GFN0-xTB short-range bond (SRB) correction parameters — the published xtb
# gfn0 data the reference ships in SQM/sqm2/sqm2_data.py:17-21,:103-140.
# Z-indexed (0 pad; Z=1..86). Defaults k=-0.013 (attractive gaussian at the
# EN-corrected covalent distance — tightens bond lengths).
_SRB_K, _SRB_ETA, _SRB_GSCAL, _SRB_C1, _SRB_C2 = -0.013, 3.48, 0.51, -1.71, 2.11
_SRB_EN = np.zeros(87)
_SRB_EN[1:87] = [
    2.30085633, 2.78445145, 1.52956084, 1.51714704, 2.20568300,
    2.49640820, 2.81007174, 4.51078438, 4.67476223, 3.29383610,
    2.84505365, 2.20047950, 2.31739628, 2.03636974, 1.97558064,
    2.13446570, 2.91638164, 1.54098156, 2.91656301, 2.26312147,
    2.25621439, 1.32628677, 2.27050569, 1.86790977, 2.44759456,
    2.49480042, 2.91545568, 3.25897750, 2.68723778, 1.86132251,
    2.01200832, 1.97030722, 1.95495427, 2.68920990, 2.84503857,
    2.61591858, 2.64188286, 2.28442252, 1.33011187, 1.19809388,
    1.89181390, 2.40186898, 1.89282464, 3.09963488, 2.50677823,
    2.61196704, 2.09943450, 2.66930105, 1.78349472, 2.09634533,
    2.00028974, 1.99869908, 2.59072029, 2.54497829, 2.52387890,
    2.30204667, 1.60119300, 2.00000000, 2.00000000, 2.00000000,
    2.00000000, 2.00000000, 2.00000000, 2.00000000, 2.00000000,
    2.00000000, 2.00000000, 2.00000000, 2.00000000, 2.00000000,
    2.00000000, 2.30089349, 1.75039077, 1.51785130, 2.62972945,
    2.75372921, 2.62540906, 2.55860939, 3.32492356, 2.65140898,
    1.52014458, 2.54984804, 1.72021963, 2.69303422, 1.81031095,
    2.34224386]
_SRB_R0 = np.zeros(87)
_SRB_R0[1:87] = [
    0.55682207, 0.80966997, 2.49092101, 1.91705642, 1.35974851,
    0.98310699, 0.98423007, 0.76716063, 1.06139799, 1.17736822,
    2.85570926, 2.56149012, 2.31673425, 2.03181740, 1.82568535,
    1.73685958, 1.97498207, 2.00136196, 3.58772537, 2.68096221,
    2.23355957, 2.33135502, 2.15870365, 2.10522128, 2.16376162,
    2.10804037, 1.96460045, 2.00476257, 2.22628712, 2.43846700,
    2.39408483, 2.24245792, 2.05751204, 2.15427677, 2.27191920,
    2.19722638, 3.80910350, 3.26020971, 2.99716916, 2.71707818,
    2.34950167, 2.11644818, 2.47180659, 2.32198800, 2.32809515,
    2.15244869, 2.55958313, 2.59141300, 2.62030465, 2.39935278,
    2.56912355, 2.54374096, 2.56914830, 2.53680807, 4.24537037,
    3.66542289, 3.19903011, 2.80000000, 2.80000000, 2.80000000,
    2.80000000, 2.80000000, 2.80000000, 2.80000000, 2.80000000,
    2.80000000, 2.80000000, 2.80000000, 2.80000000, 2.80000000,
    2.80000000, 2.34880037, 2.37597108, 2.49067697, 2.14100577,
    2.33473532, 2.19498900, 2.12678348, 2.34895048, 2.33422774,
    2.86560827, 2.62488837, 2.88376127, 2.75174124, 2.83054552,
    2.63264944]



_T = _tables()

# Pauling electronegativities for the EN-scaled K factor (shared with the
# D4 charge model)
_PAULING_EN = D4_EN


def tables():
    """The port's own parameter tables as numpy arrays, keyed by name: the
    element table `_T`, the STO-3G/3d primitive expansions and the
    spherical-d transform, the Wolfsberg constants, the SRB, D2 and D4
    tables and the covalent/UFF radii they read."""
    t = {k: np.asarray(v) for k, v in _T.items()}
    t.update(
        g1s_a=_G1S_A, g1s_c=_G1S_C, g2sp_a=_G2SP_A, g2s_c=_G2S_C,
        g2p_c=_G2P_C, g3sp_a=_G3SP_A, g3s_c=_G3S_C, g3p_c=_G3P_C,
        g3d_a=_G3D_A, g3d_c=_G3D_C, c2s_d=_C2S_D,
        wolfsberg=np.array([_K_WH, _K_SP, _K_PP]),
        srb=np.array([_SRB_K, _SRB_ETA, _SRB_GSCAL, _SRB_C1, _SRB_C2]),
        srb_en=_SRB_EN, srb_r0=_SRB_R0, rep_cn0=_REP_CN0,
        d2_c6_jnm6=D2_C6_JNM6, d2_vdw_ang=D2_VDW_ANG,
        d4_r4r2=D4_R4R2, d4_en=D4_EN,
        d4_damping=np.array([D4_S6, D4_S8, D4_A1, D4_A2, D4_GA, D4_GC]),
        covalent_radii_1=COVALENT_RADII_1, uff_vdw_r=UFF_VDW_R)
    return t


def params_from_numpy(tables, device, dtype):
    """Numpy parameter arrays -> tensors on `device`: floating arrays in
    `dtype`, integer arrays as int64, bool arrays as bool."""
    out = {}
    for key, val in tables.items():
        val = np.asarray(val)
        if val.dtype == np.bool_:
            out[key] = torch.as_tensor(val, device=device)
        elif np.issubdtype(val.dtype, np.integer):
            out[key] = torch.as_tensor(val, dtype=torch.long, device=device)
        else:
            out[key] = torch.as_tensor(val, dtype=dtype, device=device)
    return out


# every atom row of a pair build (`_pair_geometry`, the overlap blocks)
ALL_ROWS = slice(None)


def _param_active(*vals):
    """False only when every value is a literal zero."""
    return any(not isinstance(v, (int, float)) or v != 0.0 for v in vals)


def _pair_geometry(coords, rows=ALL_ROWS):
    """(B,N,3) -> differences A - B (B,R,N,3) and squared distances
    (B,R,N) of the atom rows `rows` (a slice; every row by default)
    against all N columns."""
    rij = coords[:, rows, None, :] - coords[:, None, :, :]
    return rij, (rij * rij).sum(-1)


def _primitive_params(z):
    """Per-atom (3,) gaussian exponents and (3,) s/p contraction coeffs."""
    n = _T["shell_n"][z]
    zeta2 = _T["zeta"][z] ** 2
    alpha = np.where(n[:, None] == 1, _G1S_A[None, :],
                     np.where(n[:, None] == 2, _G2SP_A[None, :],
                              _G3SP_A[None, :])) * zeta2[:, None]
    cs = np.where(n[:, None] == 1, _G1S_C[None, :],
                  np.where(n[:, None] == 2, _G2S_C[None, :], _G3S_C[None, :]))
    cp = np.where(n[:, None] == 2, _G2P_C[None, :],
                  np.where(n[:, None] == 3, _G3P_C[None, :], _G2P_C[None, :]))
    return alpha, cs, cp


def _overlap_blocks(coords, alpha, cs, cp, rows=ALL_ROWS):
    """(B,R,N,4,4) overlap blocks of the atom rows `rows` against all N
    atoms over [s, px, py, pz] orbitals with one exponent set per atom (the
    shared-exponent sp fast path). alpha, cs, cp: (N,3) tensors."""
    a_i = alpha[rows, None, :, None]
    a_j = alpha[None, :, None, :]
    p_sum = a_i + a_j
    mu = a_i * a_j / p_sum
    rij, r2 = _pair_geometry(coords, rows)
    e0 = (math.pi / p_sum) ** 1.5 * torch.exp(-mu * r2[..., None, None])
    norm_s_i = (2.0 * a_i / math.pi) ** 0.75
    norm_s_j = (2.0 * a_j / math.pi) ** 0.75
    norm_p_i = norm_s_i * 2.0 * torch.sqrt(a_i)
    norm_p_j = norm_s_j * 2.0 * torch.sqrt(a_j)
    pa = (a_j / p_sum)[..., None] * (-rij[:, :, :, None, None, :])
    pb = (a_i / p_sum)[..., None] * (rij[:, :, :, None, None, :])
    c_s_i, c_s_j = cs[rows, None, :, None], cs[None, :, None, :]
    c_p_i, c_p_j = cp[rows, None, :, None], cp[None, :, None, :]
    s_ss = (c_s_i * c_s_j * norm_s_i * norm_s_j * e0).sum((-2, -1))
    s_sp = ((c_s_i * c_p_j * norm_s_i * norm_p_j * e0)[..., None]
            * pb).sum((-3, -2))
    s_ps = ((c_p_i * c_s_j * norm_p_i * norm_s_j * e0)[..., None]
            * pa).sum((-3, -2))
    eye3 = torch.eye(3, dtype=coords.dtype, device=coords.device)
    pp_core = (pa[..., :, None] * pb[..., None, :]
               + eye3 / (2.0 * p_sum)[..., None, None])
    s_pp = ((c_p_i * c_p_j * norm_p_i * norm_p_j * e0)[..., None, None]
            * pp_core).sum((-4, -3))
    top = torch.cat([s_ss[..., None, None], s_sp[..., None, :]], dim=-1)
    bottom = torch.cat([s_ps[..., :, None], s_pp], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _shell_pair_overlap(coords, a_a, c_a, l_a, a_b, c_b, l_b, c2s,
                        rows=ALL_ROWS):
    """(B,R,N,dimA,dimB) contracted overlaps between shell l_a on each
    atom i of the rows `rows` (exponents a_a (N,3), normalized-primitive
    coeffs c_a (N,3)) and shell l_b on every atom j. d blocks come out in
    the real-spherical basis [z2, xz, yz, x2-y2, xy] through `c2s` (5, 6)."""
    a_i = a_a[rows, None, :, None]
    a_j = a_b[None, :, None, :]
    p_sum = a_i + a_j
    u = 1.0 / (2.0 * p_sum)
    mu = a_i * a_j / p_sum
    rij, r2 = _pair_geometry(coords, rows)
    e0 = (math.pi / p_sum) ** 1.5 * torch.exp(-mu * r2[..., None, None])
    pa = (a_j / p_sum)[..., None] * (-rij[:, :, :, None, None, :])
    pb = (a_i / p_sum)[..., None] * (rij[:, :, :, None, None, :])

    def norm(a, mono):
        ll = mono[0] + mono[1] + mono[2]
        df = _DFACT[mono[0]] * _DFACT[mono[1]] * _DFACT[mono[2]]
        return ((2.0 * a / math.pi) ** 0.75 * (4.0 * a) ** (0.5 * ll)
                / np.sqrt(df))

    cw = c_a[rows, None, :, None] * c_b[None, :, None, :] * e0
    mono_rows = []
    for ma in _MONO[l_a]:
        cols = []
        for mb in _MONO[l_b]:
            val = cw * norm(a_i, ma) * norm(a_j, mb)
            for d in range(3):
                f = _f1d(ma[d], mb[d], pa[..., d], pb[..., d], u)
                if not isinstance(f, float):
                    val = val * f
            cols.append(val.sum((-2, -1)))
        mono_rows.append(torch.stack(cols, dim=-1))
    blk = torch.stack(mono_rows, dim=-2)
    if l_a == 2:
        blk = torch.einsum("st,bijtu->bijsu", c2s, blk)
    if l_b == 2:
        blk = torch.einsum("bijst,ut->bijsu", blk, c2s)
    return blk


def _basis_params(z_np, zeta_scale=(1.0, 1.0, 1.0)):
    """Per-atom (N,3) exponents and contraction coefficients for the s, p
    and d valence shells (zeta_scale multiplies the tabulated zetas)."""
    n = _T["shell_n"][z_np]
    base = np.where(n[:, None] == 1, _G1S_A[None, :],
                    np.where(n[:, None] == 2, _G2SP_A[None, :],
                             _G3SP_A[None, :]))
    cs = np.where(n[:, None] == 1, _G1S_C[None, :],
                  np.where(n[:, None] == 2, _G2S_C[None, :], _G3S_C[None, :]))
    cp = np.where(n[:, None] == 2, _G2P_C[None, :],
                  np.where(n[:, None] == 3, _G3P_C[None, :], _G2P_C[None, :]))
    zs = _T["zeta"][z_np] * zeta_scale[0]
    zp = _T["zeta_p"][z_np] * zeta_scale[1]
    zd = _T["zeta_d"][z_np] * zeta_scale[2]
    a_s = base * (zs ** 2)[:, None]
    a_p = base * (zp ** 2)[:, None]
    a_d = _G3D_A[None, :] * (zd ** 2)[:, None]
    cd = np.tile(_G3D_C[None, :], (len(z_np), 1))
    return dict(a_s=a_s, c_s=cs, a_p=a_p, c_p=cp, a_d=a_d, c_d=cd)


def _overlap_full(coords, prm, nob, rows=ALL_ROWS):
    """(B,R,N,nob,nob) overlap blocks of the atom rows `rows` against all
    N atoms over the per-shell basis; nob = 4 ([s,p]) or 9 ([s,p,d])."""
    shells = [(prm["a_s"], prm["c_s"], 0), (prm["a_p"], prm["c_p"], 1)]
    if nob == 9:
        shells.append((prm["a_d"], prm["c_d"], 2))
    c2s = prm["c2s_d"]
    blocks = [torch.cat([_shell_pair_overlap(coords, a_a, c_a, l_a,
                                             a_b, c_b, l_b, c2s, rows)
                         for a_b, c_b, l_b in shells], dim=-1)
              for a_a, c_a, l_a in shells]
    return torch.cat(blocks, dim=-2)


def _free_energy(eps, occ, kt):
    """Mermin F = sum occ eps - kT S_el, with 0 log 0 = 0."""
    f_half = occ.mul(0.5).clamp(0.0, 1.0)
    entropy = -2.0 * (torch.xlogy(f_half, f_half)
                      + torch.xlogy(1.0 - f_half, 1.0 - f_half)).sum(-1)
    return (occ * eps).sum(-1) - kt * entropy


class _BandFreeEnergy(torch.autograd.Function):
    """Band free energy (B,) of symmetric (B, M, M) matrices at fixed
    electron count. Backward is Hellmann-Feynman, A_bar = F_bar rho with
    rho = V diag(occ) V^T, so one eigh serves both passes and no
    eigenvector derivative (NaN on degenerate spectra) is ever formed."""

    @staticmethod
    def forward(ctx, a, n_elec, kt, eigh_impl):
        w, v = eigh(a, eigh_impl, "band")
        occ, _ = _fermi_occupations(w, n_elec, kt)
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward((v * occ[..., None, :]) @ v.mT)
        return _free_energy(w, occ, kt)

    @staticmethod
    def backward(ctx, f_bar):
        (rho,) = ctx.saved_tensors
        return f_bar[..., None, None] * rho, None, None, None


def _band_free_energy(a, n_elec, kt, eigh_impl="xla"):
    """Mermin band free energy of symmetric a (B, M, M) -> (B,)."""
    return _BandFreeEnergy.apply(a, n_elec, kt, eigh_impl)


def _fermi_occupations(eps, n_elec, kt=_FERMI_KT, n_iter=60):
    """Occupations 2 f(eps; mu) (B, M) with mu (B,) located so each row
    sums to n_elec. f32: fixed-trip bisection. f64: 40 bisection steps on
    an f32 mu, then 4 clamped f64 Newton steps.

    The f64 bisection counts electrons in f64, where the reference counts
    in f32. With a HOMO-LUMO gap of many kT, the f32 count rounds to
    n_elec across most of the gap, so the reference's mu stops where the
    HOMO deficit is one f32 ulp of n_elec, and the clamped Newton steps
    cannot move it: its energy then depends on the f32 summation order at
    the 1e-7 Ha level (Diels-Alder, S8). Counting in f64 puts mu where
    n(mu) = n_elec, the same root wherever the reference is well
    conditioned, and the same energy on every device."""
    if eps.dtype == torch.float64:
        eps32 = eps.to(torch.float32)
        a = eps32.amin(-1) - 1.0
        b = eps32.amax(-1) + 1.0
        for _ in range(40):
            m = 0.5 * (a + b)
            n_m = (2.0 * torch.sigmoid(
                -(eps - m.to(torch.float64)[:, None]) / kt)).sum(-1)
            too_few = n_m < n_elec
            a, b = torch.where(too_few, m, a), torch.where(too_few, b, m)
        mu = (0.5 * (a + b)).to(torch.float64)
        for _ in range(4):
            x = torch.sigmoid(-(eps - mu[:, None]) / kt)
            n_mu = (2.0 * x).sum(-1)
            dn = (2.0 * x * (1.0 - x)).sum(-1) / kt
            step = (n_mu - n_elec) / dn.clamp(min=1e-30)
            mu = mu - step.clamp(-1e-5, 1e-5)
        return 2.0 * torch.sigmoid(-(eps - mu[:, None]) / kt), mu

    a = eps.amin(-1) - 1.0
    b = eps.amax(-1) + 1.0
    for _ in range(n_iter):
        m = 0.5 * (a + b)
        too_few = (2.0 * torch.sigmoid(-(eps - m[:, None]) / kt)).sum(-1) \
            < n_elec
        a, b = torch.where(too_few, m, a), torch.where(too_few, b, m)
    mu = 0.5 * (a + b)
    return 2.0 * torch.sigmoid(-(eps - mu[:, None]) / kt), mu


def _inv_sqrt_newton_schulz(s, n_iter=34):
    """S^{-1/2} of SPD matrices (B, M, M) by the coupled Newton-Schulz
    iteration from Y0 = S/c, Z0 = I, c the Gershgorin row-sum bound."""
    eye = torch.eye(s.shape[-1], dtype=s.dtype, device=s.device)
    c = s.abs().sum(-1).amax(-1)[:, None, None] + 1e-30
    y, z = s / c, eye.expand_as(s)
    for _ in range(n_iter):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    return z / torch.sqrt(c)


def _sym_solve(a, b):
    """Solve the symmetric bordered EEQ systems a x = b (b (B, n)): f64
    through one eigh (`eigh_solve`, whose implicit-function backward reuses
    the factorization), f32 by LU."""
    if a.dtype == torch.float64:
        return eigh_solve(a, b)
    return torch.linalg.solve(a, b)


def _cg_raw(a, b):
    """Fixed-iteration CG on the normal equations (a (B,n,n), b (B,n)),
    3n iterations."""
    ata = a.mT @ a
    atb = bmv(a.mT, b)
    x = torch.zeros_like(b)
    r, p = atb, atb
    for _ in range(3 * a.shape[-1]):
        ap = bmv(ata, p)
        denom = (p * ap).sum(-1)
        rr = (r * r).sum(-1)
        ok = denom.abs() > 1e-300
        alpha = torch.where(ok, rr / torch.where(ok, denom, 1.0), 0.0)
        x = x + alpha[:, None] * p
        r_new = r - alpha[:, None] * ap
        ok_b = rr > 1e-300
        beta = torch.where(ok_b, (r_new * r_new).sum(-1)
                           / torch.where(ok_b, rr, 1.0), 0.0)
        r, p = r_new, r_new + beta[:, None] * p
    return x


class _CGSolve(torch.autograd.Function):
    """x = A^-1 b by `_cg_raw`; backward by the implicit-function adjoint:
    A^T lam = x_bar (one more CG), b_bar = lam, A_bar = -lam x^T."""

    @staticmethod
    def forward(ctx, a, b):
        x = _cg_raw(a, b)
        ctx.save_for_backward(a, x)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        a, x = ctx.saved_tensors
        lam = _cg_raw(a.mT, x_bar)
        return -lam[..., :, None] * x[..., None, :], lam


def _cg_solve(a, b):
    return _CGSolve.apply(a, b)


def srb_energy(coords, z, k=_SRB_K, eta=_SRB_ETA, g_scal=_SRB_GSCAL,
               c1=_SRB_C1, c2=_SRB_C2, k_heavy=None):
    """GFN0 short-range bond correction (B,):
    E = k sum_{i<j} exp(-eta (1 + g dEN^2) (r - r_cov)^2),
    r_cov = (r0_i + r0_j)(1 - c1 dEN - c2 dEN^2)."""
    z_np = np.asarray(z)
    n = len(z_np)
    kind = dict(dtype=coords.dtype, device=coords.device)
    en = to_card(_SRB_EN[z_np], **kind)
    r0 = to_card(_SRB_R0[z_np], **kind)
    _, r2 = _pair_geometry(coords)
    r = torch.sqrt(r2 + 1e-12)
    den = (en[:, None] - en[None, :]).abs()
    r_cov = (r0[:, None] + r0[None, :]) * (1.0 - c1 * den - c2 * den ** 2)
    expo = -eta * (1.0 + g_scal * den ** 2) * (r - r_cov) ** 2
    mask = torch.ones(n, n, dtype=torch.bool, device=coords.device).triu(1)
    if k_heavy is None:
        k_pair = k
    else:
        hv = (z_np > 2).astype(np.float64)
        k_pair = to_card(
            np.where(hv[:, None] * hv[None, :] > 0, k_heavy, k), **kind)
    return torch.where(mask, k_pair * torch.exp(expo), 0.0).sum((-2, -1))


@register_calculator("sqm")
class SQM(Calculator):
    """On-device semiempirical backend (H-Ar), batched over structures."""

    on_device = True

    def __init__(self, charge=0, multiplicity=1, kt=_FERMI_KT,
                 rep_k=_REP_K, rep_r0_scale=_REP_R0_SCALE, rep_hh=_REP_HH,
                 srb=False, device=None, **kw):
        # tensor-parallel hook: with a mesh set, every call builds the
        # O(N^2) pair geometry and overlap blocks in row blocks, one per
        # shard of `tp_axis` (`_tp_shard_rows`); the rest runs once, on the
        # mesh's first device (parallel.mesh.tp_energy_and_gradient)
        self.tp_mesh = kw.pop("tp_mesh", None)
        self.tp_axis = str(kw.pop("tp_axis", "tp"))
        if self.tp_mesh is not None:
            check_mesh(self.tp_mesh, self.tp_axis)
        super().__init__(charge=charge, multiplicity=multiplicity,
                         device=device, **kw)
        self.kt = float(kt)
        self.rep_k = float(rep_k)
        self.rep_r0_scale = float(rep_r0_scale)
        self.rep_hh = float(rep_hh)
        self.srb = bool(srb)
        self.k_ss = float(kw.pop("k_ss", _K_WH))
        self.k_sp = float(kw.pop("k_sp", _K_SP))
        self.k_pp = float(kw.pop("k_pp", _K_PP))
        self.k_cn_s = float(kw.pop("k_cn_s", 0.0))
        self.k_cn_p = float(kw.pop("k_cn_p", 0.0))
        self.k_q = float(kw.pop("k_q", 0.0))
        self.k_q2 = float(kw.pop("k_q2", 0.0))
        self.k_sp_heavy = float(kw.pop("k_sp_heavy", self.k_sp))
        self.k_en = float(kw.pop("k_en", 0.0))
        self.srb_k_heavy = kw.pop("srb_k_heavy", None)
        # the band's eigensolver knob, read as ops/eigh64.plan reads it
        # for the caller "band"
        impl = kw.pop("eigh_impl", "auto")
        self.eigh_impl = impl if callable(impl) else str(impl)
        self.dispersion = str(kw.pop("dispersion", "d2"))
        self.use_d = bool(kw.pop("use_d", False))
        self.k_sd = float(kw.pop("k_sd", 1.0))
        self.k_pd = float(kw.pop("k_pd", 1.0))
        self.k_dd = float(kw.pop("k_dd", 1.0))
        self.k_d_en = float(kw.pop("k_d_en", 1.35))
        self.zeta_scale = kw.pop("zeta_scale", (1.0, 1.0, 1.0))
        self.rep_r0_heavy_scale = kw.pop("rep_r0_heavy_scale", None)
        self.rep_r0_23_scale = kw.pop("rep_r0_23_scale", None)
        self.rep_r0_33_scale = kw.pop("rep_r0_33_scale", None)
        self.rep_cn = kw.pop("rep_cn", 0.0)
        self.rep_hh_gem = kw.pop("rep_hh_gem", 0.0)
        self.h_d_shift = kw.pop("h_d_shift", 0.0)
        self._static_cache = {}

    def _tp_shard_rows(self, build, coords):
        """A pair build `build(x, rows)` -> (B, R, N, ...) of the atom rows
        `rows` (a slice) against all N atoms, for every row of `coords`.
        Without a mesh, one call. With `tp_mesh`, the N rows split into one
        contiguous block per shard, the first N mod k one row longer
        (torch.tensor_split); each block is built on its shard's device
        from a copy of `coords`, copied to the mesh's first device (where
        `coords` must lie) and concatenated along dim 1 in shard order.
        Autograd sums each shard's gradient back into `coords`."""
        if self.tp_mesh is None:
            return build(coords, ALL_ROWS)
        home = mesh_device(check_mesh(self.tp_mesh, self.tp_axis),
                           coords.device)
        sizes = [len(r) for r in torch.arange(coords.shape[1]).tensor_split(
            self.tp_mesh.size)]
        starts = np.cumsum([0] + sizes)
        return torch.cat([build(coords.to(dev), slice(lo, hi)).to(home)
                          for dev, lo, hi in zip(self.tp_mesh.devices,
                                                 starts[:-1], starts[1:])],
                         dim=1)

    def energy(self, coords, z):
        t = self.energy_terms(coords, z)
        return t["eht"] + t["eeq"] + t["rep"] + t["disp"] + t["srb"]

    def hessian(self, coords, z):
        """Seminumerical: central differences (step 1e-4 Bohr) of the
        analytic gradient, 6N displaced gradients per structure in one
        batch. (The reference's seeded-eigh 1e-3 branch exists only for the
        TPU's emulated f64.)"""
        return self.numerical_hessian(coords, z, step=1e-4)

    def _layout(self, z_np):
        """Per-molecule static arrays (numpy float64, as the reference
        builds them at trace time) plus python scalars."""
        n = len(z_np)
        nob = 9 if (self.use_d and _T["has_d"][z_np].any()) else 4
        lay = _basis_params(z_np, self.zeta_scale)
        lay.update(chi=_T["chi"][z_np], eta=_T["eta"][z_np],
                   r_q=_T["r_q"][z_np], c2s_d=_C2S_D,
                   rcov=np.asarray(COVALENT_RADII_1)[z_np],
                   z_eff=_T["z_eff"][z_np], c6=_T["c6"][z_np],
                   rr0=_T["r0"][z_np], cn0=_REP_CN0[z_np])
        h_cols = [_T["h_s"][z_np]] + [_T["h_p"][z_np]] * 3
        if nob == 9:
            h_cols += [_T["h_d"][z_np]] * 5
        lay["h_diag"] = (np.stack(h_cols, axis=1) / HARTREE2EV).reshape(-1)
        if nob == 9:
            lay["d_mask"] = (np.tile([0.0] * 4 + [1.0] * 5, n)
                             * np.repeat(_T["has_d"][z_np], 9))
            lay["d_col"] = np.array([0.0] * 4 + [1.0] * 5)
        lay["diag_mask"] = np.kron(np.eye(n), np.ones((nob, nob)))
        lay["eye_blocks"] = np.kron(np.eye(n), np.eye(nob))
        valid_cols = [np.ones(n)] + [_T["has_p"][z_np]] * 3
        if nob == 9:
            valid_cols += [_T["has_d"][z_np]] * 5
        lay["valid"] = np.stack(valid_cols, axis=1).reshape(-1)

        # per-orbital-pair Wolfsberg-Helmholz constants, s-p resolved by
        # the element pair, d pairs enhanced by dEN^2
        shell_of_orb = [0, 1, 1, 1] + ([2] * 5 if nob == 9 else [])
        shell_idx = np.tile(shell_of_orb, n)
        si, sj = shell_idx[:, None], shell_idx[None, :]
        k_lookup = np.array([[self.k_ss, self.k_sp, self.k_sd],
                             [self.k_sp, self.k_pp, self.k_pd],
                             [self.k_sd, self.k_pd, self.k_dd]])
        k_pair = k_lookup[si, sj]
        heavy = np.repeat((z_np > 2).astype(np.float64), nob)
        is_sp = ((si == 0) & (sj == 1)) | ((si == 1) & (sj == 0))
        k_pair = np.where(is_sp & (heavy[:, None] * heavy[None, :] > 0),
                          self.k_sp_heavy, k_pair)
        if nob == 9:
            en_orb_d = np.repeat(_PAULING_EN[z_np], nob)
            den2_d = (en_orb_d[:, None] - en_orb_d[None, :]) ** 2
            k_pair = np.where((si == 2) | (sj == 2),
                              k_pair + self.k_d_en * den2_d, k_pair)
        if _param_active(self.k_en):
            en_orb = np.repeat(_PAULING_EN[z_np], nob)
            k_pair = k_pair * (1.0 + self.k_en
                               * (en_orb[:, None] - en_orb[None, :]) ** 2)
        lay["k_pair"] = k_pair

        heavy_at = (z_np > 2).astype(np.float64)
        lay["hv_pair"] = heavy_at[:, None] * heavy_at[None, :] > 0
        if self.rep_r0_heavy_scale is not None:
            s22 = self.rep_r0_heavy_scale
            s33 = (self.rep_r0_33_scale if self.rep_r0_33_scale is not None
                   else self.rep_r0_scale)
            s23 = (self.rep_r0_23_scale if self.rep_r0_23_scale is not None
                   else 0.5 * (s22 + s33))
            row3 = (z_np > 10).astype(np.float64)
            n3 = row3[:, None] + row3[None, :]
            lay["scale_pair"] = np.where(n3 == 0, s22,
                                         np.where(n3 == 1, s23, s33))
        is_h = (z_np == 1).astype(np.float64)
        lay["hh"] = is_h[:, None] * is_h[None, :]

        e_ref = 0.0
        for zi in z_np:
            nv = _T["n_val"][zi]
            es = _T["h_s"][zi] / HARTREE2EV
            ep = _T["h_p"][zi] / HARTREE2EV
            e_ref += min(nv, 2.0) * es + max(nv - 2.0, 0.0) * ep
        scalars = dict(nob=nob, e_ref=e_ref,
                       n_elec=float(np.sum(_T["n_val"][z_np]) - self.charge))
        return lay, scalars

    def _static(self, z_np, device, dtype):
        key = (tuple(int(v) for v in z_np), str(device), dtype)
        hit = self._static_cache.get(key)
        if hit is None:
            lay, scalars = self._layout(z_np)
            hit = (params_from_numpy(lay, device, dtype), scalars)
            self._static_cache[key] = hit
        return hit

    def energy_terms(self, coords, z):
        """Energy components of a batch (B,N,3): each (B,), plus the EEQ
        charges (B,N)."""
        z_np = np.asarray(z.cpu() if isinstance(z, torch.Tensor) else z)
        b, n, _ = coords.shape
        dtype, dev = coords.dtype, coords.device
        prm, sc = self._static(z_np, dev, dtype)
        nob = sc["nob"]
        eye_n = torch.eye(n, dtype=dtype, device=dev)
        eye_nb = eye_n.bool()
        off = ~eye_nb

        # ---- EEQ electrostatics (first: the charges feed the D4 term) ----
        with span("sqm.eeq"):
            r2 = self._tp_shard_rows(
                lambda x, rows: _pair_geometry(x, rows)[1], coords)
            r = torch.sqrt(r2 + eye_n)
            chi, eta, r_q = prm["chi"], prm["eta"], prm["r_q"]
            gamma2 = r_q[:, None] ** 2 + r_q[None, :] ** 2
            j_off = 1.0 / torch.sqrt(r * r + gamma2)
            diag = eta + math.sqrt(2.0 / math.pi) / r_q
            a_mat = torch.where(eye_nb, diag[None, :] * torch.ones_like(eye_n),
                                j_off)
            ones = coords.new_ones((b, n, 1))
            big = torch.cat([torch.cat([a_mat, ones], dim=-1),
                             torch.cat([ones.mT, coords.new_zeros((b, 1, 1))],
                                       dim=-1)], dim=-2)
            rhs = torch.cat([-chi.expand(b, n),
                             coords.new_full((b, 1), float(self.charge))], -1)
            q = _sym_solve(big, rhs)[:, :n]
            e_eeq = (chi * q).sum(-1) + 0.5 * (
                q * bmv(a_mat, q)).sum(-1)

        # ---- overlap & Hamiltonian ----------------------------------------
        with span("sqm.hamiltonian"):
            s_blocks = self._tp_shard_rows(                  # (B,N,N,nob,nob)
                lambda x, rows: _overlap_full(
                    x, self._static(z_np, x.device, dtype)[0], nob, rows),
                coords)
            h_diag = prm["h_diag"]
            if nob == 9 and _param_active(self.h_d_shift):
                h_diag = h_diag + (self.h_d_shift / HARTREE2EV) * prm["d_mask"]
            if _param_active(self.k_cn_s, self.k_cn_p, self.k_q, self.k_q2):
                rcov = prm["rcov"]
                rc_ij = rcov[:, None] + rcov[None, :]
                cn = torch.where(off, 1.0 / (1.0 + torch.exp(
                    -16.0 * (rc_ij / r - 1.0))), 0.0).sum(-1)
                shift_s = -self.k_cn_s * cn - self.k_q * q - self.k_q2 * q * q
                shift_p = -self.k_cn_p * cn - self.k_q * q - self.k_q2 * q * q
                h_diag = h_diag + torch.stack(
                    [shift_s] + [shift_p] * (nob - 1), dim=-1).reshape(b, -1)
            m = nob * n
            s_mat = s_blocks.permute(0, 1, 3, 2, 4).reshape(b, m, m)
            if nob == 9:
                # congruence D S D switching the d shells off under compression
                rcov_d = prm["rcov"]
                ratio = r / (rcov_d[:, None] + rcov_d[None, :])
                sig = torch.where(eye_nb, 1.0,
                                  torch.sigmoid((ratio - 0.7) / 0.04))
                f_at = torch.exp(torch.log(sig + 1e-300).sum(-1))   # (B,N)
                d_col = prm["d_col"]
                v = (1.0 - d_col + d_col * f_at[..., None]).reshape(b, m)
                s_mat = v[:, :, None] * s_mat * v[:, None, :]
            # same-atom blocks: exact orthonormality of the minimal basis
            s_mat = s_mat * (1.0 - prm["diag_mask"]) + prm["eye_blocks"]
            # atoms without p/d shells carry decoupled placeholder orbitals
            valid = prm["valid"]
            vv = valid[:, None] * valid[None, :]
            s_mat = s_mat * vv + torch.diag(1.0 - valid)

            h_mat = 0.5 * prm["k_pair"] * (h_diag[..., :, None]
                                           + h_diag[..., None, :]) * s_mat
            eye_m = torch.eye(m, dtype=dtype, device=dev)
            h_mat = torch.where(eye_m.bool(), h_diag[..., None, :], h_mat * vv)

        # ---- Loewdin orthogonalization and band energy --------------------
        with span("sqm.loewdin"):
            s_reg = s_mat + 1e-10 * eye_m
            if dtype == torch.float64:
                s_inv_sqrt = inv_sqrt_psd(s_reg)
            else:
                s_inv_sqrt = _inv_sqrt_newton_schulz(s_reg)
            h_prime = s_inv_sqrt @ h_mat @ s_inv_sqrt
            h_prime = 0.5 * (h_prime + h_prime.mT)
        with span("sqm.band"):
            e_bs = _band_free_energy(h_prime, sc["n_elec"], self.kt,
                                     self.eigh_impl)
            e_eht = e_bs - sc["e_ref"]

        # ---- repulsion -----------------------------------------------------
        with span("sqm.classical"):
            z_eff, rcov = prm["z_eff"], prm["rcov"]
            rc_sum = rcov[:, None] + rcov[None, :]
            r0_ij = self.rep_r0_scale * rc_sum
            if self.rep_r0_heavy_scale is not None:
                r0_ij = torch.where(prm["hv_pair"], prm["scale_pair"] * rc_sum,
                                    r0_ij)
            if _param_active(self.rep_cn):
                cn = d3_coordination_numbers(coords, z_np)
                dev_cn = torch.clamp(prm["cn0"] - cn, -1.5, 1.0)
                f_cn = 1.0 + self.rep_cn * 0.5 * (dev_cn[:, :, None]
                                                  + dev_cn[:, None, :])
                f_cn = torch.clamp(f_cn, 0.7, 1.4)
                r0_ij = torch.where(prm["hv_pair"], r0_ij * f_cn, r0_ij)
            e_rep_pair = (self.rep_k * z_eff[:, None] * z_eff[None, :] / r
                          * torch.exp(-(r / r0_ij) ** _REP_EXP))
            hh = prm["hh"]
            e_rep_pair = e_rep_pair + (self.rep_hh * hh / r
                                       * torch.exp(-(r / 1.1) ** 2))
            if _param_active(self.rep_hh_gem):
                e_rep_pair = e_rep_pair + (
                    self.rep_hh_gem * hh
                    * torch.exp(-((r - 2.8) / 0.45) ** 2))
            e_rep = 0.5 * torch.where(off, e_rep_pair, 0.0).sum((-2, -1))

            # ---- dispersion --------------------------------------------
            if self.dispersion == "d4":
                e_disp = d4_energy(coords, z_np, charges=q)
            else:
                c6, rr0 = prm["c6"], prm["rr0"]
                c6_ij = torch.sqrt(c6[:, None] * c6[None, :])
                rr0_ij = rr0[:, None] + rr0[None, :]
                f_damp = 1.0 / (1.0 + torch.exp(-_D2_D * (r / rr0_ij - 1.0)))
                e_disp_pair = -_D2_S6 * c6_ij / r ** 6 * f_damp
                e_disp = 0.5 * torch.where(off, e_disp_pair, 0.0).sum((-2, -1))

            e_srb = (srb_energy(coords, z_np, k_heavy=self.srb_k_heavy)
                     if self.srb else coords.new_zeros(b))
        return {"eht": e_eht, "eeq": e_eeq, "rep": e_rep, "disp": e_disp,
                "srb": e_srb, "charges": q}


@register_calculator("sqm2")
class SQM2(SQM):
    """Second, higher-quality on-device semiempirical method: SQM with the
    GFN0 SRB term, charge-scaled D4 dispersion, pair-resolved Wolfsberg
    constants, d shells on row 3, row-pair-resolved heavy-heavy repulsion
    walls, the CN-dependent wall radius and the geminal H..H bump (see the
    reference's class docstring for the calibration battery)."""

    def __init__(self, charge=0, multiplicity=1, **kw):
        kw.setdefault("srb", True)
        kw.setdefault("dispersion", "d4")
        kw.setdefault("k_sp", 2.4)
        kw.setdefault("k_sp_heavy", 2.2)
        kw.setdefault("rep_hh", 0.2)
        kw.setdefault("use_d", True)
        kw.setdefault("rep_r0_heavy_scale", 0.36)   # 2p-2p
        kw.setdefault("rep_r0_23_scale", 0.39)      # 2p-3p
        kw.setdefault("rep_r0_33_scale", 0.46)      # 3p-3p
        kw.setdefault("rep_cn", 0.1)
        kw.setdefault("rep_hh_gem", 0.003)
        super().__init__(charge=charge, multiplicity=multiplicity, **kw)
