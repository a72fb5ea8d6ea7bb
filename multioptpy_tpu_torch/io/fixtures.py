"""Built-in molecular fixtures for tests, examples and benchmarks.

The flagship end-to-end system is a real organic cycloaddition at the scale
the reference documents for its AutoTS pipeline (ref: test/README.md:37-40
runs aldol_rxn.xyz, test/diels_alder_rxn.xyz is the 22-atom C/H/O analogue):
butadiene + acrolein -> 3-cyclohexene-1-carbaldehyde, 18 atoms, C/H/O,
3N = 54. Geometries are generated from standard bond lengths/angles — they
are STARTING structures for optimization, not literature coordinates.
"""

import numpy as np

from multioptpy_tpu_torch.units import ANGSTROM2BOHR

__all__ = [
    "diels_alder_reactant",
    "s8_crown",
    "water_cluster",
]


def _rot(deg):
    a = np.radians(deg)
    return np.array([[np.cos(a), -np.sin(a), 0.0],
                     [np.sin(a), np.cos(a), 0.0],
                     [0.0, 0.0, 1.0]])


def _u(deg):
    a = np.radians(deg)
    return np.array([np.cos(a), np.sin(a), 0.0])


def diels_alder_reactant(separation=3.2):
    """Butadiene (s-cis) stacked under acrolein at `separation` Angstrom.

    Returns (coords_bohr (18,3) float64, z (18,) int). Atom order:
      0-3   diene carbons C1=C2-C3=C4 (C1/C4 terminal CH2)
      4-9   diene hydrogens (2 on C1, 1 on C2, 1 on C3, 2 on C4)
      10-12 acrolein carbons C1'(=CH2) C2'(=CH-) C3'(CHO)
      13    acrolein oxygen
      14-17 acrolein hydrogens (2 on C1', 1 on C2', 1 on C3')
    The new C-C bonds of the cycloaddition form between (C1, C1') and
    (C4, C2'): 0-based pairs (0, 10) and (3, 11).
    """
    r_cc_d, r_cc_s, r_ch, r_co = 1.34, 1.47, 1.09, 1.22

    # --- s-cis butadiene in the z=0 plane ------------------------------
    c2 = np.zeros(3)
    c3 = np.array([r_cc_s, 0.0, 0.0])
    c1 = c2 + r_cc_d * _u(120.0)
    c4 = c3 + r_cc_d * _u(60.0)
    # CH2 hydrogens sit at +-120 deg from the C1->C2 (C4->C3) bond
    h1a = c1 + r_ch * _u(300.0 + 120.0)
    h1b = c1 + r_ch * _u(300.0 - 120.0)
    h2 = c2 + r_ch * _u(-120.0)
    h3 = c3 + r_ch * _u(-60.0)
    h4a = c4 + r_ch * _u(240.0 + 120.0)
    h4b = c4 + r_ch * _u(240.0 - 120.0)
    diene = np.stack([c1, c2, c3, c4, h1a, h1b, h2, h3, h4a, h4b])
    diene_z = [6, 6, 6, 6, 1, 1, 1, 1, 1, 1]

    # --- acrolein (s-trans) in its own z=0 plane ------------------------
    c1p = np.zeros(3)
    c2p = c1p + r_cc_d * _u(0.0)
    c3p = c2p + r_cc_s * _u(60.0)
    o = c3p + r_co * _u(0.0)
    h1pa = c1p + r_ch * _u(120.0)
    h1pb = c1p + r_ch * _u(-120.0)
    h2p = c2p + r_ch * _u(-60.0)
    h3p = c3p + r_ch * _u(120.0)
    acro = np.stack([c1p, c2p, c3p, o, h1pa, h1pb, h2p, h3p])
    acro_z = [6, 6, 6, 8, 1, 1, 1, 1]

    # --- stack: align C1' over C1 and C2' over C4 -----------------------
    # diene terminal carbons c1, c4; put the dienophile plane parallel at
    # +separation in z, with its C=C centered over the c1..c4 gap
    mid_diene = 0.5 * (c1 + c4)
    mid_acro = 0.5 * (c1p + c2p)
    # rotate acrolein so its C1'->C2' axis matches C1->C4
    v_d = c4 - c1
    v_a = c2p - c1p
    ang = np.degrees(np.arctan2(v_d[1], v_d[0])
                     - np.arctan2(v_a[1], v_a[0]))
    acro = (acro - mid_acro) @ _rot(ang).T
    acro = acro + mid_diene + np.array([0.0, 0.0, separation])

    coords = np.concatenate([diene, acro]) * ANGSTROM2BOHR
    z = np.array(diene_z + acro_z, dtype=np.int64)
    return coords, z


def s8_crown(scale=1.0):
    """S8 crown (D4d) with the experimental-like r(SS) = 2.05 A shape."""
    R, h = 2.34 * scale, 0.49 * scale
    coords = np.array([[R * np.cos(k * np.pi / 4),
                        R * np.sin(k * np.pi / 4),
                        h * (-1.0) ** k] for k in range(8)]) * ANGSTROM2BOHR
    return coords, np.full(8, 16, dtype=np.int64)


def water_cluster(n, spacing=3.0):
    """n water molecules on a cubic grid (batched-ensemble workloads)."""
    rng = np.random.default_rng(7)
    side = int(np.ceil(n ** (1.0 / 3.0)))
    mono = np.array([[0.0, 0.0, 0.1173], [0.0, 0.7572, -0.4692],
                     [0.0, -0.7572, -0.4692]])
    out = []
    k = 0
    for i in range(side):
        for j in range(side):
            for l in range(side):
                if k >= n:
                    break
                off = np.array([i, j, l]) * spacing
                out.append(mono + off + rng.normal(scale=0.05, size=(3, 3)))
                k += 1
    coords = np.concatenate(out[:n]) * ANGSTROM2BOHR
    z = np.tile([8, 1, 1], n).astype(np.int64)
    return coords, z
