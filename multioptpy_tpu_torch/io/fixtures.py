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
    "aldol_adduct",
    "alkane_chain",
    "aldol_reactant",
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


def aldol_reactant(separation=3.2):
    """Formaldehyde stacked over vinyl alcohol, the AutoTS test pair of the
    JAX package (its AFIR pushes: 95 kJ/mol on atoms (1,5) and 50 kJ/mol on
    (3,11), 1-indexed). 11 atoms, C/H/O, 3N = 33.

    Returns (coords_bohr (11,3) float64, z (11,) int). Atom order matches
    the reference fixture so its AFIR indices map 1:1:
      0 C  formaldehyde carbon          (ref atom 1)
      1 H  formaldehyde H
      2 O  formaldehyde oxygen          (ref atom 3)
      3 H  formaldehyde H
      4 C  enol terminal =CH2 carbon    (ref atom 5, the nucleophile)
      5 C  enol carbon bearing the OH
      6 H  on C4
      7 O  enol hydroxyl oxygen
      8 H  on C5
      9 H  on C4
     10 H  hydroxyl hydrogen            (ref atom 11, transfers to O2)
    The aldol addition forms C0-C4 and transfers H10 onto O2, giving
    3-hydroxypropanal. Geometry is generated from standard bond
    lengths/angles (a STARTING structure, not literature coordinates).
    """
    r_co_d, r_cc_d, r_co_s, r_ch, r_oh = 1.21, 1.33, 1.36, 1.09, 0.96

    # --- formaldehyde in the upper z = +separation/2 plane --------------
    zf = 0.5 * separation
    c0 = np.array([0.0, 0.0, zf])
    o2 = c0 + np.array([r_co_d, 0.0, 0.0])
    h1 = c0 + r_ch * np.array([np.cos(np.radians(150.0)),
                               np.sin(np.radians(150.0)), 0.0])
    h3 = c0 + r_ch * np.array([np.cos(np.radians(210.0)),
                               np.sin(np.radians(210.0)), 0.0])

    # --- vinyl alcohol in the lower plane, C4 under C0, OH side under
    # the carbonyl O so the 6-membered proton-transfer loop can close ---
    zv = -0.5 * separation
    c4 = np.array([0.0, 0.0, zv])
    c5 = c4 + np.array([r_cc_d, 0.0, 0.0])
    h6 = c4 + r_ch * np.array([np.cos(np.radians(120.0)),
                               np.sin(np.radians(120.0)), 0.0])
    h9 = c4 + r_ch * np.array([np.cos(np.radians(240.0)),
                               np.sin(np.radians(240.0)), 0.0])
    o7 = c5 + r_co_s * np.array([np.cos(np.radians(60.0)),
                                 np.sin(np.radians(60.0)), 0.0])
    h8 = c5 + r_ch * np.array([np.cos(np.radians(-60.0)),
                               np.sin(np.radians(-60.0)), 0.0])
    # hydroxyl H points up toward the carbonyl oxygen
    d = o2 - o7
    h10 = o7 + r_oh * d / np.linalg.norm(d)

    coords = np.stack([c0, h1, o2, h3, c4, c5, h6, o7, h8, h9, h10])
    z = np.array([6, 1, 8, 1, 6, 6, 1, 8, 1, 1, 1], dtype=np.int64)
    return coords * ANGSTROM2BOHR, z


def aldol_adduct():
    """3-hydroxypropanal, the aldol addition product of `aldol_reactant`
    (the basin the AFIR pushes drive toward). C0 becomes the carbinol
    carbon (O2-H10 hydroxyl), C5 the aldehyde carbon (C5=O7).

    Laid out in the SAME spatial frame as `aldol_reactant` (formaldehyde
    moiety above, enol-derived chain below, C0-C4 bond along ~z, O2-H10
    still hydrogen-bonded back to O7) so a basin-to-basin NEB between the
    two fixtures interpolates cleanly — an independently-framed conformer
    routes the interpolated path through atom clashes. Coordinates are a
    rounded relaxation product of this framework's own AFIR push on the
    reactant fixture (NOT literature values). Returns
    (coords_bohr (11,3) float64, z (11,) int); relax before use.
    """
    coords = np.array([
        [-0.19, 0.20, 0.70],    # C0 carbinol carbon
        [-1.06, 0.80, 1.02],    # H1
        [1.00, 0.96, 1.22],     # O2 hydroxyl oxygen (tilted up)
        [-0.25, -0.71, 1.33],   # H3
        [-0.09, -0.10, -0.90],  # C4
        [1.34, -0.15, -1.59],   # C5 aldehyde carbon
        [-0.69, 0.64, -1.48],   # H6
        [2.43, 0.23, -1.05],    # O7 carbonyl oxygen
        [1.45, -0.51, -2.64],   # H8
        [-0.63, -1.03, -1.15],  # H9
        [1.85, 0.88, 0.68],     # H10 on O2, H-bonded toward O7
    ])
    z = np.array([6, 1, 8, 1, 6, 6, 1, 8, 1, 1, 1], dtype=np.int64)
    return coords * ANGSTROM2BOHR, z


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


def alkane_chain(n_carbons):
    """All-anti n-alkane C_nH_{2n+2} with standard geometry (r(CC) 1.54 A,
    r(CH) 1.09 A, CCC 112 deg) — the procedural large-molecule scale
    fixture (~100 atoms at n=32). Returns (coords_bohr, z)."""
    d_cc, d_ch = 1.54, 1.09
    half = np.deg2rad(112.0) / 2.0
    dx, dz = d_cc * np.sin(half), d_cc * np.cos(half)
    c = np.array([[i * dx, 0.0, (i % 2) * dz] for i in range(n_carbons)])

    def _tet_h(center, u_nbrs, n_h):
        """n_h hydrogens tetrahedrally arranged around `center`, away from
        the unit vectors `u_nbrs` pointing at its carbon neighbors."""
        cosb, sinb = np.cos(np.deg2rad(109.47)), np.sin(np.deg2rad(109.47))
        if len(u_nbrs) == 2:  # CH2: pair in the +/-y half-planes
            b = -(u_nbrs[0] + u_nbrs[1])
            b /= np.linalg.norm(b)
            y = np.array([0.0, 1.0, 0.0])
            phi = np.deg2rad(107.5) / 2.0
            return [center + d_ch * (b * np.cos(phi) + s * y * np.sin(phi))
                    for s in (1.0, -1.0)]
        u = u_nbrs[0]  # CH3 (or CH4 core): cone around -u
        e1 = np.cross(u, [0.0, 1.0, 0.0])
        if np.linalg.norm(e1) < 1e-8:
            e1 = np.cross(u, [1.0, 0.0, 0.0])
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(u, e1)
        return [center + d_ch * (cosb * u + sinb *
                                 (np.cos(2 * np.pi * k / 3) * e1 +
                                  np.sin(2 * np.pi * k / 3) * e2))
                for k in range(n_h)]

    coords, z = list(c), [6] * n_carbons
    for i in range(n_carbons):
        nbrs = [j for j in (i - 1, i + 1) if 0 <= j < n_carbons]
        u_nbrs = [(c[j] - c[i]) / np.linalg.norm(c[j] - c[i]) for j in nbrs]
        n_h = 4 - len(nbrs)
        for h in _tet_h(c[i], u_nbrs, n_h):
            coords.append(h)
            z.append(1)
    return np.asarray(coords) * ANGSTROM2BOHR, np.asarray(z, dtype=np.int64)
