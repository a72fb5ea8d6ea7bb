"""Element data as Z-indexed dense arrays (one gather per structure).

Instead of the reference's per-element dict lookups
(ref: multioptpy/Parameters/{atomic_mass,covalent_radii,atomic_number,uff}.py)
all tables here are numpy float64 arrays indexed by atomic number Z, so that
a structure's per-atom parameters are a single `table[Z]` gather that jits
and vmaps. Index 0 is the dummy element "X".

Data sources (published constants, identical values to the reference):
- masses: NIST relative atomic masses of the most abundant isotopes.
- covalent radii: Pyykko & Atsumi, Chem. Eur. J. 15 (2009) 186 (single),
  15 (2009) 12770 (double); Pyykko, Riedel, Patzschke, Chem. Eur. J. 11
  (2005) 3511 (triple). Stored in Angstrom.
- UFF vdW parameters: Rappe et al., J. Am. Chem. Soc. 114 (1992) 10024.
"""

import numpy as np

from multioptpy_tpu_torch.units import ANGSTROM2BOHR, HARTREE2KCALMOL

SYMBOLS = [
    "X",
    "H", "He",
    "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar",
    "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr",
    "Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd",
    "In", "Sn", "Sb", "Te", "I", "Xe",
    "Cs", "Ba",
    "La", "Ce", "Pr", "Nd", "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er",
    "Tm", "Yb", "Lu",
    "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn",
]

MAX_Z = len(SYMBOLS) - 1  # 86 (H..Rn)

_SYMBOL_TO_Z = {s: i for i, s in enumerate(SYMBOLS)}
# case-insensitive aliases for parser robustness
_SYMBOL_TO_Z.update({s.lower(): i for i, s in enumerate(SYMBOLS)})
_SYMBOL_TO_Z.update({s.upper(): i for i, s in enumerate(SYMBOLS)})


def symbol_to_z(symbol):
    """Element symbol -> atomic number (ref: Parameters/atomic_number.py element_number)."""
    s = symbol.strip()
    if s.isdigit():
        return int(s)
    return _SYMBOL_TO_Z[s]


def z_to_symbol(z):
    return SYMBOLS[int(z)]


def symbols_to_z(symbols):
    """List of symbols -> int32 numpy array of atomic numbers."""
    return np.array([symbol_to_z(s) for s in symbols], dtype=np.int32)


# --- Isotopic masses (amu), Z = 0..86 -------------------------------------
MASS_AMU = np.array([
    0.0,
    1.00782503223, 4.00260325413,
    7.0160034366, 9.012183065, 11.00930536, 12.0, 14.00307400443,
    15.99491461957, 18.99840316273, 19.9924401762,
    22.989769282, 23.985041697, 26.98153853, 27.97692653465, 30.97376199842,
    31.9720711744, 34.968852682, 39.9623831237,
    38.9637064864, 39.962590863, 44.95590828, 47.94794198, 50.94395704,
    51.94050623, 54.93804391, 55.93493633, 58.93319429, 57.93534241,
    62.92959772, 63.92914201,
    68.9255735, 73.921177761, 74.92159457, 79.9165218, 78.9183376,
    83.9114977282,
    84.9117897379, 87.9056125, 88.9058403, 89.9046977, 92.906373,
    97.90540482, 96.9063667, 101.9043441, 102.905498, 105.9034804,
    106.9050916, 113.90336509,
    114.903878776, 119.90220163, 120.903812, 129.906222748, 126.9044719,
    131.9041550856,
    132.905451961, 137.905247,
    138.9063563, 139.9054431, 140.9076576, 141.907729, 144.9127559,
    151.9197397, 152.921238, 157.9241123, 158.9253547, 163.9291819,
    164.9303288, 165.9302995, 168.9342179, 173.9388664, 174.9407752,
    179.946557, 180.9479958, 183.95093092, 186.9557501, 191.961477,
    192.9629216, 194.9647917, 196.96656879, 201.9706434,
    204.9744278, 207.9766525, 208.9803991, 208.9824308, 209.9871479,
    222.0175782,
], dtype=np.float64)

# --- Covalent radii (Angstrom), Pyykko ------------------------------------
COVALENT_RADII_1_ANG = np.array([
    1.000,
    0.32, 0.46,
    1.33, 1.02, 0.85, 0.75, 0.71, 0.63, 0.64, 0.67,
    1.55, 1.39, 1.26, 1.16, 1.11, 1.03, 0.99, 0.96,
    1.96, 1.71, 1.48, 1.36, 1.34, 1.22, 1.19, 1.16, 1.11, 1.10, 1.12, 1.18,
    1.24, 1.24, 1.21, 1.16, 1.14, 1.17,
    2.10, 1.85, 1.63, 1.54, 1.47, 1.38, 1.28, 1.25, 1.25, 1.20, 1.28, 1.36,
    1.42, 1.40, 1.40, 1.36, 1.33, 1.31,
    2.32, 1.96,
    1.80, 1.63, 1.76, 1.74, 1.73, 1.72, 1.68, 1.69, 1.68, 1.67, 1.66, 1.65,
    1.64, 1.70, 1.62,
    1.52, 1.46, 1.37, 1.31, 1.29, 1.22, 1.23, 1.24, 1.33,
    1.44, 1.44, 1.51, 1.45, 1.47, 1.42,
], dtype=np.float64)

COVALENT_RADII_2_ANG = np.array([
    1.000,
    0.32, 0.46,
    1.24, 0.90, 0.78, 0.67, 0.60, 0.57, 0.59, 0.96,
    1.60, 1.32, 1.13, 1.07, 1.02, 0.94, 0.95, 1.07,
    1.93, 1.47, 1.16, 1.17, 1.12, 1.11, 1.05, 1.09, 1.03, 1.01, 1.15, 1.20,
    1.17, 1.11, 1.14, 1.07, 1.09, 1.21,
    2.02, 1.57, 1.30, 1.27, 1.25, 1.21, 1.20, 1.14, 1.10, 1.17, 1.39, 1.44,
    1.36, 1.30, 1.33, 1.28, 1.29, 1.35,
    2.09, 1.61,
    1.39, 1.37, 1.38, 1.37, 1.35, 1.34, 1.34, 1.35, 1.35, 1.33, 1.33, 1.33,
    1.31, 1.29, 1.31,
    1.28, 1.26, 1.20, 1.19, 1.16, 1.15, 1.12, 1.21, 1.42,
    1.42, 1.35, 1.41, 1.35, 1.38, 1.45,
], dtype=np.float64)

COVALENT_RADII_3_ANG = np.array([
    1.000,
    0.32, 0.46,
    1.24, 0.85, 0.73, 0.60, 0.54, 0.53, 0.53, 0.96,
    1.60, 1.27, 1.11, 1.02, 0.94, 0.95, 0.93, 0.96,
    1.93, 1.33, 1.14, 1.08, 1.06, 1.03, 1.03, 1.02, 0.96, 1.01, 1.20, 1.20,
    1.21, 1.21, 1.06, 1.07, 1.10, 1.08,
    2.02, 1.39, 1.24, 1.21, 1.16, 1.13, 1.10, 1.03, 1.06, 1.12, 1.37, 1.44,
    1.46, 1.32, 1.27, 1.21, 1.25, 1.22,
    2.09, 1.49,
    1.39, 1.31, 1.28, 1.37, 1.35, 1.34, 1.34, 1.32, 1.35, 1.33, 1.33, 1.33,
    1.31, 1.29, 1.31,
    1.21, 1.19, 1.15, 1.10, 1.09, 1.07, 1.10, 1.23, 1.42,
    1.50, 1.37, 1.35, 1.29, 1.38, 1.33,
], dtype=np.float64)

# Bohr versions (the internal unit)
COVALENT_RADII_1 = COVALENT_RADII_1_ANG * ANGSTROM2BOHR
COVALENT_RADII_2 = COVALENT_RADII_2_ANG * ANGSTROM2BOHR
COVALENT_RADII_3 = COVALENT_RADII_3_ANG * ANGSTROM2BOHR

# --- UFF Lennard-Jones parameters (ref: Parameters/uff.py:48,61,36) --------
UFF_VDW_R_ANG = np.array([
    3.851,  # dummy -> carbon-like default
    2.886, 2.362,
    2.451, 2.745, 4.083, 3.851, 3.660, 3.500, 3.364, 3.243,
    2.983, 3.021, 4.499, 4.295, 4.147, 4.035, 3.947, 3.868,
    3.812, 3.399, 3.295, 3.175, 3.144, 3.023, 2.961, 2.912, 2.872, 2.834,
    3.495, 2.763,
    4.383, 4.280, 4.230, 4.205, 4.189, 4.141,
    4.114, 3.641, 3.345, 3.124, 3.165, 3.052, 2.998, 2.963, 2.929, 2.899,
    3.148, 2.848,
    4.463, 4.392, 4.420, 4.470, 4.50, 4.404,
    4.517, 3.703,
    3.522, 3.556, 3.606, 3.575, 3.547, 3.520, 3.493, 3.368, 3.451, 3.428,
    3.409, 3.391, 3.374, 3.355, 3.640,
    3.141, 3.170, 3.069, 2.954, 3.120, 2.840, 2.754, 3.293, 2.705,
    4.347, 4.297, 4.370, 4.709, 4.750, 4.765,
], dtype=np.float64)

UFF_VDW_EPS_KCAL = np.array([
    0.010,
    0.0152, 0.056,
    0.025, 0.085, 0.095, 0.0951, 0.0774, 0.0957, 0.0725, 0.042,
    0.50, 0.111, 0.31, 0.31, 0.3200, 0.3440, 0.2833, 0.185,
    0.035, 0.05, 0.019, 0.0550, 0.016, 0.015, 0.013, 0.0550, 0.014, 0.015,
    0.005, 0.055,
    0.40, 0.40, 0.41, 0.43, 0.37, 0.220,
    0.04, 0.235, 0.072, 0.069, 0.059, 0.056, 0.048, 0.0500, 0.053, 0.048,
    0.036, 0.228,
    0.55, 0.55, 0.55, 0.57, 0.51, 0.332,
    0.045, 0.364,
    0.017, 0.013, 0.010, 0.010, 0.009, 0.008, 0.008, 0.009, 0.007, 0.007,
    0.007, 0.007, 0.006, 0.228, 0.041,
    0.072, 0.081, 0.067, 0.066, 0.037, 0.073, 0.080, 0.039, 0.385,
    0.680, 0.663, 0.518, 0.325, 0.284, 0.248,
], dtype=np.float64)

UFF_EFFECTIVE_CHARGE = np.array([
    0.0,
    0.712, 0.098,
    1.026, 1.565, 1.755, 1.912, 2.544, 2.300, 1.735, 0.194,
    1.081, 1.787, 1.792, 2.323, 2.863, 2.703, 2.348, 0.300,
    1.165, 2.141, 2.592, 2.659, 2.679, 2.463, 2.430, 2.430, 2.430, 2.430,
    1.756, 1.308,
    1.821, 2.789, 2.864, 2.764, 2.519, 0.452,
    1.592, 2.449, 3.257, 3.667, 3.618, 3.400, 3.400, 3.400, 3.508, 3.210,
    1.956, 1.650,
    2.070, 2.961, 2.704, 2.882, 2.650, 0.556,
    1.573, 2.727,
    3.300, 3.300, 3.300, 3.300, 3.300, 3.300, 3.300, 3.300, 3.300, 3.300,
    3.416, 3.300, 3.300, 2.618, 3.271,
    3.921, 4.075, 3.70, 3.70, 3.70, 3.731, 3.382, 2.625, 1.750,
    2.068, 2.846, 2.470, 2.330, 2.240, 0.583,
], dtype=np.float64)

# Pauling electronegativities H..Kr, Z-indexed; every element the
# reference's short-range correction doesn't tabulate falls back to 2.0
# and noble gases are 0.0 (ref: ModelHessian/shortrange.py:161-172
# `electronegativity` dict + `.get(element, 2.0)`).
PAULING_EN = np.full(MAX_Z + 1, 2.0, dtype=np.float64)
PAULING_EN[1:37] = [
    2.20, 0.00,
    0.98, 1.57, 2.04, 2.55, 3.04, 3.44, 3.98, 0.00,
    0.93, 1.31, 1.61, 1.90, 2.19, 2.58, 3.16, 0.00,
    0.82, 1.00, 1.36, 1.54, 1.63, 1.66, 1.55, 1.83, 1.88, 1.91,
    1.90, 1.65, 1.81, 2.01, 2.18, 2.55, 2.96, 0.00,
]

UFF_VDW_R = UFF_VDW_R_ANG * ANGSTROM2BOHR  # Bohr
UFF_VDW_EPS = UFF_VDW_EPS_KCAL / HARTREE2KCALMOL  # Hartree

MASS_AU = MASS_AMU * (1.66053906660e-27 / 9.1093837015e-31)  # electron masses


def covalent_radii(z, order=1, unit="bohr"):
    """Covalent radii for atomic numbers `z` (array-friendly).

    ref: Parameters/covalent_radii.py:6,19,33
    """
    table = {1: COVALENT_RADII_1_ANG, 2: COVALENT_RADII_2_ANG,
             3: COVALENT_RADII_3_ANG}[order]
    r = table[np.asarray(z)]
    if unit == "bohr":
        return r * ANGSTROM2BOHR
    return r


def atomic_masses(z, unit="amu"):
    """Isotopic masses for atomic numbers `z` (ref: Parameters/atomic_mass.py)."""
    m = MASS_AMU[np.asarray(z)]
    if unit == "au":
        return m * (1.66053906660e-27 / 9.1093837015e-31)
    return m
