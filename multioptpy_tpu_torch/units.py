"""Physical constants and unit conversions (CODATA-2018).

Values chosen to agree bit-for-bit with the reference tables
(ref: multioptpy/Parameters/unit_values.py:2-19) so that converged energies
and geometries are comparable at the 1e-8 Ha / 1e-5 Angstrom level.

Internal convention throughout the framework (same as the reference):
geometry in Bohr, energy in Hartree, gradient in Hartree/Bohr; trust radii
and step-size limits live in Angstrom at the driver boundary.
"""

# Energy
HARTREE2KCALMOL = 627.509
HARTREE2KJMOL = 2625.500
HARTREE2EV = 27.211396127707
HARTREE2J = 4.3597447222071e-18

# Length
BOHR2ANGSTROM = 0.52917721067
ANGSTROM2BOHR = 1.0 / BOHR2ANGSTROM
BOHR2M = 5.29177210903e-11

# Mass
AMU2KG = 1.66053906660e-27
AU2KG = 9.1093837015e-31
AMU2AU = AMU2KG / AU2KG  # electron masses per amu (~1822.888)

# Time
AU2SEC = 2.418884326505e-17
AU2FS = AU2SEC * 1.0e15

# Misc
MOL2AU = 6.02214076e23
DEG2RAD = 0.017453292519943295
BOLTZMANN_J_PER_K = 1.380649e-23
PLANCK_J_S = 6.62607015e-34
LIGHT_SPEED_M_S = 2.99792458e8
# Boltzmann constant in Hartree/K
KB_HARTREE = BOLTZMANN_J_PER_K / HARTREE2J


class UnitValueLib:
    """Attribute-compatible constants bundle (ref: Parameters/unit_values.py:2).

    Provided for users migrating from the reference API; new code should use
    the module-level constants.
    """

    def __init__(self):
        self.hartree2kcalmol = HARTREE2KCALMOL
        self.bohr2angstroms = BOHR2ANGSTROM
        self.hartree2kjmol = HARTREE2KJMOL
        self.hartree2eV = HARTREE2EV
        self.amu2kg = AMU2KG
        self.au2kg = AU2KG
        self.hartree2j = HARTREE2J
        self.bohr2m = BOHR2M
        self.mol2au = MOL2AU
        self.deg2rad = DEG2RAD
        self.au2sec = AU2SEC
        self.boltzmann_constant = BOLTZMANN_J_PER_K
        self.planck_constant = PLANCK_J_S
        self.vacume_light_speed = LIGHT_SPEED_M_S
