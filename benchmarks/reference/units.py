"""Unit system and physical constants.

The internal unit system follows the original ReaxFF convention used by the
reference implementation (ref: src/module.F90:176-202): length in Angstrom,
energy in kcal/mol, mass in amu.  Time unit is chosen so that these are
consistent: 1 internal time unit = 1/20.455 ps = 48.8878 fs.
"""

# Energy conversions (ref: module.F90:181-193)
EEV_KCAL = 23.060538          # eV -> kcal/mol

# Temperature units (ref: module.F90:198-199)
UTEMP0 = 503.398008           # K per (kcal/mol)
UTEMP = UTEMP0 * 2.0 / 3.0    # K (for <KE per atom> -> T)

# Stress / density / time (ref: module.F90:200-202)
USTRS = 6.94728103            # GPa
UDENS = 1.66053886            # g/cc
UTIME = 1.0e3 / 20.455        # fs per internal time unit (= 48.88780)

# Coulomb constants (ref: module.F90:681-684)
CCLMB0 = 332.0638             # kcal/mol * A  (Coulomb energy prefactor)
CCLMB0_QEQ = 14.4             # eV * A        (QEq hessian prefactor)
CECHRGE = 23.02               # eV -> kcal/mol used for the self-charge energy

# Taper cutoffs (ref: module.F90:281-283)
RCTAP0 = 10.0                 # A, standard taper cutoff
RCTAP0_PQEQ = 12.5            # A, PQEq taper cutoff

# Hydrogen-bond cutoff (ref: module.F90:677-678)
RCHB = 10.0
RCHB2 = RCHB * RCHB

# Bond-order thresholds (ref: module.F90:60-65)
MINBOSIG = 1e-3
MINBO0 = 1e-4
CUTOF2_ESUB = 1e-4
CUTOF2_BO = 1e-3

MAXANGLE = 0.999999999999
MINANGLE = -0.999999999999
NSMALL = 1e-10

# PQEq screening constant (ref: module.F90:298)
LAMBDA_PQEQ = 0.462770

# Number of entries in the tabulated nonbonded kernels (ref: module.F90:251)
NTABLE = 5000


def taper_coeffs(rctap: float):
    """Taper polynomial coefficients CTap(0:7) (ref: init.F90:36-38)."""
    return (
        1.0, 0.0, 0.0, 0.0,
        -35.0 / rctap ** 4,
        84.0 / rctap ** 5,
        -70.0 / rctap ** 6,
        20.0 / rctap ** 7,
    )
