"""Physical constants (SI) used throughout lightweaver_tpu.

Values match CODATA as used by the reference implementation
(ref: Source/Constants.hpp) so that synthesized spectra are
directly comparable.  All quantities are SI unless suffixed otherwise.
"""

# Fundamental constants
CLight = 2.99792458e8          # Speed of light [m/s]
HPlanck = 6.6260755e-34        # Planck's constant [J s]
KBoltzmann = 1.380658e-23      # Boltzmann constant [J/K]
Amu = 1.6605402e-27            # Atomic mass unit [kg]
MElectron = 9.1093897e-31      # Electron mass [kg]
QElectron = 1.60217733e-19     # Electron charge [C]
Epsilon0 = 8.854187817e-12     # Vacuum permittivity [F/m]
Mu0 = 1.2566370614e-6          # Vacuum permeability [H/m]
RBohr = 5.29177349e-11         # Bohr radius [m]
ERydberg = 2.1798741e-18       # Rydberg energy (ion. energy of H) [J]
EV = 1.60217733e-19            # One electron-volt [J]
# Ionization energy of H- [J]
E_ION_HMIN = 0.754 * EV
Theta0 = 5.03974756e3          # log10(e) * eV / k [K^-1]
ABarH = 7.42e-41               # Polarizability of H [F m^2]
Log10 = 2.30258509299404568402

# Unit conversions
NM_TO_M = 1.0e-9
CM_TO_M = 1.0e-2
KM_TO_M = 1.0e3
ERG_TO_JOULE = 1.0e-7
G_TO_KG = 1.0e-3
MICRON_TO_NM = 1.0e3
MEGABARN_TO_M2 = 1.0e-22

Pi = 3.14159265358979
SqrtPi = 1.7724538509055159

# Derived
HC = HPlanck * CLight
TwoHC = 2.0 * HC / NM_TO_M**3
HC_K = HC / (KBoltzmann * NM_TO_M)
# hc/4pi prefactor used in line opacity (wavelength in nm convention)
HC_FOURPI = 0.25 * HC / Pi
FOURPI_HC = 1.0 / HC_FOURPI
FOURPI_H = 4.0 * Pi / HPlanck

VMICRO_CHAR = 3.0e3            # Characteristic microturbulence [m/s]

GSurface = 2.74e2               # Solar surface gravity [m/s^2]
