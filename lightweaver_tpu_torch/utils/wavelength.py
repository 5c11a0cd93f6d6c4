"""Wavelength and intensity unit conversions.

All internal wavelengths are vacuum nm; intensities J/s/m2/sr/Hz
(ref: lightweaver/utils.py:170-232, which delegates to
specutils/astropy; here the Edlen 1966 dispersion formula and the
spectral-density conversions are implemented directly).
"""
import numpy as np

from .. import constants as Const


def _edlen1966_n(vacNm):
    """Refractive index of standard air at vacuum wavelength [nm]
    (Edlen 1966)."""
    sigma2 = (1e3 / np.asarray(vacNm, np.float64)) ** 2   # [um^-2]
    return 1.0 + 1e-8 * (8342.13 + 2406030.0 / (130.0 - sigma2)
                         + 15997.0 / (38.9 - sigma2))


def vac_to_air(wavelength):
    """Vacuum wavelength [nm] -> standard-air wavelength [nm]."""
    wavelength = np.asarray(wavelength, np.float64)
    return wavelength / _edlen1966_n(wavelength)


def air_to_vac(wavelength, iterations: int = 5):
    """Standard-air wavelength [nm] -> vacuum [nm] (fixed-point on the
    Edlen 1966 formula)."""
    air = np.asarray(wavelength, np.float64)
    vac = air.copy()
    for _ in range(iterations):
        vac = air * _edlen1966_n(vac)
    return vac


# units expressed as (energy J, time s, area m^2, spectral-unit kind)
_INTENSITY_UNITS = {
    'J/s/m2/sr/Hz': ('Hz', 1.0),
    'W/m2/sr/Hz': ('Hz', 1.0),
    'erg/s/cm2/sr/Hz': ('Hz', 1e7 * 1e-4),
    'J/s/m2/sr/nm': ('nm', 1.0),
    'W/m2/sr/nm': ('nm', 1.0),
    'erg/s/cm2/sr/A': ('A', 1e7 * 1e-4),
    'erg/s/cm2/sr/Angstrom': ('A', 1e7 * 1e-4),
    'kW/m2/sr/nm': ('nm', 1e-3),
}


def convert_specific_intensity(wavelength, specInt, outUnits: str):
    """Convert specific intensity from the internal J/s/m2/sr/Hz to one of
    the common observational unit systems.

    Supported: %s
    """ % ', '.join(sorted(_INTENSITY_UNITS))
    if outUnits not in _INTENSITY_UNITS:
        raise ValueError(f'Unsupported unit "{outUnits}"; supported: '
                         f'{sorted(_INTENSITY_UNITS)}')
    kind, scale = _INTENSITY_UNITS[outUnits]
    lam = np.asarray(wavelength, np.float64) * Const.NM_TO_M     # [m]
    I = np.asarray(specInt, np.float64)
    if kind == 'Hz':
        out = I
    else:
        # I_lambda = I_nu * c / lambda^2 (per metre), then per nm / per A
        I_m = I * Const.CLight / lam ** 2
        perUnit = {'nm': 1e-9, 'A': 1e-10}[kind]
        out = I_m * perUnit
    return out * scale
