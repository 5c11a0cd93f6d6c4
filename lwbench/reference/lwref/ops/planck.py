"""Planck function in the framework's wavelength-in-nm convention.

B_nu as a function of (T, lambda[nm]) in J m^-2 s^-1 Hz^-1 sr^-1.
Port of lightweaver_tpu/ops/planck.py.
ref: Source/LwMisc.hpp:29-46
"""
import torch

from .. import constants as C

_MAX_EXPONENT = 150.0


def planck_nu(temperature, wavelength_nm):
    """B_nu(T, lambda). Broadcasts over both tensor arguments.

    temperature: [K], wavelength_nm: vacuum wavelength in nm.
    """
    hc_kla = C.HC_K / wavelength_nm
    twohnu3_c2 = C.TwoHC / wavelength_nm**3
    x = hc_kla / temperature
    xc = torch.clamp(x, max=_MAX_EXPONENT)
    B = twohnu3_c2 / (torch.exp(xc) - 1.0)
    return torch.where(x <= _MAX_EXPONENT, B, torch.zeros_like(B))
