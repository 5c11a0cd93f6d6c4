"""FAL-C model atmosphere (Fontenla, Avrett & Loeser 1993), 82 points.

Data table extracted to data/falc82.npz; column mass scale with detailed
6-level hydrogen populations.  ref: lightweaver/fal.py
"""
from pathlib import Path

import numpy as np

from . import constants as Const
from .atmosphere import Atmosphere, ScaleType

from ._data import DATA_DIR


def Falc82() -> Atmosphere:
    d = np.load(DATA_DIR / 'falc82.npz')
    cmass = 10 ** d['cmass_log_cgs'] * Const.G_TO_KG / Const.CM_TO_M ** 2
    temp = d['temperature']
    ne = d['ne_cgs'] / Const.CM_TO_M ** 3
    vturb = d['vturb_kms'] * Const.KM_TO_M
    nh = d['nh_cgs'] / Const.CM_TO_M ** 3
    vlos = np.zeros_like(temp)
    return Atmosphere.make_1d(ScaleType.ColumnMass, depthScale=cmass,
                              temperature=temp, vlos=vlos, vturb=vturb,
                              ne=ne, hydrogenPops=nh)
