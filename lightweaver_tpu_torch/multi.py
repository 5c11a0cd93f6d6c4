"""MULTI-format atmosphere reader.

ref: lightweaver/multi.py:20-112
"""
import re
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from . import constants as Const
from .atmosphere import Atmosphere, ScaleType


@dataclass
class MultiMetadata:
    """MULTI metadata with no Lightweaver equivalent (name, log g)."""
    name: str
    logG: float


def read_multi_atmos(filename: str) -> Tuple[MultiMetadata, Atmosphere]:
    """Load a MULTI atmosphere file: (dscale, T, ne, vlos, vturb) rows in
    cgs/km units on an M (column mass), T (tau500) or H (height) scale,
    followed by 6-level hydrogen populations."""
    try:
        with open(filename, 'r') as f:
            lines = f.readlines()
    except FileNotFoundError:
        raise ValueError(f'Atmosphere file not found ({filename})')

    def get_line(commentPattern=r'^\s*\*'):
        while lines:
            line = lines.pop(0)
            if not re.match(commentPattern, line):
                return line.strip()
        return None

    atmosName = get_line()
    scaleStr = get_line()
    logG = float(get_line()) - 2          # log[cm/s^2] -> log[m/s^2]
    Nspace = int(get_line())

    data = np.array([[float(v) for v in get_line().split()]
                     for _ in range(Nspace)])
    dscale, temp, ne, vlos, vturb = data[:, :5].T.copy()

    scaleMode = scaleStr[0].upper()
    if scaleMode == 'M':
        scaleType = ScaleType.ColumnMass
        dscale = 10.0 ** dscale * (Const.G_TO_KG / Const.CM_TO_M ** 2)
    elif scaleMode == 'T':
        scaleType = ScaleType.Tau500
        dscale = 10.0 ** dscale
    elif scaleMode == 'H':
        scaleType = ScaleType.Geometric
        dscale = dscale * Const.KM_TO_M
    else:
        raise ValueError(f'Unknown scale type: {scaleStr} '
                         '(expected M, T, or H)')

    vlos *= Const.KM_TO_M
    vturb *= Const.KM_TO_M
    ne /= Const.CM_TO_M ** 3

    if len(lines) < Nspace:
        raise ValueError('Hydrogen populations not supplied!')
    hPops = np.array([[float(v) for v in get_line().split()]
                      for _ in range(Nspace)]).T / Const.CM_TO_M ** 3

    meta = MultiMetadata(atmosName, logG)
    atmos = Atmosphere.make_1d(scale=scaleType, depthScale=dscale,
                               temperature=temp, vlos=vlos, vturb=vturb,
                               ne=ne, hydrogenPops=hPops)
    return meta, atmos
