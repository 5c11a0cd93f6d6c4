"""Line broadening menu: composable natural/elastic broadening terms.

All broadeners are numpy (setup-time) callables producing [Nspace] rates;
the results feed the Voigt damping parameter computed at trace time.
ref: lightweaver/broadening.py, barklem.py
"""
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
from scipy.interpolate import RectBivariateSpline
from scipy.special import gamma as gamma_fn

from . import constants as Const
from .atomic_table import PeriodicTable

from ._data import DATA_DIR


@dataclass
class LineBroadeningResult:
    natural: np.ndarray
    Qelast: np.ndarray
    other: Optional[List] = None


@dataclass
class LineBroadener:
    """Base class for a single broadening term."""

    def setup(self, line):
        pass

    def broaden(self, atmos, eqPops) -> np.ndarray:
        raise NotImplementedError


@dataclass
class LineBroadening:
    """Groups broadening terms into natural and elastic (the split matters
    for PRD coherence fractions)."""
    natural: List[LineBroadener]
    elastic: List[LineBroadener]
    other: Optional[List[LineBroadener]] = None

    def setup(self, line):
        for b in self.natural + self.elastic + (self.other or []):
            b.setup(line)

    def broaden(self, atmos, eqPops) -> LineBroadeningResult:
        def total(terms):
            if not terms:
                return np.zeros_like(atmos.temperature)
            out = terms[0].broaden(atmos, eqPops)
            for t in terms[1:]:
                out = out + t.broaden(atmos, eqPops)
            return out

        other = None
        if self.other:
            other = [t.broaden(atmos, eqPops) for t in self.other]
        return LineBroadeningResult(natural=total(self.natural),
                                    Qelast=total(self.elastic),
                                    other=other)


@dataclass
class RadiativeBroadening(LineBroadener):
    """Constant radiative (natural) broadening Gamma."""
    gamma: float

    def broaden(self, atmos, eqPops):
        return np.full_like(atmos.temperature, self.gamma)


def _c625(line) -> float:
    """Unsold C6^{0.4} interaction constant for Vdw broadening."""
    Z = line.jLevel.stage + 1
    cont = line.overlyingContinuumLevel
    deltaR = ((Const.ERydberg / (cont.E_SI - line.jLevel.E_SI)) ** 2
              - (Const.ERydberg / (cont.E_SI - line.iLevel.E_SI)) ** 2)
    fourPiEps0 = 4.0 * np.pi * Const.Epsilon0
    return (2.5 * Const.QElectron ** 2 / fourPiEps0 * Const.ABarH / fourPiEps0
            * 2 * np.pi * (Z * Const.RBohr) ** 2 / Const.HPlanck * deltaR) ** 0.4


@dataclass
class VdwUnsold(LineBroadener):
    """Unsold van der Waals broadening by H and He.

    vals = (coefficient for H, coefficient for He).
    ref: lightweaver/broadening.py:185-236
    """
    vals: Sequence[float]

    def setup(self, line):
        if len(self.vals) != 2:
            raise ValueError('VdwUnsold expects 2 coefficients')
        self.line = line
        self.C625 = _c625(line)
        element = line.atom.element
        def vrel35(otherZ):
            return (8.0 * Const.KBoltzmann / (np.pi * Const.Amu * element.mass)
                    * (1.0 + element.mass / PeriodicTable[otherZ].mass)) ** 0.3
        self.vRel35H = vrel35(1)
        self.vRel35He = vrel35(2)

    def broaden(self, atmos, eqPops):
        heAbund = eqPops.abundance[PeriodicTable.element(2)]
        cross = 8.08 * (self.vals[0] * self.vRel35H
                        + self.vals[1] * heAbund * self.vRel35He) * self.C625
        nHGround = eqPops['H'][0, :]
        return cross * atmos.temperature ** 0.3 * nHGround


class BarklemCrossSectionError(Exception):
    pass


class _BarklemTable:
    def __init__(self, name, neff0):
        data = np.load(DATA_DIR / f'barklem_{name}.npz')['data']
        n = data.shape[0] // 2
        self.cross = data[:n]
        self.alpha = data[n:]
        self.neff1 = neff0[0] + np.arange(n) * 0.1
        self.neff2 = neff0[1] + np.arange(data.shape[1]) * 0.1


class Barklem:
    """ABO (Anstee, Barklem & O'Mara) cross-section tables for neutral-line
    H broadening; interpolated in effective quantum numbers."""
    _tables = None

    @classmethod
    def tables(cls):
        if cls._tables is None:
            cls._tables = {
                (0, 1): _BarklemTable('spdata', (1.0, 1.3)),
                (1, 2): _BarklemTable('pddata', (1.3, 2.3)),
                (2, 3): _BarklemTable('dfdata', (2.3, 3.3)),
            }
        return cls._tables

    @classmethod
    def get_active_cross_section(cls, atom, line, vals):
        result = [vals[0], vals[1], 0.0]
        if vals[0] < 20.0:
            if atom.levels[line.i].stage > 0:
                raise BarklemCrossSectionError('Atom is not neutral.')
            Ll, Lu = atom.levels[line.i].L, atom.levels[line.j].L
            if Ll is None or Lu is None:
                raise BarklemCrossSectionError('L not provided for levels.')
            key = (min(Ll, Lu), max(Ll, Lu))
            if abs(Ll - Lu) != 1 or key not in cls.tables():
                raise BarklemCrossSectionError('Not a valid shell combination.')
            table = cls.tables()[key]

            Z = atom.levels[line.j].stage + 1
            cont = line.overlyingContinuumLevel
            deltaEi = cont.E_SI - line.iLevel.E_SI
            deltaEj = cont.E_SI - line.jLevel.E_SI
            E_Ryd = Const.ERydberg / (1.0 + Const.MElectron
                                      / (atom.element.mass * Const.Amu))
            neff1 = Z * np.sqrt(E_Ryd / deltaEi)
            neff2 = Z * np.sqrt(E_Ryd / deltaEj)
            if Ll > Lu:
                neff1, neff2 = neff2, neff1
            if not (table.neff1[0] <= neff1 <= table.neff1[-1]):
                raise BarklemCrossSectionError('neff1 outside table.')
            if not (table.neff2[0] <= neff2 <= table.neff2[-1]):
                raise BarklemCrossSectionError('neff2 outside table.')
            result[0] = float(RectBivariateSpline(
                table.neff1, table.neff2, table.cross)(neff1, neff2)[0, 0])
            result[1] = float(RectBivariateSpline(
                table.neff1, table.neff2, table.alpha)(neff1, neff2)[0, 0])

        reducedMass = Const.Amu / (1.0 / PeriodicTable[1].mass
                                   + 1.0 / atom.element.mass)
        meanVel = np.sqrt(8.0 * Const.KBoltzmann / (np.pi * reducedMass))
        sigma, alpha = result[0], result[1]
        crossSection = sigma * Const.RBohr ** 2 * (meanVel / 1.0e4) ** (-alpha)
        result[0] = 2.0 * ((4.0 / np.pi) ** (alpha / 2.0)
                           * gamma_fn(2.0 - alpha / 2.0) * meanVel * crossSection)
        result[2] = 1.0
        return result


@dataclass
class VdwBarklem(LineBroadener):
    """Barklem (ABO theory) van der Waals broadening; He part from Unsold.

    ref: lightweaver/broadening.py:237-291
    """
    vals: Sequence[float]

    def setup(self, line):
        if len(self.vals) != 2:
            raise ValueError('VdwBarklem expects 2 coefficients')
        self.line = line
        self.barklemVals = Barklem.get_active_cross_section(
            line.atom, line, self.vals)
        self.C625 = _c625(line)
        element = line.atom.element
        self.vRel35He = (8.0 * Const.KBoltzmann / (np.pi * Const.Amu * element.mass)
                         * (1.0 + element.mass / PeriodicTable[2].mass)) ** 0.3

    def broaden(self, atmos, eqPops):
        heAbund = eqPops.abundance[PeriodicTable.element(2)]
        nHGround = eqPops['H'][0, :]
        cross = 8.08 * self.barklemVals[2] * heAbund * self.vRel35He * self.C625
        broad = (self.barklemVals[0]
                 * atmos.temperature ** (0.5 * (1.0 - self.barklemVals[1]))
                 + cross * atmos.temperature ** 0.3)
        return broad * nHGround


@dataclass
class VdwRidderRensbergen(LineBroadener):
    """Parametrised van der Waals broadening of de Ridder & van Rensbergen
    (1976, A&AS 23, 147): directly fitted per-line power laws

        Gamma = alphaH * 1e-8 cm^3/s * T^betaH * nH(ground)
              + alphaHe * 1e-8 cm^3/s * T^betaHe * nHe

    vals = (alphaH, betaH, alphaHe, betaHe), alphas in the RH 'PARAMTR'
    convention of 1e-8 cm^3 s^-1 (= 1e-14 m^3 s^-1).  The reference's
    converter accepts this vdW treatment (ConvertAtom.py:190-191) but
    its runtime lacks the broadener; we support it end-to-end."""
    vals: Sequence[float]

    def setup(self, line):
        if len(self.vals) != 4:
            raise ValueError('VdwRidderRensbergen expects 4 coefficients')
        self.line = line

    def broaden(self, atmos, eqPops):
        aH, bH, aHe, bHe = self.vals
        heAbund = eqPops.abundance[PeriodicTable.element(2)]
        nHGround = eqPops['H'][0, :]
        nHe = heAbund * atmos.nHTot
        T = atmos.temperature
        return 1e-14 * (aH * T ** bH * nHGround + aHe * T ** bHe * nHe)


@dataclass
class QuadraticStarkBroadening(LineBroadener):
    """Lindholm-theory quadratic Stark broadening by electrons and singly
    charged ions (C4 from Traving 1960, as in RH).
    ref: lightweaver/broadening.py:341-414
    """
    coeff: float

    def setup(self, line):
        self.line = line
        weight = line.atom.element.mass
        C = 8.0 * Const.KBoltzmann / (np.pi * Const.Amu * weight)
        Cm = (1.0 + weight / (Const.MElectron / Const.Amu)) ** (1.0 / 6.0)
        Cm += (1.0 + weight / 28.0) ** (1.0 / 6.0)  # 28: mean atomic weight
        self.C = C
        self.Cm = Cm

        Z = line.iLevel.stage + 1
        cont = line.overlyingContinuumLevel
        E_Ryd = Const.ERydberg / (1.0 + Const.MElectron / (weight * Const.Amu))
        neff_l = Z * np.sqrt(E_Ryd / (cont.E_SI - line.iLevel.E_SI))
        neff_u = Z * np.sqrt(E_Ryd / (cont.E_SI - line.jLevel.E_SI))
        C4 = (Const.QElectron ** 2 / (4.0 * np.pi * Const.Epsilon0)
              * Const.RBohr
              * (2.0 * np.pi * Const.RBohr ** 2 / Const.HPlanck) / (18.0 * Z ** 4)
              * ((neff_u * (5.0 * neff_u ** 2 + 1.0)) ** 2
                 - (neff_l * (5.0 * neff_l ** 2 + 1.0)) ** 2))
        self.cStark23 = 11.37 * (self.coeff * C4) ** (2.0 / 3.0)

    def broaden(self, atmos, eqPops):
        vRel = (self.C * atmos.temperature) ** (1.0 / 6.0) * self.Cm
        return self.cStark23 * vRel * atmos.ne


@dataclass
class MultiplicativeStarkBroadening(LineBroadener):
    """Stark broadening as coeff * ne."""
    coeff: float

    def broaden(self, atmos, eqPops):
        return self.coeff * atmos.ne


@dataclass
class HydrogenLinearStarkBroadening(LineBroadener):
    """Linear Stark broadening of hydrogen lines (Sutton 1978).
    ref: lightweaver/broadening.py:455-509
    """

    def setup(self, line):
        self.line = line
        if line.atom.element.Z != 1:
            raise ValueError('HydrogenLinearStarkBroadening on non-H line')

    def broaden(self, atmos, eqPops):
        nUpper = int(np.round(np.sqrt(0.5 * self.line.jLevel.g)))
        nLower = int(np.round(np.sqrt(0.5 * self.line.iLevel.g)))
        a1 = 0.642 if nUpper - nLower == 1 else 1.0
        C = a1 * 0.6 * (nUpper ** 2 - nLower ** 2) * Const.CM_TO_M ** 2
        return C * atmos.ne ** (2.0 / 3.0)


@dataclass
class ScaledExponentBroadening(LineBroadener):
    """CRTAF ScaledExponents recipe: scaling * T**a * nH0**b * ne**c."""
    scaling: float
    temperatureExp: float
    hydrogenExp: float
    electronExp: float

    def broaden(self, atmos, eqPops):
        result = np.full_like(atmos.temperature, self.scaling)
        if self.temperatureExp != 0.0:
            result = result * atmos.temperature ** self.temperatureExp
        if self.hydrogenExp != 0.0:
            result = result * eqPops['H'][0, :] ** self.hydrogenExp
        if self.electronExp != 0.0:
            result = result * atmos.ne ** self.electronExp
        return result
