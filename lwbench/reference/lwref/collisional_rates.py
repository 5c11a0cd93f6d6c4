"""Collisional rate menu: temperature-interpolated and formula-based rates.

All rates fill C[j, i, k] ([Nlevel, Nlevel, Nspace]) with C[i, j] the
downward j->i rate per upper-level atom.  Computed in numpy at setup /
per-iteration on host (they only depend on T, ne, nStar which change
rarely), mirrored from the reference
(ref: lightweaver/collisional_rates.py).

Temperature interpolation uses WENO-4 on the tabulated grid like the
reference (ref: collisional_rates.py:83), clamped non-negative.
"""
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
from scipy.special import exp1

from . import constants as Const
from .ops.weno import weno4


def interp_rates(T, Tgrid, rates):
    Tgrid = np.asarray(Tgrid, dtype=np.float64)
    if Tgrid.shape[0] < 2 or np.any(np.diff(Tgrid) <= 0):
        raise ValueError('Collision temperature grid must be increasing')
    C = weno4(T, Tgrid, rates)
    return np.maximum(C, 0.0)


@dataclass
class CollisionalRates:
    j: int
    i: int

    def setup(self, atom):
        i, j = self.i, self.j
        self.i = min(i, j)
        self.j = max(i, j)
        self.atom = atom
        self.iLevel = atom.levels[self.i]
        self.jLevel = atom.levels[self.j]

    def compute_rates(self, atmos, eqPops, Cmat):
        raise NotImplementedError


@dataclass
class TemperatureInterpolationRates(CollisionalRates):
    temperature: Sequence[float]
    rates: Sequence[float]

    def setup(self, atom):
        super().setup(atom)
        self.temperature = np.asarray(self.temperature, dtype=np.float64)
        self.rates = np.asarray(self.rates, dtype=np.float64)


@dataclass
class Omega(TemperatureInterpolationRates):
    """Collisional (de-)excitation of ions by electrons via Seaton's
    dimensionless collision strength."""

    def setup(self, atom):
        super().setup(atom)
        self.C0 = (Const.ERydberg / np.sqrt(Const.MElectron) * np.pi
                   * Const.RBohr ** 2 * np.sqrt(8.0 / (np.pi * Const.KBoltzmann)))

    def compute_rates(self, atmos, eqPops, Cmat):
        C = interp_rates(atmos.temperature, self.temperature, self.rates)
        nstar = eqPops.atomicPops[self.atom.element].nStar
        Cdown = (self.C0 * atmos.ne * C
                 / (self.jLevel.g * np.sqrt(atmos.temperature)))
        Cmat[self.i, self.j, :] += Cdown
        Cmat[self.j, self.i, :] += Cdown * nstar[self.j] / nstar[self.i]


@dataclass
class CI(TemperatureInterpolationRates):
    """Collisional ionisation by electrons [s^-1 K^-1/2 m^3]."""

    def setup(self, atom):
        super().setup(atom)
        self.dE = self.jLevel.E_SI - self.iLevel.E_SI

    def compute_rates(self, atmos, eqPops, Cmat):
        C = interp_rates(atmos.temperature, self.temperature, self.rates)
        nstar = eqPops.atomicPops[self.atom.element].nStar
        Cup = (C * atmos.ne
               * np.exp(-self.dE / (Const.KBoltzmann * atmos.temperature))
               * np.sqrt(atmos.temperature))
        Cmat[self.j, self.i, :] += Cup
        Cmat[self.i, self.j, :] += Cup * nstar[self.i] / nstar[self.j]


@dataclass
class CE(TemperatureInterpolationRates):
    """Collisional (de-)excitation of neutrals by electrons
    [s^-1 K^-1/2 m^3]."""

    def setup(self, atom):
        super().setup(atom)
        self.gij = self.iLevel.g / self.jLevel.g

    def compute_rates(self, atmos, eqPops, Cmat):
        C = interp_rates(atmos.temperature, self.temperature, self.rates)
        nstar = eqPops.atomicPops[self.atom.element].nStar
        Cdown = C * atmos.ne * self.gij * np.sqrt(atmos.temperature)
        Cmat[self.i, self.j, :] += Cdown
        Cmat[self.j, self.i, :] += Cdown * nstar[self.j] / nstar[self.i]


@dataclass
class CP(TemperatureInterpolationRates):
    """Collisional (de-)excitation by protons [s^-1 m^3]."""

    def compute_rates(self, atmos, eqPops, Cmat):
        C = interp_rates(atmos.temperature, self.temperature, self.rates)
        nProton = eqPops['H'][-1, :]
        nstar = eqPops.atomicPops[self.atom.element].nStar
        Cdown = C * nProton
        Cmat[self.i, self.j, :] += Cdown
        Cmat[self.j, self.i, :] += Cdown * nstar[self.j] / nstar[self.i]


@dataclass
class CH(TemperatureInterpolationRates):
    """Collisions with neutral hydrogen [s^-1 m^3] (upward tabulated)."""

    def compute_rates(self, atmos, eqPops, Cmat):
        C = interp_rates(atmos.temperature, self.temperature, self.rates)
        nh0 = eqPops['H'][0, :]
        nstar = eqPops.atomicPops[self.atom.element].nStar
        Cup = C * nh0
        Cmat[self.j, self.i, :] += Cup
        Cmat[self.i, self.j, :] += Cup * nstar[self.i] / nstar[self.j]


@dataclass
class ChargeExchangeNeutralH(TemperatureInterpolationRates):
    """Charge exchange with neutral H (downward only) [s^-1 m^3]."""

    def compute_rates(self, atmos, eqPops, Cmat):
        C = interp_rates(atmos.temperature, self.temperature, self.rates)
        nh0 = eqPops['H'][0, :]
        Cmat[self.i, self.j, :] += C * nh0


@dataclass
class ChargeExchangeProton(TemperatureInterpolationRates):
    """Charge exchange with protons (upward only) [s^-1 m^3]."""

    def compute_rates(self, atmos, eqPops, Cmat):
        C = interp_rates(atmos.temperature, self.temperature, self.rates)
        nProton = eqPops['H'][-1, :]
        Cmat[self.j, self.i, :] += C * nProton


def _fone(x):
    return np.where(x <= 50.0, np.exp(x) * exp1(x),
                    (1.0 - 1.0 / x + 2.0 / x ** 2) / x)


def _ftwo_scalar(x):
    p = np.array((1.0000e+00, 2.1658e+02, 2.0336e+04, 1.0911e+06, 3.7114e+07,
                  8.3963e+08, 1.2889e+10, 1.3449e+11, 9.4002e+11, 4.2571e+12,
                  1.1743e+13, 1.7549e+13, 1.0806e+13, 4.9776e+11, 0.0000))
    q = np.array((1.0000e+00, 2.1958e+02, 2.0984e+04, 1.1517e+06, 4.0349e+07,
                  9.4900e+08, 1.5345e+10, 1.7182e+11, 1.3249e+12, 6.9071e+12,
                  2.3531e+13, 4.9432e+13, 5.7760e+13, 3.0225e+13, 3.3641e+12))
    if x > 4.0:
        xf = x ** -np.arange(15)
        return (p @ xf) / ((q @ xf) * x ** 2)
    gamma = 0.5772156649
    f0x = np.pi ** 2 / 12.0
    term, count, fact, xFact = 1.0, 0.0, 1.0, 1.0
    while abs(term / f0x) > 1e-8:
        count += 1.0
        fact *= count
        xFact *= -x
        term = xFact / (count ** 2 * fact)
        f0x += term
        if count > 100.0:
            raise ValueError('ftwo too slow to converge')
    return np.exp(x) * ((np.log(x) + gamma) ** 2 * 0.5 + f0x)


_ftwo = np.vectorize(_ftwo_scalar)


@dataclass
class Ar85Cdi(CollisionalRates):
    """Collisional ionisation, Arnaud & Rothenflug (1985, ApJS 60)."""
    cdi: Sequence[Sequence[float]] = field(default_factory=list)

    def setup(self, atom):
        super().setup(atom)
        self.cdi = np.array(self.cdi)

    def compute_rates(self, atmos, eqPops, Cmat):
        nstar = eqPops.atomicPops[self.atom.element].nStar
        Cup = np.zeros(atmos.Nspace)
        cdi = self.cdi
        for m in range(cdi.shape[0]):
            xj = cdi[m, 0] * Const.EV / (Const.KBoltzmann * atmos.temperature)
            fac = np.exp(-xj) * np.sqrt(xj)
            fxj = (cdi[m, 1] + cdi[m, 2] * (1.0 + xj)
                   + (cdi[m, 3] - xj * (cdi[m, 1] + cdi[m, 2] * (2.0 + xj)))
                   * _fone(xj) + cdi[m, 4] * xj * _ftwo(xj))
            fxj *= fac
            Cup += 6.69e-7 / cdi[m, 0] ** 1.5 * fxj * Const.CM_TO_M ** 3
        Cup = np.maximum(Cup, 0.0) * atmos.ne
        Cdown = Cup * nstar[self.i] / nstar[self.j]
        Cmat[self.i, self.j, :] += Cdown
        Cmat[self.j, self.i, :] += Cup


@dataclass
class Burgess(CollisionalRates):
    """Collisional ionisation from excited states, Burgess & Chidichimo
    (1983, MNRAS 203, 1269)."""
    fudge: float = 1.0

    def compute_rates(self, atmos, eqPops, Cmat):
        nstar = eqPops.atomicPops[self.atom.element].nStar
        dE = (self.jLevel.E_SI - self.iLevel.E_SI) / Const.EV
        zz = self.iLevel.stage
        betaB = 0.25 * (np.sqrt((100.0 * zz + 91.0) / (4.0 * zz + 3.0)) - 5.0)
        cbar = 2.3
        dEkT = dE * Const.EV / (Const.KBoltzmann * atmos.temperature)
        dEkT = np.minimum(dEkT, 500)
        invdEkT = 1.0 / dEkT
        wlog = np.log(1.0 + invdEkT)
        wb = wlog ** (betaB / (1.0 + invdEkT))
        Cup = (2.1715e-8 * cbar * (13.6 / dE) ** 1.5 * np.sqrt(dEkT)
               * exp1(dEkT) * wb * atmos.ne * Const.CM_TO_M ** 3)
        Cup *= self.fudge
        Cdown = Cup * nstar[self.i, :] / nstar[self.j, :]
        Cmat[self.j, self.i, :] += Cup
        Cmat[self.i, self.j, :] += Cdown


def _johnson_gaunt_coeffs(n: int):
    """Bound-free Gaunt-factor fit coefficients g0, g1, g2 of Johnson
    (1972, ApJ 174, 227), eqs. 4-6."""
    if n == 1:
        return 1.1330, -0.4059, 0.07014
    if n == 2:
        return 1.0785, -0.2319, 0.02947
    return (0.9935 + 0.2328 / n - 0.1296 / n ** 2,
            -(0.6282 - 0.5598 / n + 0.5299 / n ** 2) / n,
            (0.3887 - 1.181 / n + 1.470 / n ** 2) / n ** 2)


def _johnson_bn(n: int) -> float:
    if n == 1:
        return -0.603
    return (4.0 - 18.63 / n + 36.24 / n ** 2 - 28.09 / n ** 3) / n


def _johnson_rn(n: int) -> float:
    return 0.45 if n == 1 else 1.94 * n ** -1.57


def johnson_fnn(n: int, nPrime: int) -> float:
    """Johnson (1972) absorption oscillator strength n -> n' of hydrogen
    (eq. 4).  Accurate to a few percent (exact f12 = 0.4162: this fit
    gives 0.4162)."""
    x = 1.0 - (n / nPrime) ** 2
    g0, g1, g2 = _johnson_gaunt_coeffs(n)
    g = g0 + g1 / x + g2 / x ** 2
    return 32.0 / (3.0 * np.sqrt(3.0) * np.pi) * n / (nPrime ** 3 * x ** 3) * g


def _expn2(t):
    """E2(t) = exp(-t) - t*E1(t), stable form via scipy."""
    from scipy.special import expn
    return expn(2, t)


def _principal_n(level) -> int:
    """Principal quantum number of a hydrogen model level from its
    statistical weight (g = 2 n^2)."""
    n = int(round(np.sqrt(level.g / 2.0)))
    if 2 * n ** 2 != int(round(level.g)):
        raise ValueError(
            f'Level {level.label!r} (g={level.g}) is not a full hydrogen '
            f'n-shell; Johnson (1972) rates need g = 2n^2')
    return n


@dataclass
class JohnsonCE(CollisionalRates):
    """Electron-impact excitation of hydrogen n -> n', Johnson (1972,
    ApJ 174, 227) eq. 36.  This is the data source behind the standard
    RH/MULTI hydrogen model atoms' tabulated CE rates (which the
    reference imports via Utils/ConvertAtom.py); here the formula is
    evaluated directly at the local temperature instead of interpolating
    a 5-point table."""

    def setup(self, atom):
        super().setup(atom)
        self.n = _principal_n(self.iLevel)
        self.nPrime = _principal_n(self.jLevel)
        if self.nPrime <= self.n:
            raise ValueError('JohnsonCE requires n(j) > n(i)')

    def compute_rates(self, atmos, eqPops, Cmat):
        from scipy.special import exp1
        n, nP = self.n, self.nPrime
        T = atmos.temperature
        x = 1.0 - (n / nP) ** 2
        f = johnson_fnn(n, nP)
        A = 2.0 * n ** 2 * f / x
        bn = _johnson_bn(n)
        B = 4.0 * n ** 4 / (nP ** 3 * x ** 2) * (1.0 + 4.0 / (3.0 * x)
                                                 + bn / x ** 2)
        # y = dE(n->n') / kT with dE = x * E_n (Rydberg ladder)
        En = Const.ERydberg / n ** 2
        y = np.minimum(x * En / (Const.KBoltzmann * T), 300.0)
        z = y + _johnson_rn(n) * x
        E1y, E1z = exp1(y), exp1(z)
        term = (A * ((1.0 / y + 0.5) * E1y - (1.0 / z + 0.5) * E1z)
                + (B - A * np.log(2.0 * n ** 2 / x))
                * (_expn2(y) / y - _expn2(z) / z))
        vBar = np.sqrt(8.0 * Const.KBoltzmann * T / (np.pi * Const.MElectron))
        Cup = (vBar * 2.0 * n ** 2 / x * np.pi * Const.RBohr ** 2
               * y ** 2 * term)
        Cup = np.maximum(Cup, 0.0) * atmos.ne
        nstar = eqPops.atomicPops[self.atom.element].nStar
        Cmat[self.j, self.i, :] += Cup
        Cmat[self.i, self.j, :] += Cup * nstar[self.i] / nstar[self.j]


@dataclass
class JohnsonCI(CollisionalRates):
    """Electron-impact ionisation of hydrogen from level n, Johnson
    (1972, ApJ 174, 227) eq. 39, with xi(t) = E0(t) - 2 E1(t) + E2(t)."""

    def setup(self, atom):
        super().setup(atom)
        self.n = _principal_n(self.iLevel)

    def compute_rates(self, atmos, eqPops, Cmat):
        from scipy.special import exp1
        n = self.n
        T = atmos.temperature
        g0, g1, g2 = _johnson_gaunt_coeffs(n)
        An = 32.0 * n / (3.0 * np.sqrt(3.0) * np.pi) * (g0 / 3.0 + g1 / 4.0
                                                        + g2 / 5.0)
        Bn = 2.0 / 3.0 * n ** 2 * (5.0 + _johnson_bn(n))
        En = Const.ERydberg / n ** 2
        y = np.minimum(En / (Const.KBoltzmann * T), 300.0)
        z = y + _johnson_rn(n)

        def xi(t):
            return np.exp(-t) / t - 2.0 * exp1(t) + _expn2(t)

        term = (An * (exp1(y) / y - exp1(z) / z)
                + (Bn - An * np.log(2.0 * n ** 2)) * (xi(y) - xi(z)))
        vBar = np.sqrt(8.0 * Const.KBoltzmann * T / (np.pi * Const.MElectron))
        Cup = vBar * 2.0 * n ** 2 * np.pi * Const.RBohr ** 2 * y ** 2 * term
        Cup = np.maximum(Cup, 0.0) * atmos.ne
        nstar = eqPops.atomicPops[self.atom.element].nStar
        Cmat[self.j, self.i, :] += Cup
        Cmat[self.i, self.j, :] += Cup * nstar[self.i] / nstar[self.j]


@dataclass
class VanRegemorter(CollisionalRates):
    """Collisional excitation of permitted lines via the van Regemorter
    (1962) formula with effective Gaunt factor (Mihalas 1978, eq. 5-75).
    Used as a standard fallback when no tabulated rates are available.
    Requires the oscillator strength f."""
    f: float = 0.0

    def compute_rates(self, atmos, eqPops, Cmat):
        nstar = eqPops.atomicPops[self.atom.element].nStar
        dE = self.jLevel.E_SI - self.iLevel.E_SI
        y = dE / (Const.KBoltzmann * atmos.temperature)
        E1y = exp1(np.minimum(y, 500.0))
        if self.iLevel.stage == 0:
            gbar_eff = 0.276 * E1y          # e^{-y} * (0.276 e^y E1(y))
        else:
            gbar_eff = np.maximum(0.276 * E1y, 0.2 * np.exp(-y))
        Cup = (atmos.ne * 5.465e-17 * np.sqrt(atmos.temperature)
               * 14.5 * self.f * (Const.ERydberg / dE) ** 2 * y * gbar_eff)
        Cdown = Cup * nstar[self.i] / nstar[self.j]
        Cmat[self.j, self.i, :] += Cup
        Cmat[self.i, self.j, :] += Cdown


@dataclass
class SeatonCI(CollisionalRates):
    """Collisional ionisation via Seaton's (1962) semi-empirical formula
    from the threshold photoionisation cross-section alpha0 [m^2]."""
    alpha0: float = 0.0

    def compute_rates(self, atmos, eqPops, Cmat):
        nstar = eqPops.atomicPops[self.atom.element].nStar
        dE = self.jLevel.E_SI - self.iLevel.E_SI
        y = dE / (Const.KBoltzmann * atmos.temperature)
        gbar = {0: 0.1, 1: 0.2}.get(self.iLevel.stage, 0.3)
        Cup = (atmos.ne * 1.55e11 / np.sqrt(atmos.temperature) * gbar
               * self.alpha0 * np.exp(-np.minimum(y, 500.0)) / y)
        Cdown = Cup * nstar[self.i] / nstar[self.j]
        Cmat[self.j, self.i, :] += Cup
        Cmat[self.i, self.j, :] += Cdown
