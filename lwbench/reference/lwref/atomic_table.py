"""Periodic table, abundances, and Kurucz partition functions.

Data tables are loaded from lightweaver_tpu/data/ (extracted from public
sources: Asplund et al. 2009 abundances, CIAAW masses, RH's Kurucz
partition function tables).  API mirrors the reference
(ref: lightweaver/atomic_table.py) with a leaner
implementation.
"""
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

from . import constants as Const

from ._data import DATA_DIR


@dataclass(frozen=True, order=True)
class Element:
    Z: int

    def __repr__(self):
        return f'Element(Z={self.Z} ({self.name}))'

    @property
    def name(self) -> str:
        return PeriodicTable[self.Z].name_str

    @property
    def mass(self) -> float:
        return _PT_SINGLETON.mass[self.Z]


@dataclass(frozen=True, order=True)
class Isotope:
    Z: int
    N: int

    @property
    def element(self) -> Element:
        return Element(self.Z)

    @property
    def name(self) -> str:
        return f'{self.N}{Element(self.Z).name}'

    @property
    def mass(self) -> float:
        return _PT_SINGLETON.isotope_mass[(self.N, self.Z)]


class _ElementView:
    """Element handle carrying its name and mass eagerly (avoids circular
    lookup during PeriodicTable construction)."""

    def __init__(self, Z, name, mass):
        self.Z = Z
        self.name_str = name
        self.mass = mass

    @property
    def name(self):
        return self.name_str


class _PeriodicTable:
    """Name/Z <-> Element lookups with mass data."""

    def __init__(self):
        with open(DATA_DIR / 'abundances_asplund09.json') as f:
            data = json.load(f)
        self.mass: Dict[int, float] = {}
        self.name_to_Z: Dict[str, int] = {}
        self.Z_to_name: Dict[int, str] = {}
        self.isotope_mass: Dict[tuple, float] = {}
        self.isotopes: Dict[int, list] = {}
        self._abund_raw: Dict[int, float] = {}
        for entry in data:
            Z = entry['Z']
            self.mass[Z] = entry['mass']
            self.name_to_Z[entry['name'].lower()] = Z
            self.Z_to_name[Z] = entry['name']
            self._abund_raw[Z] = entry['abundance']
            self.isotopes[Z] = []
            for iso in entry['isotopes']:
                self.isotope_mass[(iso['N'], Z)] = iso['mass']
                self.isotopes[Z].append((iso['N'], iso['proportion']))

    def __getitem__(self, key: Union[int, str, Element]) -> _ElementView:
        if isinstance(key, Element):
            Z = key.Z
        elif isinstance(key, _ElementView):
            Z = key.Z
        elif isinstance(key, int):
            Z = key
        elif isinstance(key, str):
            Z = self.name_to_Z[key.lower()]
        else:
            raise KeyError(key)
        return _ElementView(Z, self.Z_to_name[Z], self.mass[Z])

    def element(self, key: Union[int, str, Element]) -> Element:
        return Element(self[key].Z)

    @property
    def elements(self):
        return [Element(Z) for Z in sorted(self.Z_to_name)]


_PT_SINGLETON = _PeriodicTable()
PeriodicTable = _PT_SINGLETON


class AtomicAbundance:
    """Elemental abundances. Internally stored as decimal fraction relative
    to H (N_X / N_H).  ref: lightweaver/atomic_table.py:284-423
    """

    def __init__(self, abundanceData: Optional[Dict] = None, abundDex: bool = True,
                 metallicity: float = 0.0):
        self.abundance: Dict[Element, float] = {}
        for Z, dex in _PT_SINGLETON._abund_raw.items():
            self.abundance[Element(Z)] = dex
        if abundanceData is not None:
            for k, v in abundanceData.items():
                e = k if isinstance(k, Element) else PeriodicTable.element(k)
                self.abundance[e] = v if abundDex else self.decimal_to_dex(v)
        self.metallicity = metallicity
        if metallicity != 0.0:
            for e in self.abundance:
                if e.Z > 2:
                    self.abundance[e] += metallicity
        # convert dex -> decimal (relative to H = 1)
        for e in self.abundance:
            self.abundance[e] = 10 ** (self.abundance[e] - 12.0)
        self.compute_stats()

    @staticmethod
    def dex_to_decimal(dex):
        return 10 ** (dex - 12.0)

    @staticmethod
    def decimal_to_dex(dec):
        return np.log10(dec) + 12.0

    def compute_stats(self):
        totalAbund = 0.0
        avgMass = 0.0
        for e, a in self.abundance.items():
            totalAbund += a
            avgMass += a * e.mass
        self.totalAbundance = totalAbund
        self.massPerH = avgMass
        self.avgMass = avgMass / totalAbund

    def __getitem__(self, key) -> float:
        if isinstance(key, Element):
            e = key
        else:
            e = PeriodicTable.element(key)
        return self.abundance[e]


DefaultAtomicAbundance = AtomicAbundance()


@dataclass
class KuruczPf:
    """Kurucz partition function for one element.
    ref: lightweaver/atomic_table.py:423-597
    """
    element: Element
    abundance: float
    Tpf: np.ndarray
    pf: np.ndarray        # log(U) [Nstage, NT]
    ionPot: np.ndarray    # [Nstage] in J

    def lte_ionisation(self, atmos) -> np.ndarray:
        """LTE ionisation-stage populations [Nstage, Nspace] from repeated
        Saha equations with Kurucz partition functions."""
        Nstage = self.ionPot.shape[0]
        Nspace = atmos.Nspace
        C1 = (Const.HPlanck / (2.0 * np.pi * Const.MElectron)
              * Const.HPlanck / Const.KBoltzmann)
        CtNe = 2.0 * (C1 / atmos.temperature) ** (-1.5) / atmos.ne
        total = np.ones(Nspace)
        pops = np.zeros((Nstage, Nspace))
        pops[0, :] = 1.0
        Uk = np.interp(atmos.temperature, self.Tpf, self.pf[0, :])
        for i in range(1, Nstage):
            Ukp1 = np.interp(atmos.temperature, self.Tpf, self.pf[i, :])
            pops[i, :] = pops[i - 1, :] * CtNe * np.exp(
                Ukp1 - Uk
                - self.ionPot[i - 1] / (Const.KBoltzmann * atmos.temperature))
            total += pops[i]
            Uk = Ukp1
        pops[0, :] = self.abundance * atmos.nHTot / total
        pops[1:, :] *= pops[0, :]
        return pops

    def fj(self, atmos):
        """Fractional stage populations fj [Nstage, Nspace] and d(fj)/d(ne)."""
        Nstage = self.ionPot.shape[0]
        Nspace = atmos.Nspace
        T = atmos.temperature
        ne = atmos.ne
        C1 = (Const.HPlanck / (2.0 * np.pi * Const.MElectron)
              * Const.HPlanck / Const.KBoltzmann)
        CtNe = 2.0 * (C1 / T) ** (-1.5) / ne
        fj = np.zeros((Nstage, Nspace))
        fj[0, :] = 1.0
        dfj = np.zeros((Nstage, Nspace))
        Uk = np.interp(T, self.Tpf, self.pf[0, :])
        for j in range(1, Nstage):
            Ukp1 = np.interp(T, self.Tpf, self.pf[j, :])
            fj[j] = fj[j - 1] * CtNe * np.exp(
                Ukp1 - Uk - self.ionPot[j - 1] / (Const.KBoltzmann * T))
            dfj[j] = -j * fj[j] / ne
            Uk = Ukp1
        sumF = np.sum(fj, axis=0)
        sumDf = np.sum(dfj, axis=0)
        fj /= sumF
        dfj = (dfj - fj * sumDf) / sumF
        return fj, dfj


class KuruczPfTable:
    """All-element Kurucz partition function container, loaded from the
    extracted npz table."""

    def __init__(self, atomicAbundance: Optional[AtomicAbundance] = None):
        if atomicAbundance is None:
            atomicAbundance = DefaultAtomicAbundance
        self.atomicAbundance = atomicAbundance
        data = np.load(DATA_DIR / 'kurucz_pf.npz')
        self.Tpf = data['Tpf']
        self.nStages = data['nStages']
        self._pf = data['pf']            # [99, maxStage, NT] raw U
        self._ionpot_cm1 = data['ionpot_cm1']

    def __getitem__(self, x) -> KuruczPf:
        e = x if isinstance(x, Element) else PeriodicTable.element(x)
        zm = e.Z - 1
        ns = int(self.nStages[zm])
        pf = np.log(self._pf[zm, :ns])
        ionPot = self._ionpot_cm1[zm, :ns] * Const.HC / Const.CM_TO_M
        return KuruczPf(element=e, abundance=self.atomicAbundance[e],
                        Tpf=self.Tpf, pf=pf, ionPot=ionPot)
