"""Molecular models: Kurucz / Sauval & Tatum equilibrium-constant fits.

ref: lightweaver/molecule.py:35-220 (the reference parses
RH .molecule files at runtime with numba-jitted scalar fits; here the
public data tables are shipped pre-extracted and the fits are vectorised
numpy).
"""
import json
import re
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from . import constants as Const
from .atomic_table import Element, PeriodicTable

from ._data import DATA_DIR


def _next_line(lines: List[str]) -> Optional[str]:
    """Next non-comment, non-blank line (RH .molecule convention).
    ref: lightweaver/molecule.py:13-25"""
    while lines:
        s = lines.pop(0).strip()
        if s.startswith('#') or not s:
            continue
        return s
    return None


def _parse_constituent(s: str):
    m = re.match(r'^(\d+)\s*([A-Za-z].*)$', s.strip())
    if m:
        return int(m.group(1)), m.group(2)
    return 1, s.strip()


def parse_molecule_file(path) -> dict:
    """Parse an RH/Kurucz ``.molecule`` definition file (the format of
    the reference's Data/DefaultMolecules distribution) into the plain
    dict layout :class:`Molecule` consumes.
    ref: lightweaver/molecule.py:100-175"""
    path = Path(path)
    lines = path.read_text().splitlines()
    name = _next_line(lines)
    charge = int(_next_line(lines))
    if charge < 0 or charge > 1:
        raise ValueError('Only neutral or singly charged positive '
                         f'molecules are allowed ({name})')
    constituents = [_parse_constituent(c)
                    for c in _next_line(lines).split(',')]
    Ediss_eV = float(_next_line(lines))
    fit = _next_line(lines)
    if fit not in ('KURUCZ_70', 'KURUCZ_85', 'SAUVAL_TATUM_84'):
        raise ValueError(f'Unknown molecular equilibrium fit {fit!r} '
                         f'in {name}')
    tRange = [float(x) for x in _next_line(lines).split()]
    if len(tRange) != 2:
        raise ValueError('Expected two entries for formation temperature '
                         f'range ({name})')
    pf = _next_line(lines).split()
    pfCoef = [float(x) for x in pf[1:]]
    if len(pfCoef) != int(pf[0]):
        raise ValueError('Unexpected number of partition function fit '
                         f'parameters ({name})')
    eqc = _next_line(lines).split()
    eqcCoef = [float(x) for x in eqc[1:]]
    if len(eqcCoef) != int(eqc[0]):
        raise ValueError('Unexpected number of equilibrium coefficient '
                         f'fit parameters ({name})')
    return {
        'name': name, 'charge': charge,
        'elements': [e for (_c, e) in constituents],
        'counts': [c for (c, _e) in constituents],
        'Ediss_eV': Ediss_eV, 'fit': fit,
        'Tmin': tRange[0], 'Tmax': tRange[1],
        'pfCoef': pfCoef, 'eqcCoef': eqcCoef,
    }


class Molecule:
    @classmethod
    def from_file(cls, path) -> 'Molecule':
        """Load a user-supplied RH ``.molecule`` definition file."""
        return cls(parse_molecule_file(path))

    def __init__(self, d: dict):
        self.name = d['name']
        self.charge = int(d['charge'])
        self.elements = [PeriodicTable.element(e) for e in d['elements']]
        self.elementCount = [int(c) for c in d['counts']]
        self.Nnuclei = sum(self.elementCount)
        self.Ediss = d['Ediss_eV'] * Const.EV
        self.fit = d['fit']
        self.formationTempRange = (d['Tmin'], d['Tmax'])
        # stored low->high order in the file; evaluated Horner high-first
        self.pfCoeffs = np.array(d['pfCoef'][::-1])
        self.eqcCoeffs = np.array(d['eqcCoef'][::-1])
        self.weight = sum(c * PeriodicTable[e].mass
                          for c, e in zip(self.elementCount, self.elements))
        self._mk = self.Nnuclei - 1 - self.charge

    def equilibrium_constant(self, T) -> np.ndarray:
        """Phi(T) such that n_mol = Phi * prod(n_constituent) / ne^charge,
        zero outside the formation temperature range.
        ref: lightweaver/molecule.py:35-99"""
        T = np.asarray(T, np.float64)
        kT = Const.KBoltzmann * T
        if self.fit == 'KURUCZ_70':
            eq = np.polyval(self.eqcCoeffs, T)
            out = (np.exp(self.Ediss / kT + eq - 1.5 * self._mk * np.log(T))
                   * (Const.CM_TO_M ** 3) ** self._mk)
        elif self.fit == 'KURUCZ_85':
            eq = np.polyval(self.eqcCoeffs, T * 1e-4)
            out = (np.exp(self.Ediss / kT + eq - 1.5 * self._mk * np.log(T))
                   * (Const.CM_TO_M ** 3) ** self._mk)
        elif self.fit == 'SAUVAL_TATUM_84':
            theta = Const.Theta0 / T
            eq = np.polyval(self.eqcCoeffs, np.log10(theta))
            out = 10.0 ** (self.Ediss / Const.EV * theta - eq) * kT
        else:
            raise ValueError(f'Unknown fit {self.fit} for {self.name}')
        lo, hi = self.formationTempRange
        return np.where((T < lo) | (T > hi), 0.0, out)


class MolecularTable:
    """Set of molecular models indexed by name.  Entries may be
    :class:`Molecule` instances or paths to RH ``.molecule`` files
    (matching the reference's path-list constructor,
    ref: lightweaver/molecule.py:177-198)."""

    def __init__(self, molecules: Optional[List] = None):
        self.molecules = [m if isinstance(m, Molecule)
                          else Molecule.from_file(m)
                          for m in (molecules or [])]
        self.indices = {m.name.upper(): i
                        for i, m in enumerate(self.molecules)}

    @classmethod
    def default(cls, names: Optional[List[str]] = None) -> 'MolecularTable':
        with open(DATA_DIR / 'molecules.json') as f:
            data = json.load(f)
        if names is None:
            names = sorted(data)
        return cls([Molecule(data[n.upper()]) for n in names])

    def __getitem__(self, name: str) -> Molecule:
        return self.molecules[self.indices[name.upper()]]

    def __contains__(self, name) -> bool:
        return isinstance(name, str) and name.upper() in self.indices

    def __len__(self):
        return len(self.molecules)

    def __iter__(self):
        return iter(self.molecules)
