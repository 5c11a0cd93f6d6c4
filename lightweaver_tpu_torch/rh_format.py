"""Reader for RH-format model atom files (`*.atom`).

RH atom files (Uitenbroek 2001, ApJ 557, 389) are the de-facto exchange
format for NLTE model atoms: the reference ships a conversion utility
(`Utils/ConvertAtom.py`) that turns them into its
`rh_atoms.py` library.  This module reads the same format directly into
our model layer, so any standard RH atom (H_6, CaII, MgII, ...) can be
used without a generation step:

    from lightweaver_tpu_torch.rh_format import parse_rh_atom
    atom = parse_rh_atom('CaII.atom')          # -> AtomicModel

Format summary (sections appear in this order; '#' lines are comments):

    ID                                      element symbol
    Nlevel Nline Ncont Nfixed               counts (Nfixed must be 0)
    E[cm^-1] g 'LABEL' stage [levelNo]      x Nlevel
    j i f type Nlambda sym qcore qwing      x Nline
        vdWapprox h1 h2 he1 he2 gRad stark [gLande]
    j i alpha0 Nlambda dep minLambda        x Ncont
        (+ Nlambda explicit "lambda alpha" rows when dep == EXPLICIT,
         given in descending wavelength order)
    TEMP Nt t1 ... tNt                      collision temperature grid
    KEY j i r1 ... rNt                      collision rows until END
        KEY in OMEGA CE CI CP CH CH0 CH+ (tabulated),
        AR85-CDI (followed by Nrow 5-column shell rows), BURGESS

ref: Utils/ConvertAtom.py:110-350 (the accepted grammar),
     RH's readatom.c for the on-disk convention.
"""
import re
from fractions import Fraction
from typing import List, Optional, Union

import numpy as np

from .atomic_model import (AtomicLevel, AtomicModel, ExplicitContinuum,
                           HydrogenicContinuum, LinearCoreExpWings, LineType,
                           VoigtLine)
from .atomic_table import PeriodicTable
from .broadening import (HydrogenLinearStarkBroadening, LineBroadening,
                         MultiplicativeStarkBroadening,
                         QuadraticStarkBroadening, RadiativeBroadening,
                         VdwBarklem, VdwRidderRensbergen, VdwUnsold)
from .collisional_rates import (CE, CH, CI, CP, Ar85Cdi, Burgess,
                                ChargeExchangeNeutralH, ChargeExchangeProton,
                                Omega)

_ORBITALS = 'SPDFGHIKLMNOQRTUVWX'


class RhAtomParseError(ValueError):
    pass


class _Lines:
    """Stream of significant lines (comments/blanks stripped)."""

    def __init__(self, text: str):
        self._lines = [ln.strip() for ln in text.splitlines()]
        self._lines = [ln for ln in self._lines
                       if ln and not ln.startswith('#') and not ln.startswith('*')]
        self._pos = 0

    def next(self) -> Optional[str]:
        if self._pos >= len(self._lines):
            return None
        ln = self._lines[self._pos]
        self._pos += 1
        return ln

    def require(self, what: str) -> str:
        ln = self.next()
        if ln is None:
            raise RhAtomParseError(f'Unexpected end of file reading {what}')
        return ln


def _term_quantum_numbers(label: str, g: float):
    """LS term (J, L, S) from an RH level label like
    'CA II 3P6 4P 2PO 3/2' — the last (multiplicity, orbital, parity)
    token determines L and S; J comes from the statistical weight."""
    up = label.upper()
    parity = max(up.rfind('E'), up.rfind('O'))
    if parity == -1:
        return None
    words = up[:parity + 1].split()
    if not words:
        return None
    m = re.match(r'[\S-]*(\d)([' + _ORBITALS + r'])[EO]$', words[-1])
    if m is None:
        return None
    S = Fraction(int(m.group(1)) - 1, 2)
    L = _ORBITALS.index(m.group(2))
    J = Fraction(int(round(g - 1.0)), 2)
    if J > L + S:
        # composite/superlevel: J from g is not a physical J
        return None
    return J, L, S


def _barklem_applicable(h1: float, lower: AtomicLevel,
                        upper: AtomicLevel) -> bool:
    """RH BARKLEM lines either carry an explicit cross-section (>= 20, in
    atomic units) or ask for a table lookup, which only exists for s-p,
    p-d, d-f transitions of neutral stages."""
    if h1 >= 20.0:
        return True
    if lower.stage > 0:
        return False
    if lower.L is None or upper.L is None:
        return False
    return abs(upper.L - lower.L) == 1 and max(upper.L, lower.L) <= 3


def parse_rh_atom(source: Union[str, 'os.PathLike']) -> AtomicModel:
    """Parse an RH-format atom file (path or file contents) into an
    AtomicModel.  Raises RhAtomParseError on malformed input."""
    text = str(source)
    if '\n' not in text:
        with open(text, 'r') as fh:
            text = fh.read()

    st = _Lines(text)
    symbol = st.require('element ID').split()[0].strip("'\"")
    element = PeriodicTable.element(symbol.capitalize())

    counts = st.require('level/line/continuum counts').split()
    if len(counts) < 4:
        raise RhAtomParseError(f'Expected 4 counts, got: {counts}')
    Nlevel, Nline, Ncont, Nfixed = (int(c) for c in counts[:4])
    if Nfixed != 0:
        raise RhAtomParseError('Fixed transitions are not supported')

    levels: List[AtomicLevel] = []
    levelRe = re.compile(
        r"^\s*([-\d.Ee+]+)\s+([-\d.Ee+]+)\s+'([^']*)'\s+(\d+)")
    for n in range(Nlevel):
        ln = st.require(f'level {n}')
        m = levelRe.match(ln)
        if m is None:
            raise RhAtomParseError(f'Cannot parse level line: {ln!r}')
        lev = AtomicLevel(E=float(m.group(1)), g=float(m.group(2)),
                          label=m.group(3).strip(), stage=int(m.group(4)))
        q = _term_quantum_numbers(lev.label, lev.g)
        if q is not None:
            lev.J, lev.L, lev.S = q
        levels.append(lev)

    lines: List[VoigtLine] = []
    for n in range(Nline):
        tok = st.require(f'line {n}').split()
        if len(tok) < 15:
            raise RhAtomParseError(f'Line record too short: {tok}')
        j, i = int(tok[0]), int(tok[1])
        f = float(tok[2])
        typ = tok[3].upper()
        Nlambda = int(tok[4])
        qCore, qWing = float(tok[6]), float(tok[7])
        vdwKey = tok[8].upper()
        vdw = [float(x) for x in tok[9:13]]
        gRad = float(tok[13])
        stark = float(tok[14])
        gLande = float(tok[15]) if len(tok) > 15 else None

        if typ == 'PRD':
            lineType = LineType.PRD
        elif typ == 'VOIGT':
            lineType = LineType.CRD
        else:
            raise RhAtomParseError(
                f'Only VOIGT and PRD line types are supported, got {typ}')

        lo, hi = levels[min(i, j)], levels[max(i, j)]
        if vdwKey == 'UNSOLD':
            vdwBroad = VdwUnsold([vdw[0], vdw[2]])
        elif vdwKey == 'BARKLEM':
            if _barklem_applicable(vdw[0], lo, hi):
                vdwBroad = VdwBarklem([vdw[0], vdw[2]])
            else:
                vdwBroad = VdwUnsold([vdw[0], vdw[2]])
        elif vdwKey == 'PARAMTR':
            vdwBroad = VdwRidderRensbergen(vdw)
        else:
            raise RhAtomParseError(f'Unknown vdW treatment {vdwKey}')

        starkBroad = (QuadraticStarkBroadening(stark) if stark > 0
                      else MultiplicativeStarkBroadening(abs(stark)))
        elastic = [vdwBroad, starkBroad]
        if element == PeriodicTable.element(1):
            elastic.append(HydrogenLinearStarkBroadening())
        lines.append(VoigtLine(
            j=j, i=i, f=f, type=lineType,
            quadrature=LinearCoreExpWings(qCore=qCore, qWing=qWing,
                                          Nlambda=Nlambda),
            broadening=LineBroadening(natural=[RadiativeBroadening(gRad)],
                                      elastic=elastic),
            gLandeEff=gLande))

    continua = []
    for n in range(Ncont):
        tok = st.require(f'continuum {n}').split()
        j, i = int(tok[0]), int(tok[1])
        alpha0 = float(tok[2])
        Nlambda = int(tok[3])
        dep = tok[4].upper()
        minLambda = float(tok[5])
        if dep == 'EXPLICIT':
            grid = np.empty((Nlambda, 2))
            for r in range(Nlambda):
                row = st.require(f'continuum {n} row {r}').split()
                grid[r] = float(row[0]), float(row[1])
            # stored red-to-blue on disk; our ExplicitContinuum wants
            # ascending wavelength
            grid = grid[::-1]
            continua.append(ExplicitContinuum(
                j=j, i=i, wavelengthGrid=grid[:, 0].tolist(),
                alphaGrid=grid[:, 1].tolist()))
        elif dep == 'HYDROGENIC':
            continua.append(HydrogenicContinuum(
                j=j, i=i, alpha0=alpha0, minWavelength=minLambda,
                NlambdaGen=Nlambda))
        else:
            raise RhAtomParseError(f'Unknown continuum dependence {dep}')

    tabulated = {'OMEGA': Omega, 'CE': CE, 'CI': CI, 'CP': CP, 'CH': CH,
                 'CH0': ChargeExchangeNeutralH, 'CH+': ChargeExchangeProton}
    collisions = []
    Tgrid: Optional[List[float]] = None
    while True:
        ln = st.next()
        if ln is None or ln.split()[0].upper() == 'END':
            break
        tok = ln.split()
        key = tok[0].upper()
        if key == 'TEMP':
            Nt = int(tok[1])
            vals = tok[2:]
            while len(vals) < Nt:   # grids may wrap onto further lines
                vals += st.require('TEMP grid continuation').split()
            Tgrid = [float(v) for v in vals[:Nt]]
        elif key in tabulated:
            if Tgrid is None:
                raise RhAtomParseError(f'{key} before TEMP grid')
            i1, i2 = int(tok[1]), int(tok[2])
            vals = tok[3:]
            while len(vals) < len(Tgrid):
                vals += st.require(f'{key} rate continuation').split()
            rates = [float(v) for v in vals[:len(Tgrid)]]
            collisions.append(tabulated[key](
                j=max(i1, i2), i=min(i1, i2),
                temperature=list(Tgrid), rates=rates))
        elif key == 'AR85-CDI':
            i1, i2, Nrow = int(tok[1]), int(tok[2]), int(tok[3])
            cdi = [[float(x) for x in
                    st.require(f'AR85-CDI row {r}').split()[:5]]
                   for r in range(Nrow)]
            collisions.append(Ar85Cdi(j=max(i1, i2), i=min(i1, i2), cdi=cdi))
        elif key == 'BURGESS':
            i1, i2 = int(tok[1]), int(tok[2])
            fudge = float(tok[3]) if len(tok) > 3 else 1.0
            collisions.append(Burgess(j=max(i1, i2), i=min(i1, i2),
                                      fudge=fudge))
        else:
            # RH defines further exotic keys (SHULL82, AR85-CEA, ...);
            # like the reference converter we skip them with a warning.
            import warnings
            warnings.warn(f'Ignoring unsupported collision key {key}')

    return AtomicModel(element=element, levels=levels, lines=lines,
                       continua=continua, collisions=collisions)
