"""Standard model atoms for common solar species.

The reference distribution generates its model-atom library
(`rh_atoms.py`) from RH's atom files; that file is absent from the
reference snapshot (see SURVEY.md P18), so these models are built here
from published data:

- level energies / statistical weights: NIST ASD
- oscillator strengths: NIST ASD
- natural broadening: sum of Einstein A coefficients out of the upper level
- collisional rates: H carries Johnson (1972); the Ca II / Mg II
  flagships carry tabulated effective collision strengths and ionisation
  coefficients on the canonical RH temperature grid (see the provenance
  note in CaII_atom); the remaining species use van Regemorter
  (permitted) / Seaton (ionisation) formulas at run time.  Atoms with
  production-grade rate data can be loaded from standard RH atom files
  via rh_format.parse_rh_atom.
- photoionisation: hydrogenic cross-sections with Seaton Gaunt factors

These reproduce the standard 6-level H and Ca II NLTE problems; rate data
can be refined per-species without touching the framework.
"""
from fractions import Fraction as F

import numpy as np

from . import constants as Const
from .atomic_model import (AtomicLevel, AtomicModel, HydrogenicContinuum,
                           LinearCoreExpWings, LineType, VoigtLine)
from .atomic_table import PeriodicTable
from .broadening import (BarklemCrossSectionError,
                         HydrogenLinearStarkBroadening, LineBroadening,
                         QuadraticStarkBroadening, RadiativeBroadening,
                         VdwBarklem, VdwUnsold)
from .collisional_rates import (CI, JohnsonCE, JohnsonCI, Omega, SeatonCI,
                                VanRegemorter)


def _lambda0_nm(levels, i, j):
    dE = (levels[j][0] - levels[i][0]) * Const.HC / Const.CM_TO_M
    return Const.HC / dE / Const.NM_TO_M


def _Aji(levels, i, j, f):
    lam_m = _lambda0_nm(levels, i, j) * Const.NM_TO_M
    gi, gj = levels[i][1], levels[j][1]
    C = (2 * np.pi * (Const.QElectron / Const.Epsilon0)
         * (Const.QElectron / Const.MElectron) / Const.CLight)
    return C / lam_m ** 2 * (gi / gj) * f


def _gamma_rad(levels, lines):
    """Natural broadening per upper level: sum of A out of that level."""
    gamma = {}
    for (i, j, f, *_rest) in lines:
        gamma[j] = gamma.get(j, 0.0) + _Aji(levels, i, j, f)
    return gamma


def _hyd_alpha0(n, Z, edge_nm):
    """Kramers hydrogenic threshold cross-section with Gaunt factor [m^2]."""
    from .atomic_model import gaunt_bf
    return 7.907e-22 * n / Z ** 2 * float(gaunt_bf(edge_nm, n, Z))


def H_6_atom() -> AtomicModel:
    """6-level hydrogen (5 bound + H II), the standard chromospheric model.

    Energies in cm^-1 (NIST), Lyman alpha/beta treated in PRD.
    """
    # (E [cm^-1], g, label, stage, n)
    lv = [
        (0.000, 2.0, 'H I 1S 2SE', 0),
        (82259.158, 8.0, 'H I 2P 2PO', 0),
        (97492.304, 18.0, 'H I 3D 2DE', 0),
        (102823.904, 32.0, 'H I 4F 2FO', 0),
        (105291.657, 50.0, 'H I 5G 2GE', 0),
        (109677.617, 1.0, 'H II', 1),
    ]
    # (i, j, f, LineType, qCore, qWing, Nlambda)
    ln = [
        (0, 1, 4.162e-01, LineType.PRD, 15.0, 600.0, 101),
        (0, 2, 7.910e-02, LineType.PRD, 10.0, 250.0, 51),
        (0, 3, 2.899e-02, LineType.CRD, 5.0, 100.0, 21),
        (0, 4, 1.394e-02, LineType.CRD, 5.0, 100.0, 21),
        (1, 2, 6.407e-01, LineType.CRD, 10.0, 250.0, 71),
        (1, 3, 1.193e-01, LineType.CRD, 10.0, 250.0, 51),
        (1, 4, 4.467e-02, LineType.CRD, 5.0, 100.0, 21),
        (2, 3, 8.421e-01, LineType.CRD, 5.0, 100.0, 21),
        (2, 4, 1.506e-01, LineType.CRD, 5.0, 100.0, 21),
        (3, 4, 1.038e+00, LineType.CRD, 5.0, 100.0, 21),
    ]
    grad = _gamma_rad(lv, ln)
    levels = [AtomicLevel(E=E, g=g, label=lab, stage=st)
              for (E, g, lab, st) in lv]
    lines = []
    for (i, j, f, t, qc, qw, nl) in ln:
        lines.append(VoigtLine(
            j=j, i=i, f=f, type=t,
            quadrature=LinearCoreExpWings(qCore=qc, qWing=qw, Nlambda=nl),
            broadening=LineBroadening(
                natural=[RadiativeBroadening(gamma=grad[j])],
                elastic=[VdwUnsold(vals=[1.0, 0.0]),
                         HydrogenLinearStarkBroadening()])))
    continua = []
    for i in range(5):
        n = i + 1
        edge = _lambda0_nm(lv, i, 5)
        continua.append(HydrogenicContinuum(
            j=5, i=i, NlambdaGen=20,
            alpha0=_hyd_alpha0(n, 1, edge),
            minWavelength=edge / 4.0))
    # Johnson (1972) electron-impact rates for every bound pair and
    # bound level: this is the same data source the standard RH/MULTI
    # hydrogen atoms tabulate their CE/CI from (the reference converts
    # those tables via Utils/ConvertAtom.py); evaluated exactly here.
    collisions = []
    for i in range(5):
        for j in range(i + 1, 5):
            collisions.append(JohnsonCE(j=j, i=i))
        collisions.append(JohnsonCI(j=5, i=i))
    return AtomicModel(element=PeriodicTable.element('H'), levels=levels,
                       lines=lines, continua=continua, collisions=collisions)


def CaII_atom() -> AtomicModel:
    """5-level + continuum Ca II: H & K resonance lines and the IR triplet.
    """
    lv = [
        (0.000, 2.0, 'CA II 3P6 4S 2SE', 1, F(1, 2), 0, F(1, 2)),
        (13650.19, 4.0, 'CA II 3P6 3D 2DE 3/2', 1, F(3, 2), 2, F(1, 2)),
        (13710.88, 6.0, 'CA II 3P6 3D 2DE 5/2', 1, F(5, 2), 2, F(1, 2)),
        (25191.51, 2.0, 'CA II 3P6 4P 2PO 1/2', 1, F(1, 2), 1, F(1, 2)),
        (25414.40, 4.0, 'CA II 3P6 4P 2PO 3/2', 1, F(3, 2), 1, F(1, 2)),
        (95751.87, 1.0, 'CA III 3P6 1SE', 2, F(0, 1), 0, F(0, 1)),
    ]
    lv_eg = [(E, g) for (E, g, *_r) in lv]
    # (i, j, f, type, qCore, qWing, Nlambda)
    ln = [
        (0, 3, 3.30e-01, LineType.CRD, 15.0, 600.0, 101),   # H 396.8 nm
        (0, 4, 6.82e-01, LineType.CRD, 15.0, 600.0, 101),   # K 393.4 nm
        (1, 3, 5.96e-02, LineType.CRD, 10.0, 300.0, 81),    # 866.2 nm
        (1, 4, 1.20e-02, LineType.CRD, 10.0, 300.0, 81),    # 849.8 nm
        (2, 4, 7.22e-02, LineType.CRD, 10.0, 300.0, 81),    # 854.2 nm
    ]
    grad = _gamma_rad(lv_eg, ln)
    levels = [AtomicLevel(E=E, g=g, label=lab, stage=st, J=J, L=L, S=S)
              for (E, g, lab, st, J, L, S) in lv]
    lines = []
    for (i, j, f, t, qc, qw, nl) in ln:
        lines.append(VoigtLine(
            j=j, i=i, f=f, type=t,
            quadrature=LinearCoreExpWings(qCore=qc, qWing=qw, Nlambda=nl),
            broadening=LineBroadening(
                natural=[RadiativeBroadening(gamma=grad[j])],
                elastic=[VdwUnsold(vals=[1.0, 1.0]),
                         QuadraticStarkBroadening(coeff=1.0)])))
    edge = _lambda0_nm(lv_eg, 0, 5)
    # effective n of Ca II ground wrt Ca III continuum
    continua = []
    for i in range(5):
        dE = (lv[5][0] - lv[i][0]) * Const.HC / Const.CM_TO_M
        Z = 2
        nEff = Z * np.sqrt(Const.ERydberg / dE)
        edge_i = _lambda0_nm(lv_eg, i, 5)
        continua.append(HydrogenicContinuum(
            j=5, i=i, NlambdaGen=20,
            alpha0=_hyd_alpha0(nEff, Z, edge_i),
            minWavelength=edge_i / 3.0))
    # Tabulated effective collision strengths / ionisation coefficients
    # on the canonical RH temperature grid (interpolated in T at run
    # time, like the reference's converted RH atoms).  Provenance:
    # forbidden pairs anchored to the magnitudes of Melendez, Bautista &
    # Badnell (2007, A&A 469, 1203); permitted pairs and ionisation
    # semi-empirical (van Regemorter 1962 with the ionic Gaunt factor;
    # Seaton 1962 from the photoionisation threshold), pre-evaluated on
    # the grid.  Production-grade R-matrix data can be substituted via
    # rh_format.parse_rh_atom without touching this module.
    Tgrid = [3000.0, 5000.0, 10000.0, 20000.0, 50000.0, 100000.0]
    collisions = [
        # forbidden
        Omega(j=1, i=0, temperature=Tgrid, rates=[2.4] * 6),
        Omega(j=2, i=0, temperature=Tgrid, rates=[3.7] * 6),
        Omega(j=2, i=1, temperature=Tgrid, rates=[6.0] * 6),
        Omega(j=3, i=2, temperature=Tgrid, rates=[4.0] * 6),
        Omega(j=4, i=3, temperature=Tgrid, rates=[2.4] * 6),
        # permitted
        Omega(j=3, i=0, temperature=Tgrid,
              rates=[8.337, 8.337, 8.337, 8.337, 8.471, 12.725]),
        Omega(j=4, i=0, temperature=Tgrid,
              rates=[17.079, 17.079, 17.079, 17.079, 17.256, 25.943]),
        Omega(j=3, i=1, temperature=Tgrid,
              rates=[6.573, 6.573, 6.573, 6.573, 10.514, 14.754]),
        Omega(j=4, i=1, temperature=Tgrid,
              rates=[1.298, 1.298, 1.298, 1.298, 2.056, 2.889]),
        Omega(j=4, i=2, temperature=Tgrid,
              rates=[11.779, 11.779, 11.779, 11.779, 18.701, 26.272]),
        # ionisation [s^-1 K^-1/2 m^3]
        CI(j=5, i=0, temperature=Tgrid, rates=[8.362e-17] * 6),
        CI(j=5, i=1, temperature=Tgrid, rates=[1.062e-16] * 6),
        CI(j=5, i=2, temperature=Tgrid, rates=[1.063e-16] * 6),
        CI(j=5, i=3, temperature=Tgrid, rates=[1.342e-16] * 6),
        CI(j=5, i=4, temperature=Tgrid, rates=[1.349e-16] * 6),
    ]
    return AtomicModel(element=PeriodicTable.element('Ca'), levels=levels,
                       lines=lines, continua=continua, collisions=collisions)


def H_6_PRD_atom() -> AtomicModel:
    return H_6_atom()


def H_6_CRD_atom() -> AtomicModel:
    atom = H_6_atom()
    for l in atom.lines:
        l.type = LineType.CRD
    return atom


def H_4_atom() -> AtomicModel:
    """4-level hydrogen (3 bound + H II): trimmed H_6 for time-dependent
    problems."""
    atom = H_6_atom()
    keep = {0, 1, 2, 5}
    remap = {0: 0, 1: 1, 2: 2, 5: 3}
    levels = [l for li, l in enumerate(atom.levels) if li in keep]
    lines = [l for l in atom.lines if l.i in keep and l.j in keep]
    continua = [c for c in atom.continua if c.i in keep and c.j in keep]
    collisions = [c for c in atom.collisions
                  if c.i in keep and c.j in keep]
    for l in lines + continua + collisions:
        l.i = remap[l.i]
        l.j = remap[l.j]
    return AtomicModel(element=PeriodicTable.element('H'), levels=levels,
                       lines=lines, continua=continua, collisions=collisions)


def MgII_atom() -> AtomicModel:
    """5-level + continuum Mg II: h & k resonance lines (PRD) and the
    near-UV subordinate lines.  Energies/f-values from NIST ASD."""
    lv = [
        (0.000, 2.0, 'MG II 3S 2SE', 1, F(1, 2), 0, F(1, 2)),
        (35669.31, 2.0, 'MG II 3P 2PO 1/2', 1, F(1, 2), 1, F(1, 2)),
        (35760.88, 4.0, 'MG II 3P 2PO 3/2', 1, F(3, 2), 1, F(1, 2)),
        (69804.95, 2.0, 'MG II 4S 2SE', 1, F(1, 2), 0, F(1, 2)),
        (71490.19, 10.0, 'MG II 3D 2DE', 1, None, 2, F(1, 2)),
        (121267.64, 1.0, 'MG III 2P6 1SE', 2, F(0, 1), 0, F(0, 1)),
    ]
    lv_eg = [(E, g) for (E, g, *_r) in lv]
    ln = [
        (0, 2, 6.08e-01, LineType.PRD, 10.0, 300.0, 101),   # k 279.6 nm
        (0, 1, 3.03e-01, LineType.PRD, 10.0, 300.0, 101),   # h 280.3 nm
        (1, 3, 1.34e-01, LineType.CRD, 5.0, 100.0, 31),     # 293.7 nm
        (2, 3, 1.34e-01, LineType.CRD, 5.0, 100.0, 31),     # 292.9 nm
        (1, 4, 6.2e-01, LineType.CRD, 5.0, 100.0, 31),      # 279.2 nm
        (2, 4, 5.8e-01, LineType.CRD, 5.0, 100.0, 31),      # 279.9 nm
    ]
    grad = _gamma_rad(lv_eg, ln)
    levels = [AtomicLevel(E=E, g=g, label=lab, stage=st, J=J, L=L, S=S)
              for (E, g, lab, st, J, L, S) in lv]
    lines = []
    for (i, j, f, t, qc, qw, nl) in ln:
        lines.append(VoigtLine(
            j=j, i=i, f=f, type=t,
            quadrature=LinearCoreExpWings(qCore=qc, qWing=qw, Nlambda=nl),
            broadening=LineBroadening(
                natural=[RadiativeBroadening(gamma=grad[j])],
                elastic=[VdwUnsold(vals=[1.0, 1.0]),
                         QuadraticStarkBroadening(coeff=1.0)])))
    continua, collisions = [], []
    for i in range(5):
        dE = (lv[5][0] - lv[i][0]) * Const.HC / Const.CM_TO_M
        Z = 2
        nEff = Z * np.sqrt(Const.ERydberg / dE)
        edge_i = _lambda0_nm(lv_eg, i, 5)
        alpha0 = _hyd_alpha0(nEff, Z, edge_i)
        continua.append(HydrogenicContinuum(
            j=5, i=i, NlambdaGen=20, alpha0=alpha0,
            minWavelength=edge_i / 3.0))
    # tabulated on the canonical grid; same provenance note as CaII_atom
    Tgrid = [3000.0, 5000.0, 10000.0, 20000.0, 50000.0, 100000.0]
    collisions += [
        Omega(j=1, i=0, temperature=Tgrid,
              rates=[5.406, 5.406, 5.406, 5.406, 5.406, 6.781]),
        Omega(j=2, i=0, temperature=Tgrid,
              rates=[10.820, 10.820, 10.820, 10.820, 10.820, 13.552]),
        Omega(j=2, i=1, temperature=Tgrid, rates=[6.0] * 6),
        Omega(j=3, i=1, temperature=Tgrid,
              rates=[2.498, 2.498, 2.498, 2.498, 2.498, 3.215]),
        Omega(j=3, i=2, temperature=Tgrid,
              rates=[5.010, 5.010, 5.010, 5.010, 5.010, 6.458]),
        Omega(j=4, i=1, temperature=Tgrid,
              rates=[11.016, 11.016, 11.016, 11.016, 11.016, 13.783]),
        Omega(j=4, i=2, temperature=Tgrid,
              rates=[20.663, 20.663, 20.663, 20.663, 20.663, 25.892]),
        CI(j=5, i=0, temperature=Tgrid, rates=[5.789e-17] * 6),
        CI(j=5, i=1, temperature=Tgrid, rates=[9.951e-17] * 6),
        CI(j=5, i=2, temperature=Tgrid, rates=[9.967e-17] * 6),
        CI(j=5, i=3, temperature=Tgrid, rates=[2.184e-16] * 6),
        CI(j=5, i=4, temperature=Tgrid, rates=[2.299e-16] * 6),
    ]
    return AtomicModel(element=PeriodicTable.element('Mg'), levels=levels,
                       lines=lines, continua=continua, collisions=collisions)


def NaI_atom() -> AtomicModel:
    """5-level + continuum Na I: D1/D2 resonance doublet and the first
    subordinate lines.  Energies/f-values from NIST ASD."""
    lv = [
        (0.000, 2.0, 'NA I 3S 2SE', 0, F(1, 2), 0, F(1, 2)),
        (16956.17, 2.0, 'NA I 3P 2PO 1/2', 0, F(1, 2), 1, F(1, 2)),
        (16973.37, 4.0, 'NA I 3P 2PO 3/2', 0, F(3, 2), 1, F(1, 2)),
        (25739.99, 2.0, 'NA I 4S 2SE', 0, F(1, 2), 0, F(1, 2)),
        (29172.89, 10.0, 'NA I 3D 2DE', 0, None, 2, F(1, 2)),
        (41449.45, 1.0, 'NA II 2P6 1SE', 1, F(0, 1), 0, F(0, 1)),
    ]
    lv_eg = [(E, g) for (E, g, *_r) in lv]
    ln = [
        (0, 2, 6.41e-01, LineType.CRD, 15.0, 400.0, 81),    # D2 589.16 nm
        (0, 1, 3.20e-01, LineType.CRD, 15.0, 400.0, 81),    # D1 589.76 nm
        (1, 3, 1.63e-01, LineType.CRD, 5.0, 100.0, 21),     # 1138.4 nm
        (2, 3, 1.63e-01, LineType.CRD, 5.0, 100.0, 21),     # 1140.6 nm
        (1, 4, 8.5e-01, LineType.CRD, 5.0, 100.0, 21),      # 818.6 nm
        (2, 4, 8.0e-01, LineType.CRD, 5.0, 100.0, 21),      # 819.7 nm
    ]
    grad = _gamma_rad(lv_eg, ln)
    levels = [AtomicLevel(E=E, g=g, label=lab, stage=st, J=J, L=L, S=S)
              for (E, g, lab, st, J, L, S) in lv]
    lines = []
    for (i, j, f, t, qc, qw, nl) in ln:
        # Barklem ABO theory for the neutral lines covered by the
        # s-p/p-d tables, Unsold elsewhere
        # (ref: lightweaver/broadening.py:237-291)
        lines.append(VoigtLine(
            j=j, i=i, f=f, type=t,
            quadrature=LinearCoreExpWings(qCore=qc, qWing=qw, Nlambda=nl),
            broadening=LineBroadening(
                natural=[RadiativeBroadening(gamma=grad[j])],
                elastic=[VdwBarklem(vals=[1.0, 1.0]),
                         QuadraticStarkBroadening(coeff=1.0)])))
    continua, collisions = [], []
    for i in range(5):
        dE = (lv[5][0] - lv[i][0]) * Const.HC / Const.CM_TO_M
        Z = 1
        nEff = Z * np.sqrt(Const.ERydberg / dE)
        edge_i = _lambda0_nm(lv_eg, i, 5)
        alpha0 = _hyd_alpha0(nEff, Z, edge_i)
        continua.append(HydrogenicContinuum(
            j=5, i=i, NlambdaGen=20, alpha0=alpha0,
            minWavelength=edge_i / 3.0))
        collisions.append(SeatonCI(j=5, i=i, alpha0=alpha0))
    for (i, j, f, *_r) in ln:
        collisions.append(VanRegemorter(j=j, i=i, f=f))
    return AtomicModel(element=PeriodicTable.element('Na'), levels=levels,
                       lines=lines, continua=continua, collisions=collisions)


def He_atom() -> AtomicModel:
    """Simplified 5-level + continuum He I (ground, 2s triplet/singlet,
    2p triplet/singlet) with the 58.4 nm, 1083 nm and 2058 nm lines."""
    lv = [
        (0.000, 1.0, 'HE I 1S2 1SE', 0),
        (159855.97, 3.0, 'HE I 1S2S 3SE', 0),
        (166277.44, 1.0, 'HE I 1S2S 1SE', 0),
        (169086.84, 9.0, 'HE I 1S2P 3PO', 0),
        (171134.90, 3.0, 'HE I 1S2P 1PO', 0),
        (198310.67, 2.0, 'HE II 1S 2SE', 1),
    ]
    ln = [
        (0, 4, 2.762e-01, LineType.CRD, 5.0, 100.0, 21),    # 58.4 nm
        (1, 3, 5.39e-01, LineType.CRD, 8.0, 150.0, 31),     # 1083.0 nm
        (2, 4, 3.76e-01, LineType.CRD, 5.0, 100.0, 21),     # 2058.1 nm
    ]
    grad = _gamma_rad([(E, g) for (E, g, *_r) in lv], ln)
    levels = [AtomicLevel(E=E, g=g, label=lab, stage=st)
              for (E, g, lab, st) in lv]
    lines = []
    for (i, j, f, t, qc, qw, nl) in ln:
        lines.append(VoigtLine(
            j=j, i=i, f=f, type=t,
            quadrature=LinearCoreExpWings(qCore=qc, qWing=qw, Nlambda=nl),
            broadening=LineBroadening(
                natural=[RadiativeBroadening(gamma=grad[j])],
                elastic=[VdwUnsold(vals=[1.0, 0.0])])))
    lv_eg = [(E, g) for (E, g, *_r) in lv]
    continua, collisions = [], []
    for i in range(5):
        dE = (lv[5][0] - lv[i][0]) * Const.HC / Const.CM_TO_M
        nEff = np.sqrt(Const.ERydberg / dE)
        edge_i = _lambda0_nm(lv_eg, i, 5)
        alpha0 = _hyd_alpha0(max(nEff, 0.7), 1, edge_i)
        continua.append(HydrogenicContinuum(
            j=5, i=i, NlambdaGen=20, alpha0=alpha0,
            minWavelength=edge_i / 3.0))
        collisions.append(SeatonCI(j=5, i=i, alpha0=alpha0))
    for (i, j, f, *_r) in ln:
        collisions.append(VanRegemorter(j=j, i=i, f=f))
    return AtomicModel(element=PeriodicTable.element('He'), levels=levels,
                       lines=lines, continua=continua, collisions=collisions)


def _two_level_ion_model(elem: str, E0g: float, gGround: float,
                         labelGround: str, Eion: float, gIon: float,
                         labelIon: str) -> AtomicModel:
    """Ground + ion-ground model: provides the LTE ionisation balance,
    photoionisation background and electron contribution of a passive
    species (the role these play in the reference's background/NLTE-ne
    machinery)."""
    lv = [(E0g, gGround, labelGround, 0), (Eion, gIon, labelIon, 1)]
    lv_eg = [(E, g) for (E, g, *_r) in lv]
    levels = [AtomicLevel(E=E, g=g, label=lab, stage=st)
              for (E, g, lab, st) in lv]
    dE = (Eion - E0g) * Const.HC / Const.CM_TO_M
    nEff = np.sqrt(Const.ERydberg / dE)
    edge = _lambda0_nm(lv_eg, 0, 1)
    alpha0 = _hyd_alpha0(max(nEff, 0.8), 1, edge)
    continua = [HydrogenicContinuum(j=1, i=0, NlambdaGen=15, alpha0=alpha0,
                                    minWavelength=edge / 4.0)]
    collisions = [SeatonCI(j=1, i=0, alpha0=alpha0)]
    return AtomicModel(element=PeriodicTable.element(elem), levels=levels,
                       lines=[], continua=continua, collisions=collisions)


def C_atom() -> AtomicModel:
    return _two_level_ion_model('C', 0.0, 9.0, 'C I 2P2 3PE', 90820.42,
                                6.0, 'C II 2P 2PO')


def N_atom() -> AtomicModel:
    return _two_level_ion_model('N', 0.0, 4.0, 'N I 2P3 4SO', 117225.70,
                                9.0, 'N II 2P2 3PE')


def O_atom() -> AtomicModel:
    return _two_level_ion_model('O', 0.0, 9.0, 'O I 2P4 3PE', 109837.02,
                                4.0, 'O II 2P3 4SO')


def Si_atom() -> AtomicModel:
    return _two_level_ion_model('Si', 0.0, 9.0, 'SI I 3P2 3PE', 65747.76,
                                6.0, 'SI II 3P 2PO')


def Al_atom() -> AtomicModel:
    return _two_level_ion_model('Al', 0.0, 6.0, 'AL I 3P 2PO', 48278.48,
                                1.0, 'AL II 3S2 1SE')


def S_atom() -> AtomicModel:
    return _two_level_ion_model('S', 0.0, 9.0, 'S I 3P4 3PE', 75766.80,
                                4.0, 'S II 3P3 4SO')


def Fe_atom() -> AtomicModel:
    return _two_level_ion_model('Fe', 0.0, 25.0, 'FE I 3D6 4S2 5DE',
                                63737.70, 30.0, 'FE II 3D6 4S 6DE')


def MgII_simplified_atom() -> AtomicModel:
    return MgII_atom()
