"""Atomic models: levels, lines, continua, wavelength quadratures.

Static (setup-time, numpy) description of model atoms; the traced compute
path consumes precomputed arrays derived from these.
ref: lightweaver/atomic_model.py
"""
from dataclasses import dataclass, field
from enum import Enum, auto
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import constants as Const
from .atomic_table import Element, PeriodicTable
from .broadening import LineBroadening
from .zeeman import ZeemanComponents, compute_zeeman_components


def gaunt_bf(wvl, nEff, charge):
    """Bound-free Gaunt factor, Seaton (1960), Rep. Prog. Phys. 23, 313.
    wvl in nm."""
    x = Const.HC / (wvl * Const.NM_TO_M) / (Const.ERydberg * charge ** 2)
    x3 = x ** (1.0 / 3.0)
    nsqx = 1.0 / (nEff ** 2 * x)
    return (1.0 + 0.1728 * x3 * (1.0 - 2.0 * nsqx)
            - 0.0496 * x3 ** 2 * (1.0 - (1.0 - nsqx) * (2.0 / 3.0) * nsqx))


def reconfigure_atom(atom: 'AtomicModel') -> None:
    """Re-run all atomic setup after modifying an atom's parameters in
    place (ref: lightweaver/atomic_model.py:95-99)."""
    atom.__post_init__()


@dataclass
class AtomicModel:
    """Complete description of a model atom."""
    element: Element
    levels: Sequence['AtomicLevel']
    lines: Sequence['AtomicLine']
    continua: Sequence['AtomicContinuum']
    collisions: Sequence

    def __post_init__(self):
        for l in self.levels:
            l.setup(self)
        for l in self.lines:
            l.setup(self)
        for c in self.continua:
            c.setup(self)
        for c in self.collisions:
            c.setup(self)

    def __hash__(self):
        return hash((self.element, tuple(self.levels),
                     tuple(id(l) for l in self.lines),
                     tuple(id(c) for c in self.continua)))

    def __eq__(self, other):
        return self is other

    def vBroad(self, atmos) -> np.ndarray:
        """Broadening velocity: thermal + microturbulent [Nspace]."""
        vTherm = (2.0 * Const.KBoltzmann
                  / (Const.Amu * PeriodicTable[self.element].mass))
        return np.sqrt(vTherm * atmos.temperature + atmos.vturb ** 2)

    @property
    def transitions(self) -> List['AtomicTransition']:
        return list(self.lines) + list(self.continua)


@dataclass
class AtomicLevel:
    """E in cm^-1 above ground, g statistical weight, stage 0 = neutral."""
    E: float
    g: float
    label: str
    stage: int
    atom: AtomicModel = field(init=False, repr=False)
    J: Optional[Fraction] = None
    L: Optional[int] = None
    S: Optional[Fraction] = None

    def setup(self, atom):
        self.atom = atom

    def __hash__(self):
        return hash((self.E, self.g, self.label, self.stage,
                     self.J, self.L, self.S))

    @property
    def lsCoupling(self) -> bool:
        if all(x is not None for x in (self.J, self.L, self.S)):
            return self.J <= self.L + self.S
        return False

    @property
    def E_SI(self):
        return self.E * Const.HC / Const.CM_TO_M

    @property
    def E_eV(self):
        return self.E_SI / Const.EV


class LineType(Enum):
    CRD = 0
    PRD = auto()


@dataclass
class LineProfileState:
    """Inputs handed to `AtomicLine.compute_phi` so user subclasses can
    compute custom line profiles (ref:
    lightweaver/atomic_model.py:389-420).

    `default_voigt_callback(aDamp, vBroad) -> phi [W, Nmu, 2, Nspace]` is
    the backend's batched Voigt evaluation on this line's wavelength
    window; custom profiles may call it or return any jax array of the
    same shape (profiles are recomputed host-side by `update_deps`, so
    arbitrary jax/numpy code is fine here).
    """
    wavelength: np.ndarray          # [W] line window [nm]
    vlosMu: 'np.ndarray'            # [Nmu, Nspace] projected bulk velocity
    atmos: object
    eqPops: object
    default_voigt_callback: object  # (aDamp [Nk], vBroad [Nk]) -> phi
    vBroad: Optional[np.ndarray] = None


@dataclass
class LineProfileResult:
    """Profile plus the damping/elastic-rate data the backend must keep
    (aDamp feeds PRD gII; Qelast feeds PjQj).
    ref: lightweaver/atomic_model.py:421-432."""
    phi: object                     # [W, Nmu, 2, Nspace]
    aDamp: np.ndarray               # [Nspace]
    Qelast: np.ndarray              # [Nspace]


@dataclass
class LineQuadrature:
    def setup(self, line):
        pass

    def doppler_units(self, line) -> np.ndarray:
        raise NotImplementedError

    def wavelength(self, line, vMicroChar=Const.VMICRO_CHAR) -> np.ndarray:
        raise NotImplementedError


@dataclass
class LinearQuadrature(LineQuadrature):
    """Linearly spaced grid: Nlambda points over +/- deltaLambda [nm]."""
    Nlambda: int
    deltaLambda: float

    def wavelength(self, line, vMicroChar=Const.VMICRO_CHAR):
        return np.linspace(line.lambda0 - self.deltaLambda,
                           line.lambda0 + self.deltaLambda, self.Nlambda)

    def doppler_units(self, line):
        qToLambda = line.lambda0 * (Const.VMICRO_CHAR / Const.CLight)
        return (self.wavelength(line) - line.lambda0) / qToLambda


@dataclass
class TabulatedQuadrature(LineQuadrature):
    """Explicit wavelength offsets from line centre [nm]."""
    wavelengthGrid: Sequence[float]

    def wavelength(self, line, vMicroChar=Const.VMICRO_CHAR):
        return np.ascontiguousarray(self.wavelengthGrid) + line.lambda0

    def doppler_units(self, line):
        qToLambda = line.lambda0 * (Const.VMICRO_CHAR / Const.CLight)
        return (self.wavelength(line) - line.lambda0) / qToLambda


@dataclass
class LinearCoreExpWings(LineQuadrature):
    """RH-style line quadrature: ~linear spacing in the core out to qCore,
    exponential spacing into the wings out to qWing (Doppler units).
    ref: lightweaver/atomic_model.py:279-341
    """
    qCore: float
    qWing: float
    Nlambda: int
    beta: float = field(init=False, default=1.0)

    def __hash__(self):
        return hash((self.qCore, self.qWing, self.Nlambda))

    def setup(self, line):
        if self.qWing <= 2.0 * self.qCore:
            self.beta = 1.0
        else:
            self.beta = self.qWing / (2.0 * self.qCore)

    def doppler_units(self, line) -> np.ndarray:
        Nlambda = (self.Nlambda // 2 if self.Nlambda % 2 == 1
                   else (self.Nlambda - 1) // 2)
        Nlambda += 1
        beta = self.beta
        y = beta + np.sqrt(beta ** 2 + (beta - 1.0) * Nlambda + 2.0 - 3.0 * beta)
        b = 2.0 * np.log(y) / (Nlambda - 1)
        a = self.qWing / (Nlambda - 2.0 + y ** 2)
        nl = np.arange(Nlambda)
        q = a * (nl + (np.exp(b * nl) - 1.0))

        NlambdaFull = 2 * Nlambda - 1
        result = np.zeros(NlambdaFull)
        Nmid = Nlambda - 1
        result[:Nmid][::-1] = -q[1:]
        result[Nmid + 1:] = q[1:]
        return result

    def wavelength(self, line, vMicroChar=Const.VMICRO_CHAR) -> np.ndarray:
        qToLambda = line.lambda0 * (vMicroChar / Const.CLight)
        return self.doppler_units(line) * qToLambda + line.lambda0


@dataclass
class AtomicTransition:
    j: int
    i: int
    atom: AtomicModel = field(init=False, repr=False)
    jLevel: AtomicLevel = field(init=False, repr=False)
    iLevel: AtomicLevel = field(init=False, repr=False)

    def setup(self, atom: AtomicModel):
        if self.j < self.i:
            self.i, self.j = self.j, self.i
        self.atom = atom
        self.jLevel = atom.levels[self.j]
        self.iLevel = atom.levels[self.i]

    def wavelength(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def lambda0(self) -> float:
        return self.lambda0_m / Const.NM_TO_M

    @property
    def lambda0_m(self) -> float:
        return Const.HC / (self.jLevel.E_SI - self.iLevel.E_SI)

    @property
    def transId(self) -> Tuple[Element, int, int]:
        return (self.atom.element, self.i, self.j)


@dataclass
class AtomicLine(AtomicTransition):
    f: float
    type: LineType
    quadrature: LineQuadrature
    broadening: LineBroadening
    gLandeEff: Optional[float] = None

    def setup(self, atom: AtomicModel):
        super().setup(atom)
        self.quadrature.setup(self)
        self.broadening.setup(self)

    def __hash__(self):
        return hash((self.atom.element, self.i, self.j, self.f))

    def wavelength(self, vMicroChar=Const.VMICRO_CHAR) -> np.ndarray:
        return self.quadrature.wavelength(self, vMicroChar=vMicroChar)

    def zeeman_components(self) -> Optional[ZeemanComponents]:
        return compute_zeeman_components(self)

    @property
    def overlyingContinuumLevel(self) -> AtomicLevel:
        Z = self.jLevel.stage + 1
        ic = self.j + 1
        while ic < len(self.atom.levels) and self.atom.levels[ic].stage < Z:
            ic += 1
        if ic == len(self.atom.levels):
            raise ValueError('No overlying continuum level found')
        return self.atom.levels[ic]

    @property
    def Aji(self) -> float:
        gRatio = self.iLevel.g / self.jLevel.g
        C = (2 * np.pi * (Const.QElectron / Const.Epsilon0)
             * (Const.QElectron / Const.MElectron) / Const.CLight)
        return C / self.lambda0_m ** 2 * gRatio * self.f

    @property
    def Bji(self) -> float:
        return self.lambda0_m ** 3 / (2.0 * Const.HC) * self.Aji

    @property
    def Bij(self) -> float:
        return self.jLevel.g / self.iLevel.g * self.Bji

    @property
    def polarisable(self) -> bool:
        return ((self.iLevel.lsCoupling and self.jLevel.lsCoupling)
                or (self.gLandeEff is not None))

    def damping(self, atmos, eqPops, vBroad=None):
        """Voigt damping parameter aDamp [Nspace] and elastic rate Qelast."""
        Qs = self.broadening.broaden(atmos, eqPops)
        if vBroad is None:
            vBroad = self.atom.vBroad(atmos)
        cDop = self.lambda0_m / (4.0 * np.pi)
        aDamp = (Qs.natural + Qs.Qelast) * cDop / vBroad
        return aDamp, Qs.Qelast

    def compute_phi(self, state: LineProfileState) -> LineProfileResult:
        """Default profile: Voigt via the backend callback.  Subclasses
        override this to supply custom profiles (ref:
        lightweaver/atomic_model.py:605-630)."""
        vBroad = (self.atom.vBroad(state.atmos) if state.vBroad is None
                  else state.vBroad)
        aDamp, Qelast = self.damping(state.atmos, state.eqPops,
                                     vBroad=vBroad)
        phi = state.default_voigt_callback(aDamp, vBroad)
        return LineProfileResult(phi=phi, aDamp=aDamp, Qelast=Qelast)


@dataclass
class VoigtLine(AtomicLine):
    """Line with a Voigt profile (the default)."""
    pass


@dataclass
class AtomicContinuum(AtomicTransition):
    def alpha(self, wavelength: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def __hash__(self):
        return hash((self.atom.element, self.i, self.j, 'cont'))

    @property
    def lambdaEdge(self) -> float:
        return self.lambda0

    @property
    def minLambda(self) -> float:
        raise NotImplementedError

    @property
    def polarisable(self) -> bool:
        return False


@dataclass
class ExplicitContinuum(AtomicContinuum):
    """Tabulated cross-section vs wavelength [nm, m^2]."""
    wavelengthGrid: Sequence[float]
    alphaGrid: Sequence[float]

    def setup(self, atom: AtomicModel):
        super().setup(atom)
        self.wavelengthGrid = np.asarray(self.wavelengthGrid)
        if not np.all(np.diff(self.wavelengthGrid) > 0.0):
            raise ValueError('Continuum wavelength grid not increasing')
        self.alphaGrid = np.asarray(self.alphaGrid)
        if self.lambdaEdge - self.wavelengthGrid[-1] > 0.01:
            self.wavelengthGrid = np.concatenate(
                [self.wavelengthGrid, [self.lambdaEdge]])
            self.alphaGrid = np.concatenate(
                [self.alphaGrid, [self.alphaGrid[-1]]])

    def alpha(self, wavelength: np.ndarray) -> np.ndarray:
        from .ops.weno import weno4
        alpha = weno4(wavelength, self.wavelengthGrid, self.alphaGrid,
                      left=0.0, right=0.0)
        alpha = np.atleast_1d(alpha)
        alpha[wavelength < self.minLambda] = 0.0
        alpha[wavelength > self.lambdaEdge] = 0.0
        return np.maximum(alpha, 0.0)

    def wavelength(self) -> np.ndarray:
        grid = self.wavelengthGrid
        edge = self.lambdaEdge
        result = np.copy(grid[(grid >= self.minLambda) & (grid <= edge)])
        if edge - grid[-1] > 0.1:
            result = np.concatenate([result, [edge]])
        return result

    @property
    def minLambda(self) -> float:
        return self.wavelengthGrid[0]


@dataclass
class HydrogenicContinuum(AtomicContinuum):
    """Hydrogenic continuum: alpha0 at the edge, ~nu^-3 falloff with Gaunt
    factor correction."""
    NlambdaGen: int
    alpha0: float
    minWavelength: float

    def setup(self, atom):
        super().setup(atom)
        if self.minLambda >= self.lambda0:
            raise ValueError('minWavelength above continuum edge')

    def alpha(self, wavelength: np.ndarray) -> np.ndarray:
        Z = self.jLevel.stage
        nEff = Z * np.sqrt(Const.ERydberg
                           / (self.jLevel.E_SI - self.iLevel.E_SI))
        gbf0 = gaunt_bf(self.lambda0, nEff, Z)
        gbf = gaunt_bf(wavelength, nEff, Z)
        alpha = self.alpha0 * gbf / gbf0 * (wavelength / self.lambda0) ** 3
        alpha[wavelength < self.minLambda] = 0.0
        alpha[wavelength > self.lambdaEdge] = 0.0
        return alpha

    def wavelength(self) -> np.ndarray:
        return np.linspace(self.minLambda, self.lambdaEdge, self.NlambdaGen)

    @property
    def minLambda(self) -> float:
        return self.minWavelength
