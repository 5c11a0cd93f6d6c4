"""Atmospheric models: stratification, boundary conditions, angular
quadrature.

Setup-time numpy structures; the Context converts these to device arrays.
ref: lightweaver/atmosphere.py (1636 LoC); this is a
re-design focused on the 1D/2D plane-parallel cases.  Hydrostatic
reconstruction uses the Saha EOS (eos.py) when ne/nHTot are not given.
"""
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
from numpy.polynomial.legendre import leggauss

from ._data import DATA_DIR


class ScaleType(Enum):
    Geometric = 0
    ColumnMass = 1
    Tau500 = 2


class BoundaryCondition:
    """Base class for radiation boundary conditions."""

    def compute_bc(self, atmos: 'Atmosphere', spect) -> Optional[np.ndarray]:
        """Return I_incident[Nwave, Nmu, Nspatial] or None when the
        condition is handled analytically in the solver."""
        return None


class NoBc(BoundaryCondition):
    pass


class ZeroRadiation(BoundaryCondition):
    pass


class ThermalisedRadiation(BoundaryCondition):
    pass


class PeriodicRadiation(BoundaryCondition):
    pass


@dataclass
class Stratifications:
    cmass: np.ndarray
    tauRef: np.ndarray


@dataclass
class Layout:
    """Dimensional layout view of an Atmosphere: grids, velocity
    components and per-face boundary conditions keyed by dimensionality
    (ref: lightweaver/atmosphere.py:240-376).  Here it
    is a read-only view derived from the Atmosphere's flat storage
    (``Atmosphere.structure``) rather than the storage itself."""
    Ndim: int
    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    vx: np.ndarray
    vy: np.ndarray
    vz: np.ndarray
    xLowerBc: BoundaryCondition
    xUpperBc: BoundaryCondition
    yLowerBc: BoundaryCondition
    yUpperBc: BoundaryCondition
    zLowerBc: BoundaryCondition
    zUpperBc: BoundaryCondition
    stratifications: Optional[Stratifications] = None

    @classmethod
    def make_3d(cls, x: np.ndarray, y: np.ndarray, z: np.ndarray,
                vx: np.ndarray, vy: np.ndarray, vz: np.ndarray,
                xLowerBc: BoundaryCondition, xUpperBc: BoundaryCondition,
                yLowerBc: BoundaryCondition, yUpperBc: BoundaryCondition,
                zLowerBc: BoundaryCondition, zUpperBc: BoundaryCondition,
                stratifications: Optional[Stratifications] = None) \
            -> 'Layout':
        """Construct a 3D Layout (data model only — like the reference,
        whose solvers are 1D/2D;
        ref: lightweaver/atmosphere.py:326-341)."""
        return cls(Ndim=3, x=np.asarray(x), y=np.asarray(y),
                   z=np.asarray(z), vx=np.asarray(vx), vy=np.asarray(vy),
                   vz=np.asarray(vz),
                   xLowerBc=xLowerBc, xUpperBc=xUpperBc,
                   yLowerBc=yLowerBc, yUpperBc=yUpperBc,
                   zLowerBc=zLowerBc, zUpperBc=zUpperBc,
                   stratifications=stratifications)

    @property
    def Nx(self) -> int:
        return self.x.shape[0]

    @property
    def Ny(self) -> int:
        return self.y.shape[0]

    @property
    def Nz(self) -> int:
        return self.z.shape[0]

    @property
    def Nspace(self) -> int:
        """Total spatial points
        (ref: lightweaver/atmosphere.py:377-390)."""
        if self.Ndim == 1:
            return self.Nz
        if self.Ndim == 2:
            return self.Nx * self.Nz
        if self.Ndim == 3:
            return self.Nx * self.Ny * self.Nz
        raise ValueError(f'Invalid Ndim: {self.Ndim}')

    @property
    def dimensioned_shape(self):
        """Shape to which flat [Nspace] arrays reshape for dimensional
        indexing (ref: atmosphere.py:415-427)."""
        if self.Ndim == 1:
            return (self.Nz,)
        if self.Ndim == 2:
            return (self.Nz, self.Nx)
        if self.Ndim == 3:
            return (self.Nz, self.Ny, self.Nx)
        raise ValueError(f'Unreasonable Ndim ({self.Ndim})')

    def dimensioned_view(self) -> 'Layout':
        """View with the velocity arrays reshaped to
        ``dimensioned_shape`` (ref: atmosphere.py:429-450)."""
        import dataclasses
        sh = self.dimensioned_shape
        rs = lambda a: (np.asarray(a).reshape(sh) if np.asarray(a).size
                        else np.asarray(a))
        return dataclasses.replace(self, vx=rs(self.vx), vy=rs(self.vy),
                                   vz=rs(self.vz))


def _falc_top_pressure(temp: float) -> float:
    """FAL-C-calibrated top-of-atmosphere gas pressure [dyn/cm^2] as a
    function of the top temperature, used when hydrostatic construction
    has no Ptop/PeTop (ref: atmosphere.py:127-166 get_top_pressure)."""
    d = np.load(DATA_DIR / 'wittmann_tables.npz')
    return float(np.interp(temp, d['topTempCoord'], d['topPgasCgs']))


@dataclass
class Atmosphere:
    """1D plane-parallel (or flattened 2D) atmosphere.

    All arrays are [Nspace] with k=0 the top of the atmosphere (closest to
    the observer).  Height decreases with k.
    """
    height: np.ndarray
    temperature: np.ndarray
    vlos: np.ndarray
    vturb: np.ndarray
    ne: np.ndarray
    nHTot: np.ndarray
    B: Optional[np.ndarray] = None
    gammaB: Optional[np.ndarray] = None
    chiB: Optional[np.ndarray] = None
    lowerBc: BoundaryCondition = field(default_factory=ThermalisedRadiation)
    upperBc: BoundaryCondition = field(default_factory=ZeroRadiation)
    stratifications: Optional[Stratifications] = None
    Ndim: int = 1
    # 2D extensions (Ndim == 2): flattened [Nz*Nx] primary arrays plus
    # the x grid and velocity components
    x: Optional[np.ndarray] = None
    Nz: Optional[int] = None
    Nx: Optional[int] = None
    vx: Optional[np.ndarray] = None
    vz: Optional[np.ndarray] = None
    xLowerBc: BoundaryCondition = field(default_factory=PeriodicRadiation)
    xUpperBc: BoundaryCondition = field(default_factory=PeriodicRadiation)
    # 3D extensions (Ndim == 3, data model only — the solvers are 1D/2D
    # exactly as in the reference): flattened [Nz*Ny*Nx] primary arrays
    # (ref: lightweaver/atmosphere.py:253, 326-341)
    y: Optional[np.ndarray] = None
    Ny: Optional[int] = None
    vy: Optional[np.ndarray] = None
    yLowerBc: BoundaryCondition = field(default_factory=PeriodicRadiation)
    yUpperBc: BoundaryCondition = field(default_factory=PeriodicRadiation)

    muz: np.ndarray = field(default=None, repr=False)
    mux: np.ndarray = field(default=None, repr=False)
    muy: np.ndarray = field(default=None, repr=False)
    wmu: np.ndarray = field(default=None, repr=False)

    @property
    def Nspace(self) -> int:
        return self.height.shape[0]

    @property
    def Nrays(self) -> int:
        if self.muz is None:
            raise ValueError('Angular quadrature not set: call quadrature()')
        return self.muz.shape[0]

    @property
    def zLowerBc(self):
        return self.lowerBc

    @property
    def zUpperBc(self):
        return self.upperBc

    @property
    def structure(self) -> 'Layout':
        """Layout view of this atmosphere (ref: the reference's
        Atmosphere.structure attribute)."""
        empty = np.array(())
        nobc = NoBc()
        if self.Ndim == 3:
            sh = (self.Nz, self.Ny, self.Nx)
            return Layout.make_3d(
                x=np.asarray(self.x), y=np.asarray(self.y), z=self.zGrid,
                vx=np.asarray(self.vx).reshape(sh),
                vy=np.asarray(self.vy).reshape(sh),
                vz=np.asarray(self.vz).reshape(sh),
                xLowerBc=self.xLowerBc, xUpperBc=self.xUpperBc,
                yLowerBc=self.yLowerBc, yUpperBc=self.yUpperBc,
                zLowerBc=self.lowerBc, zUpperBc=self.upperBc,
                stratifications=self.stratifications)
        if self.Ndim == 2:
            sh = (self.Nz, self.Nx)
            return Layout(Ndim=2, x=np.asarray(self.x), y=empty,
                          z=self.zGrid,
                          vx=np.asarray(self.vx).reshape(sh),
                          vy=empty,
                          vz=np.asarray(self.vz).reshape(sh),
                          xLowerBc=self.xLowerBc, xUpperBc=self.xUpperBc,
                          yLowerBc=nobc, yUpperBc=nobc,
                          zLowerBc=self.lowerBc, zUpperBc=self.upperBc,
                          stratifications=self.stratifications)
        return Layout(Ndim=1, x=empty, y=empty, z=self.height,
                      vx=empty, vy=empty, vz=self.vlos,
                      xLowerBc=nobc, xUpperBc=nobc,
                      yLowerBc=nobc, yUpperBc=nobc,
                      zLowerBc=self.lowerBc, zUpperBc=self.upperBc,
                      stratifications=self.stratifications)

    @property
    def cmass(self):
        return self.stratifications.cmass if self.stratifications else None

    @property
    def tauRef(self):
        return self.stratifications.tauRef if self.stratifications else None

    @classmethod
    def make_1d(cls, scale: ScaleType, depthScale: np.ndarray,
                temperature: np.ndarray, vlos: np.ndarray,
                vturb: np.ndarray, ne: Optional[np.ndarray] = None,
                hydrogenPops: Optional[np.ndarray] = None,
                nHTot: Optional[np.ndarray] = None,
                B: Optional[np.ndarray] = None,
                gammaB: Optional[np.ndarray] = None,
                chiB: Optional[np.ndarray] = None,
                lowerBc: Optional[BoundaryCondition] = None,
                upperBc: Optional[BoundaryCondition] = None,
                Pgas: Optional[np.ndarray] = None,
                Pe: Optional[np.ndarray] = None,
                Ptop: Optional[float] = None,
                PeTop: Optional[float] = None,
                logG: float = 2.44,
                abundance=None,
                convertScales: bool = True,
                verbose: bool = False) -> 'Atmosphere':
        """Build a 1D atmosphere on a Geometric / ColumnMass / Tau500
        depth scale.  When ne (and/or nHTot) are omitted they are
        reconstructed with the Wittmann EOS: directly from Pgas/Pe when
        given, otherwise by hydrostatic equilibrium (NICOLE's method)
        from Ptop/PeTop (or a FAL-C-calibrated top pressure).

        ref: lightweaver/atmosphere.py:749-1160
        """
        from . import constants as Const
        from .atomic_table import DefaultAtomicAbundance, PeriodicTable
        if abundance is None:
            abundance = DefaultAtomicAbundance

        depthScale = np.asarray(depthScale, dtype=np.float64)
        temperature = np.asarray(temperature, dtype=np.float64)
        vlos = np.asarray(vlos, dtype=np.float64)
        vturb = np.asarray(vturb, dtype=np.float64)
        Nspace = depthScale.shape[0]

        if np.any(temperature < 2000.0):
            raise ValueError('Minimum temperature too low for EOS (< 2000 K)')

        if nHTot is None and hydrogenPops is not None:
            nHTot = np.sum(hydrogenPops, axis=0)

        from .wittmann_eos import BK as BKcgs
        from .wittmann_eos import WittmannEos
        wittAb = np.array([abundance[e] for e in PeriodicTable.elements])
        eos = WittmannEos(abundance=wittAb)
        # SI <-> CGS for the EOS (pressures dyn/cm^2, densities g/cm^3)
        M3_TO_CM3 = 1.0 / Const.CM_TO_M ** 3
        P_SI_TO_CGS = Const.CM_TO_M ** 2 / Const.G_TO_KG

        rhoCgs = None
        if nHTot is None and ne is not None:
            # mass density from the electron pressure
            pe = np.asarray(ne, np.float64) / M3_TO_CM3 * BKcgs * temperature
            rhoCgs = eos.rho_from_pe(temperature, pe)
            nHTot = rhoCgs * M3_TO_CM3 * Const.G_TO_KG / (
                Const.Amu * abundance.massPerH)
        elif ne is None and nHTot is not None:
            rhoCgs = (Const.Amu * abundance.massPerH
                      * np.asarray(nHTot, np.float64)
                      / M3_TO_CM3 / Const.G_TO_KG)
            pe = eos.pe_from_rho(temperature, rhoCgs)
            ne = pe / (BKcgs * temperature) * M3_TO_CM3
        elif ne is None and nHTot is None:
            if Pgas is not None and Pe is None:
                pgas = np.asarray(Pgas, np.float64) * P_SI_TO_CGS
                pe = eos.pe_from_pg(temperature, pgas)
                rhoCgs = eos.rho_from_pg(temperature, pgas)
            elif Pe is not None and Pgas is None:
                pe = np.asarray(Pe, np.float64) * P_SI_TO_CGS
                pgas = eos.pg_from_pe(temperature, pe)
                rhoCgs = eos.rho_from_pe(temperature, pe)
            elif Pgas is None and Pe is None:
                # hydrostatic equilibrium, NICOLE's method (top pressure
                # + midpoint integration with EOS-consistent opacity)
                gravAcc = 10 ** logG / Const.CM_TO_M
                Avog = 6.022045e23
                if Ptop is not None and PeTop is not None:
                    raise ValueError('Cannot set both Ptop and PeTop')
                if PeTop is not None:
                    PeTopC = PeTop * P_SI_TO_CGS
                    PtopC = float(eos.pg_from_pe(temperature[:1],
                                                 PeTopC)[0])
                elif Ptop is not None:
                    PtopC = Ptop * P_SI_TO_CGS
                    PeTopC = float(eos.pe_from_pg(temperature[:1],
                                                  PtopC)[0])
                else:
                    PtopC = _falc_top_pressure(temperature[0])
                    PeTopC = float(eos.pe_from_pg(temperature[:1],
                                                  PtopC)[0])

                if scale == ScaleType.Tau500:
                    tau = depthScale
                elif scale == ScaleType.Geometric:
                    heightCgs = depthScale / Const.CM_TO_M
                else:
                    cmassCgs = (depthScale / Const.G_TO_KG
                                * Const.CM_TO_M ** 2)

                rhoCgs = np.zeros(Nspace)
                chi_c = np.zeros(Nspace)
                pgas = np.zeros(Nspace)
                pe = np.zeros(Nspace)
                pgas[0] = PtopC
                pe[0] = PeTopC
                chi_c[0] = float(eos.cont_opacity(
                    temperature[:1], pgas[:1], pe[:1], [5000.0])[0, 0])
                avg_mol_weight = lambda k: abundance.massPerH / (
                    abundance.totalAbundance + pe[k] / pgas[k])
                rhoCgs[0] = (PtopC * avg_mol_weight(0) / Avog / BKcgs
                             / temperature[0])
                chi_c[0] /= rhoCgs[0]
                for k in range(1, Nspace):
                    chi_c[k] = chi_c[k - 1]
                    rhoCgs[k] = rhoCgs[k - 1]
                    for it in range(200):
                        if scale == ScaleType.Tau500:
                            dtau = tau[k] - tau[k - 1]
                            pgas[k] = (pgas[k - 1] + gravAcc * dtau
                                       / (0.5 * (chi_c[k - 1] + chi_c[k])))
                        elif scale == ScaleType.Geometric:
                            pgas[k] = pgas[k - 1] * np.exp(
                                -gravAcc / Avog / BKcgs
                                * avg_mol_weight(k - 1)
                                * 0.5 * (1.0 / temperature[k - 1]
                                         + 1.0 / temperature[k])
                                * (heightCgs[k] - heightCgs[k - 1]))
                        else:
                            pgas[k] = gravAcc * cmassCgs[k]
                        pe[k] = float(eos.pe_from_pg(temperature[k:k + 1],
                                                     pgas[k])[0])
                        prevChi = chi_c[k]
                        chi_c[k] = float(eos.cont_opacity(
                            temperature[k:k + 1], pgas[k:k + 1],
                            pe[k:k + 1], [5000.0])[0, 0])
                        rhoCgs[k] = (pgas[k] * avg_mol_weight(k) / Avog
                                     / BKcgs / temperature[k])
                        chi_c[k] /= rhoCgs[k]
                        change = (np.abs(prevChi - chi_c[k])
                                  / (prevChi + chi_c[k]))
                        if change < 1e-5:
                            break
                    else:
                        from .utils import ConvergenceError
                        raise ConvergenceError(
                            'No convergence in HSE at depth point '
                            f'{k}, last change {change:2.4e}')
            nHTot = rhoCgs * M3_TO_CM3 * Const.G_TO_KG / (
                Const.Amu * abundance.massPerH)
            ne = pe / (BKcgs * temperature) * M3_TO_CM3
        ne = np.asarray(ne, dtype=np.float64)
        nHTot = np.asarray(nHTot, dtype=np.float64)

        if lowerBc is None:
            lowerBc = ThermalisedRadiation()
        if upperBc is None:
            upperBc = ZeroRadiation()
        if isinstance(lowerBc, PeriodicRadiation) or isinstance(upperBc, PeriodicRadiation):
            raise ValueError('Cannot use periodic BCs on the z axis of a 1D atmosphere')

        rhoSI = Const.Amu * abundance.massPerH * nHTot
        if convertScales:
            # final EOS-consistent pressures + 500 nm continuum opacity
            # for the scale conversions
            rhoCgs = (rhoSI / M3_TO_CM3 / Const.G_TO_KG)
            pgas = eos.pg_from_rho(temperature, rhoCgs)
            pe = eos.pe_from_rho(temperature, rhoCgs)
            chi_c = (eos.cont_opacity(temperature, pgas, pe,
                                      [5000.0])[:, 0] / Const.CM_TO_M)

            if scale == ScaleType.ColumnMass:
                cmass = depthScale
                height = np.zeros(Nspace)
                tau_ref = np.zeros(Nspace)
                tau_ref[0] = chi_c[0] / rhoSI[0] * cmass[0]
                for k in range(1, Nspace):
                    height[k] = height[k - 1] - 2.0 * (
                        (cmass[k] - cmass[k - 1]) / (rhoSI[k - 1] + rhoSI[k]))
                    tau_ref[k] = tau_ref[k - 1] + 0.5 * (
                        (chi_c[k - 1] + chi_c[k]) * (height[k - 1] - height[k]))
                height -= np.interp(1.0, tau_ref, height)
            elif scale == ScaleType.Geometric:
                height = depthScale
                cmass = np.zeros(Nspace)
                tau_ref = np.zeros(Nspace)
                cmass[0] = ((nHTot[0] * abundance.massPerH + ne[0])
                            * (Const.KBoltzmann * temperature[0] / 10 ** logG))
                tau_ref[0] = 0.5 * chi_c[0] * (height[0] - height[1])
                if tau_ref[0] > 1.0:
                    tau_ref[0] = 0.0
                for k in range(1, Nspace):
                    cmass[k] = cmass[k - 1] + 0.5 * ((rhoSI[k - 1] + rhoSI[k])
                                                     * (height[k - 1] - height[k]))
                    tau_ref[k] = tau_ref[k - 1] + 0.5 * (
                        (chi_c[k - 1] + chi_c[k]) * (height[k - 1] - height[k]))
            elif scale == ScaleType.Tau500:
                tau_ref = depthScale
                height = np.zeros(Nspace)
                cmass = np.zeros(Nspace)
                # (the reference integrates chi for cmass here —
                # atmosphere.py:1132-1134 — which yields tau again; we
                # integrate rho, the quantity cmass actually is)
                cmass[0] = tau_ref[0] / chi_c[0] * rhoSI[0]
                for k in range(1, Nspace):
                    height[k] = height[k - 1] - 2.0 * (
                        (tau_ref[k] - tau_ref[k - 1])
                        / (chi_c[k - 1] + chi_c[k]))
                    cmass[k] = cmass[k - 1] + 0.5 * (
                        (rhoSI[k - 1] + rhoSI[k]) * (height[k - 1] - height[k]))
                height -= np.interp(1.0, tau_ref, height)
            else:
                raise ValueError(f'Unknown scale {scale}')
            strat = Stratifications(cmass=cmass, tauRef=tau_ref)
            height = np.ascontiguousarray(height)
        else:
            if scale != ScaleType.Geometric:
                raise ValueError(
                    'Height scale must be provided if scale conversion '
                    'is not applied')
            strat = None
            height = depthScale
        atmos = cls(height=height, temperature=temperature, vlos=vlos,
                    vturb=vturb, ne=np.copy(ne), nHTot=nHTot, B=B,
                    gammaB=gammaB, chiB=chiB, lowerBc=lowerBc,
                    upperBc=upperBc, stratifications=strat)
        return atmos

    def quadrature(self, Nrays: Optional[int] = None,
                   mu: Optional[Sequence[float]] = None,
                   wmu: Optional[Sequence[float]] = None):
        """Set the angular quadrature: Gauss-Legendre on (0,1) in mu for 1D;
        Stepan et al. (2020) near-optimal sets for 2D.
        ref: lightweaver/atmosphere.py:1340-1457
        """
        if self.Ndim == 3:
            # like the reference (atmosphere.py:1453-1457): the 3D data
            # model exists but no 3D solver/quadrature does
            raise NotImplementedError('No 3D angular quadrature: the '
                                      'solvers are 1D/2D')
        if self.Ndim == 1:
            if Nrays is not None and mu is None:
                if Nrays < 1:
                    raise ValueError(f'Unsupported Nrays={Nrays}')
                x, w = leggauss(Nrays)
                self.muz = 0.5 + 0.5 * x
                self.wmu = 0.5 * w
            elif mu is not None:
                if wmu is None or len(mu) != len(wmu):
                    raise ValueError('mu and wmu must both be given, same length')
                self.muz = np.array(mu, dtype=np.float64)
                self.wmu = np.array(wmu, dtype=np.float64)
            else:
                raise ValueError('Provide Nrays or (mu, wmu)')
            self.muy = np.zeros_like(self.muz)
            self.mux = np.sqrt(1.0 - self.muz ** 2)
        else:
            quads = np.load(DATA_DIR / 'quadratures_2d.npz')
            byRays = {int(k.split('n')[1]): k for k in quads.files}
            if Nrays not in byRays:
                raise ValueError(f'2D Nrays must be one of {sorted(byRays)}')
            quad = np.atleast_2d(quads[byRays[Nrays]])
            n = quad.shape[0]
            theta = np.deg2rad(quad[:, 1])
            chi = np.deg2rad(quad[:, 2])
            self.mux = np.concatenate([np.sin(theta) * np.cos(chi),
                                       -np.sin(theta) * np.cos(chi)])
            self.muz = np.concatenate([np.cos(theta), np.cos(theta)])
            w = np.concatenate([quad[:, 0], quad[:, 0]])
            self.wmu = w / np.sum(w)
            self.muy = np.sqrt(np.maximum(
                1.0 - (self.mux ** 2 + self.muz ** 2), 0.0))

    def rays(self, muz: Union[float, Sequence[float]], wmu=None):
        """Replace the quadrature with an explicit set of outgoing rays
        (used for final synthesis)."""
        if np.isscalar(muz):
            muz = [muz]
        self.muz = np.array(muz, dtype=np.float64)
        self.wmu = (np.zeros_like(self.muz) if wmu is None
                    else np.asarray(wmu, dtype=np.float64))
        self.muy = np.zeros_like(self.muz)
        self.mux = np.sqrt(1.0 - self.muz ** 2)

    def vlos_mu(self) -> np.ndarray:
        """Projected bulk velocity [Nrays, Nspace]: mu_z v_z (1D),
        mu_x v_x + mu_z v_z (2D), or mu.v (3D).
        ref: Source/Atmosphere.cpp:5-45"""
        if self.Ndim == 3:
            return (self.mux[:, None] * self.vx[None, :]
                    + self.muy[:, None] * self.vy[None, :]
                    + self.muz[:, None] * self.vz[None, :])
        if self.Ndim == 2:
            return (self.mux[:, None] * self.vx[None, :]
                    + self.muz[:, None] * self.vz[None, :])
        return self.muz[:, None] * self.vlos[None, :]

    @classmethod
    def make_2d(cls, height: np.ndarray, x: np.ndarray,
                temperature: np.ndarray, vx: np.ndarray, vz: np.ndarray,
                vturb: np.ndarray, ne: np.ndarray, nHTot: np.ndarray,
                B: Optional[np.ndarray] = None,
                gammaB: Optional[np.ndarray] = None,
                chiB: Optional[np.ndarray] = None,
                lowerBc: Optional[BoundaryCondition] = None,
                upperBc: Optional[BoundaryCondition] = None,
                xLowerBc: Optional[BoundaryCondition] = None,
                xUpperBc: Optional[BoundaryCondition] = None) \
            -> 'Atmosphere':
        """2D (x, z) cartesian atmosphere; x periodic by default, or
        fixed inflow when both x BCs are callable (compute_bc returning
        [Nlam, Nmu, 2, Nz]).

        height: [Nz] decreasing; x: [Nx] increasing; all field arrays
        [Nz, Nx] (flattened internally, k = z*Nx + x).
        ref: lightweaver/atmosphere.py:1161+"""
        Nz, Nx = temperature.shape
        flat = lambda a: (np.asarray(a, np.float64).reshape(-1)
                          if a is not None else None)
        heightFull = np.repeat(np.asarray(height, np.float64), Nx)
        return cls(
            height=heightFull, temperature=flat(temperature),
            vlos=flat(vz), vturb=flat(vturb), ne=flat(ne), nHTot=flat(nHTot),
            B=flat(B), gammaB=flat(gammaB), chiB=flat(chiB),
            lowerBc=lowerBc or ThermalisedRadiation(),
            upperBc=upperBc or ZeroRadiation(),
            xLowerBc=xLowerBc or PeriodicRadiation(),
            xUpperBc=xUpperBc or PeriodicRadiation(),
            Ndim=2, x=np.asarray(x, np.float64), Nz=Nz, Nx=Nx,
            vx=flat(vx), vz=flat(vz))

    @classmethod
    def make_3d(cls, height: np.ndarray, x: np.ndarray, y: np.ndarray,
                temperature: np.ndarray, vx: np.ndarray, vy: np.ndarray,
                vz: np.ndarray, vturb: np.ndarray, ne: np.ndarray,
                nHTot: np.ndarray,
                B: Optional[np.ndarray] = None,
                gammaB: Optional[np.ndarray] = None,
                chiB: Optional[np.ndarray] = None,
                lowerBc: Optional[BoundaryCondition] = None,
                upperBc: Optional[BoundaryCondition] = None,
                xLowerBc: Optional[BoundaryCondition] = None,
                xUpperBc: Optional[BoundaryCondition] = None,
                yLowerBc: Optional[BoundaryCondition] = None,
                yUpperBc: Optional[BoundaryCondition] = None) \
            -> 'Atmosphere':
        """3D (x, y, z) cartesian atmosphere — DATA MODEL ONLY, exactly
        as in the reference, whose formal solvers are 1D/2D (the Layout
        carries Ndim==3 but ``quadrature`` raises;
        ref: lightweaver/atmosphere.py:326-341, 386, 421).

        height: [Nz] decreasing; x: [Nx], y: [Ny] increasing; all field
        arrays [Nz, Ny, Nx] (flattened internally, k = (z*Ny + y)*Nx + x).
        """
        Nz, Ny, Nx = temperature.shape
        flat = lambda a: (np.asarray(a, np.float64).reshape(-1)
                          if a is not None else None)
        heightFull = np.repeat(np.asarray(height, np.float64), Ny * Nx)
        return cls(
            height=heightFull, temperature=flat(temperature),
            vlos=flat(vz), vturb=flat(vturb), ne=flat(ne), nHTot=flat(nHTot),
            B=flat(B), gammaB=flat(gammaB), chiB=flat(chiB),
            lowerBc=lowerBc or ThermalisedRadiation(),
            upperBc=upperBc or ZeroRadiation(),
            xLowerBc=xLowerBc or PeriodicRadiation(),
            xUpperBc=xUpperBc or PeriodicRadiation(),
            yLowerBc=yLowerBc or PeriodicRadiation(),
            yUpperBc=yUpperBc or PeriodicRadiation(),
            Ndim=3, x=np.asarray(x, np.float64),
            y=np.asarray(y, np.float64), Nz=Nz, Ny=Ny, Nx=Nx,
            vx=flat(vx), vy=flat(vy), vz=flat(vz))

    @property
    def zGrid(self) -> np.ndarray:
        """The z (height) axis [Nz] for 2D/3D atmospheres."""
        if self.Ndim == 2:
            return self.height[::self.Nx]
        if self.Ndim == 3:
            return self.height[::self.Ny * self.Nx]
        return self.height

    def B_projections(self):
        """cos(gamma), cos(2 chi), sin(2 chi) projections of the magnetic
        field onto each ray [Nrays, Nspace] (1D: field angles relative to
        the vertical).
        ref: Source/Atmosphere.cpp:50-84"""
        if self.B is None:
            raise ValueError('No magnetic field present')
        # ray direction: (mux, muy, muz); field dir from (gammaB, chiB)
        bx = np.sin(self.gammaB) * np.cos(self.chiB)
        by = np.sin(self.gammaB) * np.sin(self.chiB)
        bz = np.cos(self.gammaB)
        mux, muy, muz = self.mux, self.muy, self.muz
        b3 = (mux[:, None] * bx[None, :] + muy[:, None] * by[None, :]
              + muz[:, None] * bz[None, :])                  # cos(gamma)
        vertical = np.abs(muz) >= 1.0 - 1e-12               # [Nmu]
        cscTheta = 1.0 / np.sqrt(np.maximum(1.0 - muz ** 2, 1e-30))
        b1 = cscTheta[:, None] * (bz[None, :] - muz[:, None] * b3)
        b2 = cscTheta[:, None] * (muy[:, None] * bx[None, :]
                                  - mux[:, None] * by[None, :])
        denom = np.maximum(1.0 - b3 ** 2, 1e-30)
        cos2chi = (b1 ** 2 - b2 ** 2) / denom
        sin2chi = 2.0 * b1 * b2 / denom
        # field parallel to the ray: azimuth undefined, polarised weights
        # multiply sin^2(gamma) = 0 anyway
        degenerate = (1.0 - b3 ** 2) < 1e-12
        cos2chi = np.where(degenerate, 1.0, cos2chi)
        sin2chi = np.where(degenerate, 0.0, sin2chi)
        v = vertical[:, None]
        cosGamma = np.where(v, np.cos(self.gammaB)[None, :], b3)
        cos2chi = np.where(v, np.cos(2 * self.chiB)[None, :], cos2chi)
        sin2chi = np.where(v, np.sin(2 * self.chiB)[None, :], sin2chi)
        return cosGamma, cos2chi, sin2chi
