"""Saha-based LTE equation of state for atmosphere construction.

Plays the role of the reference's Wittmann EOS
(ref: lightweaver/wittmann.py:512-785): given (T, pgas)
it returns the electron density, mass density and H number density from
charge balance over the abundant elements using the Kurucz partition
functions (H- included in the charge balance; molecule formation is
neglected, which is a small correction above ~4000 K).

Used by Atmosphere.make_1d for hydrostatic reconstruction and the
ColumnMass / Tau500 depth scales.
"""
from typing import Optional

import numpy as np

from . import constants as Const
from .atomic_table import DefaultAtomicAbundance, KuruczPfTable, PeriodicTable


class _PointView:
    """Minimal (temperature, ne, nHTot) view for KuruczPf routines."""

    def __init__(self, T, ne, nHTot=None):
        self.temperature = np.asarray(T)
        self.ne = np.asarray(ne)
        self.nHTot = nHTot

    @property
    def Nspace(self):
        return self.temperature.shape[0]


class SahaEos:
    """LTE ionisation equilibrium over the NelemMax most abundant
    elements."""

    def __init__(self, abundance=None, NelemMax: int = 20):
        if abundance is None:
            abundance = DefaultAtomicAbundance
        self.abundance = abundance
        self.pfTable = KuruczPfTable(atomicAbundance=abundance)
        elems = sorted(
            ((abundance[e], e) for e in PeriodicTable.elements
             if e.Z <= 92), reverse=True)[:NelemMax]
        self.elements = [e for (_a, e) in elems]
        self.abunds = np.array([a for (a, _e) in elems])
        self.totalAbund = abundance.totalAbundance
        self.massPerH = abundance.massPerH

    def mean_charge(self, T: np.ndarray, ne: np.ndarray) -> np.ndarray:
        """Electrons donated per H nucleus at (T, ne) (H- counted as a
        negative donor)."""
        view = _PointView(T, np.maximum(ne, 1.0))
        eDonated = np.zeros_like(np.asarray(T, np.float64))
        for e, A in zip(self.elements, self.abunds):
            fj, _ = self.pfTable[e].fj(view)
            stages = np.arange(fj.shape[0])[:, None]
            eDonated += A * np.sum(stages * fj, axis=0)
        # H- sink: n(H-)/nH = ne * Phi(T) * f(H I)
        CI = (Const.HPlanck / (2.0 * np.pi * Const.MElectron)
              * (Const.HPlanck / Const.KBoltzmann))
        PhiHmin = (0.25 * (CI / view.temperature) ** 1.5
                   * np.exp(Const.E_ION_HMIN
                            / (Const.KBoltzmann * view.temperature)))
        fjH, _ = self.pfTable[PeriodicTable.element('H')].fj(view)
        eDonated -= ne * PhiHmin * fjH[0]
        return eDonated

    def _native_tables(self):
        """Pack the per-element Saha data for the C++ core (H first)."""
        elems = sorted(self.elements,
                       key=lambda e: (e.Z != 1,))     # hydrogen first
        abunds = np.array([self.abundance[e] for e in elems])
        pfs = [self.pfTable[e] for e in elems]
        maxStage = max(p.ionPot.shape[0] for p in pfs)
        Npf = pfs[0].Tpf.shape[0]
        nStages = np.array([p.ionPot.shape[0] for p in pfs], np.int32)
        logU = np.zeros((len(elems), maxStage, Npf))
        ionPot = np.zeros((len(elems), maxStage))
        for i, p in enumerate(pfs):
            ns = p.ionPot.shape[0]
            logU[i, :ns] = p.pf
            ionPot[i, :ns] = p.ionPot
        return {'abund': abunds, 'nStages': nStages,
                'ionPot': np.ascontiguousarray(ionPot),
                'Tpf': np.ascontiguousarray(pfs[0].Tpf),
                'logU': np.ascontiguousarray(logU),
                'maxStage': maxStage, 'Npf': Npf}

    def solve_native(self, T, pgas, maxIter=100, tol=1e-8):
        """Native C++ fixed point; returns None if the toolchain or the
        library is unavailable."""
        from .nativert import load_saha_lib
        lib = load_saha_lib()
        if lib is None:
            return None
        if getattr(self, '_nt', None) is None:
            self._nt = self._native_tables()
        nt = self._nt
        T = np.ascontiguousarray(T, np.float64)
        pgas = np.ascontiguousarray(pgas, np.float64)
        N = T.shape[0]
        ne = np.empty(N)
        nHTot = np.empty(N)
        rho = np.empty(N)
        lib.saha_solve(T, pgas, N, len(nt['abund']), nt['nStages'],
                       nt['abund'], nt['ionPot'], nt['Tpf'], nt['Npf'],
                       nt['logU'], nt['maxStage'], self.totalAbund,
                       self.massPerH, maxIter, tol, ne, nHTot, rho)
        return {'ne': ne, 'nHTot': nHTot, 'rho': rho}

    def solve(self, T: np.ndarray, pgas: np.ndarray, maxIter: int = 100,
              tol: float = 1e-8, native: bool = True):
        """(T, pgas) -> dict with ne, nHTot, rho (SI).

        Solves the charge-balance fixed point
          nTot = pgas/(kT);  nHTot = (nTot - ne)/totalAbund;
          ne = nHTot * meanCharge(T, ne).
        Uses the native C++ core when available (nativert), else numpy.
        """
        T = np.asarray(T, np.float64)
        pgas = np.asarray(pgas, np.float64)
        if native:
            out = self.solve_native(T, pgas, maxIter=maxIter, tol=tol)
            if out is not None:
                return out
        nTot = pgas / (Const.KBoltzmann * T)
        ne = 1e-4 * nTot                    # metal-donation starting guess
        for it in range(maxIter):
            nHTot = (nTot - ne) / self.totalAbund
            neNew = nHTot * self.mean_charge(T, ne)
            neNew = np.clip(neNew, 1e-8 * nTot, 0.9 * nTot)
            change = np.max(np.abs(neNew - ne) / np.maximum(neNew, 1e-30))
            ne = 0.5 * (ne + neNew)         # damped fixed point
            if change < tol:
                break
        nHTot = (nTot - ne) / self.totalAbund
        rho = Const.Amu * self.massPerH * nHTot
        return {'ne': ne, 'nHTot': nHTot, 'rho': rho,
                'iterations': it + 1}

    def chi_500(self, T, ne, nHTot) -> np.ndarray:
        """LTE background opacity at 500 nm: H- bf/ff, H ff, Thomson,
        Rayleigh-free (small at 500 nm).  Used for the Tau500 scale."""
        from .atomic_set import hminus_pops
        from .background import (hminus_bf, hminus_ff, hydrogen_ff,
                                 thomson_scattering)
        view = _PointView(T, ne, nHTot)
        fjH, _ = self.pfTable[PeriodicTable.element('H')].fj(view)
        nH0 = fjH[0] * nHTot
        nProton = fjH[1] * nHTot if fjH.shape[0] > 1 else 0.0 * nH0
        nHm = hminus_pops(view, nH0[None, :])
        lam = np.array([500.0])
        chi = thomson_scattering(ne)
        chiHmBf, _ = hminus_bf(lam, T, nHm)
        chiHmFf = hminus_ff(lam, T, ne, nH0)
        chiHff = hydrogen_ff(lam, T, ne, nProton)
        return chi + (chiHmBf + chiHmFf + chiHff).reshape(-1)
