"""Wittmann equation of state + Kurucz continuum-opacity package.

Reference parity: ``lightweaver/wittmann.py`` (J. de la Cruz Rodriguez's
Wittmann EOS as shipped in Lightweaver; see reference ``wittmann.py:512-785``
for the class surface and ``:786-1372`` for the ATLAS-9 opacity fits).
The reference evaluates everything per depth point through numba scalar
kernels; this implementation is vectorised over the full depth axis with
masked fixpoint iterations, so a whole atmosphere is one numpy program.
It is host-side setup code (used by hydrostatic atmosphere construction
and scale conversion), so it stays in numpy rather than jax.

Physics: H/H+/H-/H2/H2+ molecular-ionisation equilibrium (Mihalas 1970,
via Wittmann 1974's fits), electron donation from the first ``Ncontr``
elements with Kurucz partition functions, and the Kurucz ATLAS-9
background continuum opacity (H bf/ff, H-, H2+, He I/II, He-, Rayleigh,
electron scattering, and the C I/Mg I/Al I/Si I/Fe I "cool" + N I/O I/
Mg II/Si II/Ca II "luke" metal packages).

Everything in this module is CGS, like the reference; wavelengths are in
Angstrom.  Fit tables are loaded from ``data/wittmann_tables.npz``
(extracted by ``scripts/extract_wittmann_tables.py``) and the partition
functions from ``data/kurucz_pf.npz``.
"""
from pathlib import Path
from typing import Optional

import numpy as np

from ._data import DATA_DIR as _DATA

# CGS constants (NIST, matching the reference's values)
BK = 1.3806488e-16          # Boltzmann [erg/K]
HH = 6.62606957e-27         # Planck [erg s]
CC = 2.99792458e10          # speed of light [cm/s]
AMU = 1.660538921e-24       # atomic mass unit [g]
EV = 1.602176565e-12        # eV in erg
ME = 9.10938188e-28         # electron mass [g]
SAHA_FAC = (2.0 * np.pi * ME * BK / (HH * HH)) ** 1.5
CM1_TO_EV = HH * CC / EV


def _tables():
    if not hasattr(_tables, '_cache'):
        _tables._cache = dict(np.load(_DATA / 'wittmann_tables.npz'))
    return _tables._cache


def _saha_theta(theta, eion, u1, u2, pe):
    """Saha ratio n_{i+1}/n_i as a function of theta=5040/T and the
    electron *pressure* (Mihalas 1970 eq. 5-14 in log form)."""
    return (u2 * np.exp(2.302585093 * (9.0804625434325867 - theta * eion))
            / (u1 * pe * theta ** 2.5))


def _nsaha(t, xne, u0, u1, eion_ev):
    """Saha ratio against electron *density* (used for partial densities)."""
    return (2.0 * SAHA_FAC * (u1 / u0) * t ** 1.5
            * np.exp(-eion_ev * EV / (t * BK)) / xne)


def _molec_equil(theta):
    """log10 dissociation 'constants' for H2 and H2+ as polynomials in
    theta = 5040/T (Wittmann's fits).  Returns (logK_H2, logK_H2+)."""
    yH2 = -11.206998 + theta * (2.7942767
                                + theta * (7.9196803e-2
                                           - theta * 2.4790744e-2))
    yH2p = -12.533505 + theta * (4.9251644
                                 + theta * (-5.6191273e-2
                                            + theta * 3.2687661e-3))
    return yH2, yH2p


class WittmannEos:
    """Depth-vectorised Wittmann EOS.

    Parameters
    ----------
    abundance : array, optional
        Linear abundances indexed by Z-1 (normalised internally).  When
        omitted, the Wittmann default abundance table is used — pass the
        problem's abundance set (e.g. Asplund) for consistency with the
        rest of a model.
    prec : float
        Relative convergence tolerance of the fixpoint loops.
    Ncontr : int
        Number of electron-donor elements included (sorted by Z).
    """

    def __init__(self, abundance: Optional[np.ndarray] = None,
                 prec: float = 1e-5, Ncontr: int = 28):
        tb = _tables()
        self.prec = prec
        self.Ncontr = Ncontr
        self.abund = tb['defaultAbundances'].copy()
        if abundance is not None:
            ab = np.asarray(abundance, dtype=np.float64)
            self.abund[:ab.shape[0]] = ab
        self.abund = self.abund / self.abund.sum()
        self.abOthers = self.abund[1:].sum() / self.abund[0]
        self.aMass = tb['aMass']
        self.aveMass = (self.abund * self.aMass).sum() * AMU
        self.massPerH = (self.abund * self.aMass).sum() / (
            self.aMass[0] * self.abund[0])
        self.rhoFromH = self.massPerH * self.aMass[0] * AMU / BK

        pfd = np.load(_DATA / 'kurucz_pf.npz')
        self.Tpf = pfd['Tpf']
        self.pfTable = pfd['pf']            # [99, 6, NT]
        self.nStages = pfd['nStages']
        self.eion = pfd['ionpot_cm1'] * CM1_TO_EV   # [99, 6] in eV

        self.hEnergy = tb['hEnergy']        # [6] erg
        self.hStatg = tb['hStatg']          # [6]

    # ------------------------------------------------------------------
    # partition functions
    # ------------------------------------------------------------------
    def partition_f(self, n: int, T, only: int = 0) -> np.ndarray:
        """Kurucz partition functions of element ``n`` (Z-1) at ``T`` [K].
        Returns [nStage, Nk] (linear interpolation on the Kurucz grid,
        like the reference)."""
        T = np.atleast_1d(np.asarray(T, dtype=np.float64))
        ns = int(self.nStages[n])
        if only:
            ns = min(ns, only)
        return np.stack([np.interp(T, self.Tpf, self.pfTable[n, s])
                         for s in range(ns)])

    def _donor_pf3(self, T):
        """Partition functions of the first Ncontr elements, 3 stages:
        [Ncontr, 3, Nk] (stage rows beyond an element's table are 0 and
        never used because the matching Saha factor vanishes)."""
        T = np.atleast_1d(np.asarray(T, dtype=np.float64))
        out = np.zeros((self.Ncontr, 3, T.shape[0]))
        for ii in range(self.Ncontr):
            ns = min(int(self.nStages[ii]), 3)
            for s in range(ns):
                out[ii, s] = np.interp(T, self.Tpf, self.pfTable[ii, s])
        return out

    # ------------------------------------------------------------------
    # core molecular-ionisation balance
    # ------------------------------------------------------------------
    def _h_fractions(self, T, pe, pf3, g1, gasc_form=False):
        """Solve the H/H+/H-/H2/H2+ balance at fixed electron pressure.

        Given per-point metal electron donation ``g1`` (electrons per H
        nucleus scaled by total H pressure), solve the quadratic for the
        neutral-H fraction and return the partial-pressure fractions
        (f1..f5 = H, H+, H-, H2+, H2 relative to total H nuclei pressure)
        plus fe (electron pressure / total H pressure).

        ``gasc_form`` reproduces the reference's ``gasc`` variant of the
        same algebra, which differs from ``pe_pg`` in three details (no
        ``pe`` factor or clip on the molecular channels, refinement
        threshold 1e-5 instead of 1e-4, no clip on ``fe``); the two must
        be kept distinct for exact parity.
        """
        theta = 5040.0 / T
        logKH2, logKH2p = _molec_equil(theta)
        if gasc_form:
            g4 = 10.0 ** logKH2                           # H2+ channel
            g5 = 10.0 ** logKH2p                          # H2 channel
        else:
            g4 = pe * 10.0 ** np.clip(logKH2, -30, 30)
            g5 = pe * 10.0 ** np.clip(logKH2p, -30, 30)

        uH = pf3[0]
        g2 = _saha_theta(theta, self.eion[0][0], uH[0], uH[1], pe)  # H+/H
        g3 = 1.0 / np.clip(
            _saha_theta(theta, 0.754, 1.0, uH[0], pe), 1e-30, 1e30)  # H-/H

        a = 1.0 + g2 + g3
        b = 2.0 * (1.0 + g2 / g5 * g4)
        c = g5
        d = g2 - g3
        e = g2 / g5 * g4

        clipabs = lambda x, lo, hi: np.copysign(
            np.clip(np.abs(x), lo, hi), x)
        a = clipabs(a, 1e-15, 1e15)
        d = clipabs(d, 1e-15, 1e15)

        c1 = c * b * b + a * d * b - e * a * a
        c2 = 2.0 * a * e - d * b + a * b * g1
        c3 = -(e + b * g1)
        f1 = 0.5 * c2 / c1
        f1 = -f1 + np.copysign(1.0, c1) * np.sqrt(f1 * f1 - c3 / c1)
        f5 = (1.0 - a * f1) / b
        f4 = e * f5
        f3 = g3 * f1
        f2 = g2 * f1
        fe = f2 - f3 + f4 + g1
        if not gasc_form:
            fe = np.clip(fe, 1e-30, 1e30)
        phtot = pe / fe

        # Wittmann's refinement of the H2 fraction where it is tiny:
        # iterate f5 from the quadratic's siblings (vectorised over the
        # mask of affected points).
        need = f5 <= (1e-5 if gasc_form else 1e-4)
        if np.any(need):
            const6 = g5 / pe * f1 * f1
            const7 = f2 - f3 + g1
            f5r, f4r, fer, ph = f5.copy(), f4.copy(), fe.copy(), phtot.copy()
            active = need.copy()
            for _ in range(5):
                of5 = f5r
                f5r = np.where(active, ph * const6, f5r)
                f4r = np.where(active, e * f5r, f4r)
                fer = np.where(active, const7 + f4r, fer)
                ph = np.where(active, pe / fer, ph)
                diff = 0.5 * np.abs(f5r - of5) / np.maximum(f5r + of5, 1e-300)
                active = active & (diff > 1e-5)
                if not np.any(active):
                    break
            f5 = np.where(need, f5r, f5)
            f4 = np.where(need, f4r, f4)
            fe = np.where(need, fer, fe)
            phtot = np.where(need, ph, phtot)

        return f1, f2, f3, f4, f5, fe, phtot

    def _metal_donation(self, T, pe, pf3, with_fractions=False):
        """Electrons donated by the first two ionised stages of the
        metals (elements 2..Ncontr), relative to H nuclei.  Optionally
        also return each element's neutral fraction (for gasc)."""
        theta = 5040.0 / T
        g1 = np.zeros_like(T)
        neutral = (np.zeros((self.Ncontr, T.shape[0]))
                   if with_fractions else None)
        for ii in range(1, self.Ncontr):
            alfai = self.abund[ii] / self.abund[0]
            u = pf3[ii]
            a = _saha_theta(theta, self.eion[ii][0], u[0], u[1], pe)
            u2 = u[2] if u.shape[0] > 2 else np.zeros_like(u[1])
            ei1 = self.eion[ii][1] if self.eion[ii].shape[0] > 1 else 1e30
            b = _saha_theta(theta, ei1, u[1], u2, pe)
            c = 1.0 + a * (1.0 + b)
            if with_fractions:
                neutral[ii] = alfai / c
                g1 += neutral[ii] * a * (1.0 + 2.0 * b)
            else:
                g1 += alfai / c * a * (1.0 + 2.0 * b)
        return (g1, neutral) if with_fractions else g1

    def _pe_pg_once(self, T, pe, pgas, pf3):
        """One sweep of the reference's pe_pg: recompute pe from the
        molecular-ionisation balance at the current pe estimate."""
        g1 = self._metal_donation(T, pe, pf3)
        f1, f2, f3, f4, f5, fe, _ = self._h_fractions(T, pe, pf3, g1)
        peNew = pgas / (1.0 + (f1 + f2 + f3 + f4 + f5 + self.abOthers) / fe)
        return np.where(peNew <= 0.0, 1e-15, peNew), fe

    # ------------------------------------------------------------------
    # public conversions
    # ------------------------------------------------------------------
    def pe_from_pg(self, T, pg, get_fe=False):
        """Electron pressure from gas pressure [dyn/cm^2]."""
        T = np.atleast_1d(np.asarray(T, dtype=np.float64))
        pg = np.broadcast_to(np.asarray(pg, dtype=np.float64), T.shape).copy()
        # initial guess: H as the only donor (quadratic in ionised fraction)
        nu = self.abund[0]
        sh = 10.0 ** (-0.4771 + 2.5 * np.log10(T) - np.log10(pg)
                      - 13.6 * 5040.0 / T)
        aaa = 1.0 + sh
        bbb = -(nu - 1.0) * sh
        ccc = -sh * nu
        ybh = (-bbb + np.sqrt(bbb * bbb - 4.0 * aaa * ccc)) / (2.0 * aaa)
        pe = pg * ybh / (1.0 + ybh)

        pf3 = self._donor_pf3(T)
        ope = pe
        fe = np.zeros_like(pe)
        dif = np.full_like(pe, 1.1)
        for _ in range(250):
            pe = np.where(np.abs(dif) > self.prec, 0.5 * (ope + pe), pe)
            ope = pe
            peN, feN = self._pe_pg_once(T, pe, pg, pf3)
            upd = np.abs(dif) > self.prec
            pe = np.where(upd, peN, pe)
            fe = np.where(upd, feN, fe)
            dif = np.where(upd, 2.0 * np.abs(pe - ope) / (pe + ope), dif)
            if np.all(np.abs(dif) <= self.prec):
                break
        if get_fe:
            return pe, fe
        return pe

    def gasc(self, T, pe):
        """Gas pressure and partial pressures at fixed electron pressure
        (reference ``gasc``).  Returns (pg, pp) with pp [Ncontr+6, Nk]:
        pp[ii] = neutral partial fraction of element ii; the tail rows are
        f_H, f_H+, f_H2, f_H-, p(H' total), fe."""
        T = np.atleast_1d(np.asarray(T, dtype=np.float64))
        pe = np.broadcast_to(np.asarray(pe, dtype=np.float64), T.shape)
        pf3 = self._donor_pf3(T)
        g1, neutral = self._metal_donation(T, pe, pf3, with_fractions=True)
        f1, f2, f3, f4, f5, fe, phtot = self._h_fractions(
            T, pe, pf3, g1, gasc_form=True)
        pg = pe * (1.0 + (f1 + f2 + f3 + f4 + f5 + self.abOthers) / fe)
        pp = np.zeros((self.Ncontr + 6, T.shape[0]))
        pp[:self.Ncontr] = neutral
        pp[self.Ncontr + 0] = f1
        pp[self.Ncontr + 1] = f2
        pp[self.Ncontr + 2] = f5
        pp[self.Ncontr + 3] = f3
        pp[self.Ncontr + 4] = phtot
        pp[self.Ncontr + 5] = fe
        return pg, pp

    def pg_from_pe(self, T, pe, get_fe=False):
        pg, pp = self.gasc(T, pe)
        if get_fe:
            return pg, pp[-1]
        return pg

    def rho_from_pe(self, T, pe):
        T = np.atleast_1d(np.asarray(T, dtype=np.float64))
        _, fe = self.pg_from_pe(T, pe, get_fe=True)
        return np.asarray(pe) * self.rhoFromH / (fe * T)

    def rho_from_pg(self, T, pg):
        T = np.atleast_1d(np.asarray(T, dtype=np.float64))
        pe, fe = self.pe_from_pg(T, pg, get_fe=True)
        return pe * self.rhoFromH / (fe * T)

    def pe_from_rho(self, T, rho):
        """Electron pressure from mass density [g/cm^3] (fixpoint on the
        total particle density, reference ``pe_from_rho_impl``)."""
        T = np.atleast_1d(np.asarray(T, dtype=np.float64))
        rho = np.broadcast_to(np.asarray(rho, dtype=np.float64), T.shape)
        xna = rho / self.aveMass
        a = np.select([T > 8000.0, T > 4000.0, T > 2000.0],
                      [0.5, 0.1, 0.01], default=0.001)
        xne = a * xna / (1.0 - a)
        pgas = (xna + xne) * BK * T
        pe = np.zeros_like(T)
        dif = np.ones_like(T)
        for _ in range(250):
            act = np.abs(dif) > self.prec
            if not np.any(act):
                break
            peN = self.pe_from_pg(T, pgas)
            pe = np.where(act, peN, pe)
            xnaG = (pgas - pe) / (BK * T)
            dif = np.where(act, np.abs(xna - xnaG) / xna, dif)
            pgas = np.where(act, pgas * xna / xnaG, pgas)
        return pe

    def pg_from_rho(self, T, rho):
        """Gas pressure from mass density (reference ``pg_from_rho_impl``:
        damped fixpoint on pe against the implied density)."""
        T = np.atleast_1d(np.asarray(T, dtype=np.float64))
        rho = np.broadcast_to(np.asarray(rho, dtype=np.float64), T.shape)
        xna = rho / self.aveMass
        a = np.select([T > 8000.0, T > 4000.0, T > 2000.0],
                      [0.5, 0.1, 0.01], default=0.001)
        xne = a * xna / (1.0 - a)
        pgas = (xna + xne) * BK * T
        pe = self.pe_from_pg(T, pgas)
        irho = self.rho_from_pe(T, pe)
        dif = np.ones_like(T)
        for _ in range(100):
            act = dif >= self.prec
            if not np.any(act):
                break
            pe = np.where(act, pe * 0.5 * (1.0 + rho / irho), pe)
            irhoN = self.rho_from_pe(T, pe)
            irho = np.where(act, irhoN, irho)
            dif = np.where(act, np.abs((irho - rho) / rho), dif)
        return self.pg_from_pe(T, pe)

    # ------------------------------------------------------------------
    # partial densities for the opacity package
    # ------------------------------------------------------------------
    def get_X_parts(self, iatom, T, pg, pe, divide_by_u=False, only=0,
                    return_u=False):
        """Partial densities of every ionisation stage of element
        ``iatom`` [nStage, Nk] (reference ``get_X_parts``)."""
        T = np.atleast_1d(np.asarray(T, dtype=np.float64))
        pg = np.broadcast_to(np.asarray(pg, dtype=np.float64), T.shape)
        pe = np.broadcast_to(np.asarray(pe, dtype=np.float64), T.shape)
        tbk = T * BK
        xna = (pg - pe) / tbk
        xne = pe / tbk
        nTot = xna * self.abund[iatom]
        u = self.partition_f(iatom, T, only=only)
        nLev = u.shape[0]
        ratio = [np.ones_like(T)]
        for ii in range(1, nLev):
            ratio.append(_nsaha(T, xne, u[ii - 1], u[ii],
                                self.eion[iatom][ii - 1]))
        # normalise stage fractions: x0 = 1/(1 + r1 + r1 r2 + ...)
        acc = np.ones_like(T)
        for ii in range(nLev - 1, 0, -1):
            acc = 1.0 + acc * ratio[ii]
        xpa = np.empty((nLev, T.shape[0]))
        xpa[0] = 1.0 / acc
        for ii in range(1, nLev):
            xpa[ii] = ratio[ii] * xpa[ii - 1]
        if divide_by_u:
            xpa *= nTot / u
        else:
            xpa *= nTot
        if return_u:
            return xpa, u
        return xpa

    def get_H6_pops(self, T, pg, pe):
        """LTE populations of a 6-level H atom [6, Nk] (cm^-3):
        5 bound levels + protons (reference ``get_H6_pops``)."""
        T = np.atleast_1d(np.asarray(T, dtype=np.float64))
        n, u = self.get_X_parts(0, T, pg, pe, divide_by_u=False,
                                return_u=True)
        res = np.empty((6, T.shape[0]))
        res[5] = n[1]
        for ii in range(5):
            res[ii] = n[0] * (self.hStatg[ii] / u[0]) * np.exp(
                -self.hEnergy[ii] / (BK * T))
        return res

    def get_background_partials(self, T, pg, pe, divide_by_u=True):
        """Partial densities (over partition function when
        ``divide_by_u``) of the 17 species the Kurucz opacity package
        consumes: H, H+, H-, He, He+, He++, C, Al, Si, Si+, Ca, Ca+, Mg,
        Mg+, Fe, N, O.  Returns [17, Nk]."""
        T = np.atleast_1d(np.asarray(T, dtype=np.float64))
        tbk = T * BK
        n = np.empty((17, T.shape[0]))
        for slot, elem, stages in ((3, 1, 3), (6, 5, 1), (7, 12, 1),
                                   (8, 13, 2), (10, 19, 2), (12, 11, 2),
                                   (14, 25, 1), (15, 6, 1), (16, 7, 1)):
            xpa = self.get_X_parts(elem, T, pg, pe, divide_by_u=divide_by_u)
            for s in range(stages):
                n[slot + s] = xpa[s]
        pfH = 0.5 if divide_by_u else 1.0
        _, pp = self.gasc(T, pe)
        phtot = pp[self.Ncontr + 4]
        n[0] = pp[self.Ncontr + 0] * phtot / tbk * pfH   # H I / u(H)
        n[1] = pp[self.Ncontr + 1] * phtot / tbk         # H+
        n[2] = pp[self.Ncontr + 3] * phtot / tbk         # H- (u = 1)
        return n

    def cont_opacity(self, T, pg, pe, wav, with_scatter=False):
        """Background continuum opacity [cm^-1 per cm] on ``wav`` [Å].
        Returns [Nk, Nw] (reference ``cont_opacity`` + ``cop``)."""
        T = np.atleast_1d(np.asarray(T, dtype=np.float64))
        pg = np.broadcast_to(np.asarray(pg, dtype=np.float64), T.shape)
        pe = np.broadcast_to(np.asarray(pe, dtype=np.float64), T.shape)
        wav = np.atleast_1d(np.asarray(wav, dtype=np.float64))
        n = self.get_background_partials(T, pg, pe, divide_by_u=True)
        xne = pe / (T * BK)
        xna = (pg - pe) / (T * BK)
        opac, scat = _kurucz_cop(T, xna, xne, wav, n)
        if with_scatter:
            return opac, scat
        return opac


# ----------------------------------------------------------------------
# Kurucz ATLAS-9 continuum opacity package, vectorised over depth.
# Species densities arrive divided by their partition functions (the fit
# tables already include cross-section x partition-function products).
# Reference: wittmann.py:786-1372; original ATLAS-9 (Kurucz 1970, 1993).
# ----------------------------------------------------------------------

def _coulff(TLOG, FREQLG, NZ):
    """Coulomb free-free Gaunt factor, bilinear on Kurucz's table.
    TLOG vectorised, FREQLG scalar."""
    tb = _tables()
    A0, Z4LOG = tb['A0'], tb['Z4LOG']
    GAMLOG = 10.39638 - TLOG / 1.15129 + Z4LOG[NZ - 1]
    IGAM = np.clip((GAMLOG + 7.0).astype(int), 1, 10)
    HVKTLG = (FREQLG - TLOG) / 1.15129 - 20.63764
    IHVKT = np.clip((HVKTLG + 9.0).astype(int), 1, 11)
    P = GAMLOG - (IGAM - 7)
    Q = HVKTLG - (IHVKT - 9)
    return ((1.0 - P) * ((1.0 - Q) * A0[IHVKT - 1, IGAM - 1]
                         + Q * A0[IHVKT, IGAM - 1])
            + P * ((1.0 - Q) * A0[IHVKT - 1, IGAM]
                   + Q * A0[IHVKT, IGAM]))


def _coulx(N, freq, Z):
    """Hydrogenic bf cross-section for principal quantum number N+1,
    charge Z, at scalar ``freq`` (Kurucz fit with low-n corrections)."""
    tb = _tables()
    n2 = (N + 1.0) ** 2
    if freq < Z * Z * 3.28805e15 / n2:
        return 0.0
    F1 = freq * 1e-10
    clx = 0.2815 / F1 ** 3 / n2 / n2 / (N + 1.0) * Z ** 4
    if N >= 6:
        return clx
    A1, B1, C1 = tb['A1'], tb['B1'], tb['C1']
    zzf = Z * Z / F1
    return clx * (A1[N] + (B1[N] + C1[N] * zzf) * zzf)


def _seaton(freq0, xsect, power, a, freq):
    return (xsect * (a + (1.0 - a) * (freq0 / freq))
            * (freq0 / freq) ** (np.floor(2.0 * power + 0.01) * 0.5))


def _kurucz_cop(T, XNA, XNE, wavs, n):
    """Total continuum opacity + scattering, [Nk, Nw].  ``n`` is the
    [17, Nk] species table from get_background_partials."""
    (H1, H2, HMIN, HE1, HE2, HE3, C1n, AL1, SI1, SI2,
     CA1, CA2, MG1, MG2, FE1, N1n, O1n) = n
    tb = _tables()
    TK = T * BK
    TKEV = TK / EV
    HKT = HH / TK
    TLOG = np.log(T)
    Nk, Nw = T.shape[0], wavs.shape[0]
    OP = np.zeros((Nk, Nw))
    SC = np.zeros((Nk, Nw))

    sqrtT = np.sqrt(T)
    coulff1 = None  # cached per-frequency below

    for iw in range(Nw):
        FREQ = 2.997925e18 / wavs[iw]
        FREQLG = np.log(FREQ)
        FREQ15 = FREQ * 1e-15
        EHVKT = np.exp(-FREQ * HKT)
        STIM = 1.0 - EHVKT

        # ---- H bf + ff (HOP) ----
        FREQ3 = (FREQ * 1e-10) ** 3
        n1 = (np.arange(8) + 1.0) ** 2
        BOLT = (np.exp(-13.595 * (1.0 - 1.0 / n1)[:, None] / TKEV)
                * (2.0 * n1)[:, None] * H1)
        FREET = XNE * (3.6919e-22 / FREQ3) * H2 / sqrtT
        XR = H1 / 13.595 * TKEV
        BOLTEX = np.exp(-13.427 / TKEV) * XR
        EXLIM = np.exp(-13.595 / TKEV) * XR
        CONT = np.array([_coulx(N, FREQ, 1.0) for N in range(8)])
        C = 0.2815 / FREQ3
        if FREQ < 4.05933e13:
            BOLTEX = EXLIM / EHVKT
        cff1 = _coulff(TLOG, FREQLG, 1)
        AHYD = ((CONT[6] * BOLT[6] + CONT[7] * BOLT[7]
                 + (BOLTEX - EXLIM) * C + cff1 * FREET) * STIM
                + (CONT[0:6, None] * BOLT[0:6]).sum(axis=0) * (1.0 - EHVKT))

        # ---- H2+ (H2PLOP) ----
        if FREQ > 3.28805e15:
            AH2P = np.zeros(Nk)
        else:
            FR = -3.0233e3 + (3.7797e2 + (-1.82496e1 + (
                3.9207e-1 - 3.1672e-3 * FREQLG) * FREQLG) * FREQLG) * FREQLG
            ES = -7.342e-3 + (-2.409 + (1.028 + (-0.4230 + (
                0.1224 - 0.01351 * FREQ15) * FREQ15) * FREQ15) * FREQ15
            ) * FREQ15
            AH2P = np.exp(-ES / TKEV + FR) * 2.0 * H1 * H2 * STIM

        # ---- H- bf + ff (HMINOP) ----
        F1A = FREQ * 1e-10
        B = (1.3727e-15 + 4.3748 / FREQ) / F1A
        Cm = -2.5993e-7 / F1A ** 2
        if FREQ <= 1.8259e14:
            HMINBF = 0.0
        elif FREQ >= 2.111e14:
            HMINBF = 6.801e-10 + (5.358e-3 + (1.481e3 + (
                -5.519e7 + 4.808e11 / F1A) / F1A) / F1A) / F1A
        else:
            HMINBF = 3.695e-6 + (-1.251e-1 + 1.052e3 / F1A) / F1A
        HMINFF = (B + Cm / T) * H1 * XNE * 2e-20
        HMINpop = np.where(
            T < 7730.0, HMIN,
            np.exp(0.7552 / TKEV) / (2.0 * 2.4148e15 * T * sqrtT)
            * H1 * XNE)
        AHMIN = HMINBF * (1.0 - EHVKT) * HMINpop * 1e-10 + HMINFF

        # ---- H Rayleigh (HRAYOP) ----
        WAVE = 2.997925e18 / min(FREQ, 2.463e15)
        WW = WAVE * WAVE
        SIG = (5.799e-13 + 1.422e-6 / WW + 2.784 / (WW * WW)) / (WW * WW)
        SIGH = SIG * H1 * 2.0

        # ---- He I bf + ff (HE1OP) ----
        G0, HEFREQ0, CHI0 = tb['G0'], tb['HEFREQ0'], tb['CHI0']
        BOLThe = np.exp(-CHI0[:, None] / TKEV) * G0[:, None] * HE1
        FREEThe = XNE * 1e-10 * HE2 * 1e-10 / sqrtT * 1e-10
        XRLOG = np.log(np.maximum(HE1 * (2.0 / 13.595) * TKEV, 1e-300))
        BOLTEXhe = np.exp(-23.730 / TKEV + XRLOG)
        EXLIMhe = np.exp(-24.587 / TKEV + XRLOG)
        CFREEhe = 3.6919e8 / FREQ3
        Che = 2.815e-1 / FREQ3
        # first He I level whose edge lies blueward of FREQ; the
        # reference's search loop leaves the last level active even when
        # no edge qualifies, so clamp to 9
        NMIN = min(int(np.searchsorted(-HEFREQ0, -FREQ)), 9)
        TRANS = np.zeros(10)
        dums = np.array([
            33.32 - 2.0 * FREQLG,
            -390.026 + (21.035 - 0.318 * FREQLG) * FREQLG,
            26.83 - 1.91 * FREQLG,
            61.21 - 2.9 * FREQLG,
            81.35 - 3.5 * FREQLG,
            12.69 - 1.54 * FREQLG,
            23.85 - 1.86 * FREQLG,
            49.30 - 2.60 * FREQLG,
            85.20 - 3.69 * FREQLG,
            58.81 - 2.89 * FREQLG])
        if NMIN < 10:
            TRANS[NMIN:] = np.exp(dums[NMIN:])
        EXhe = EXLIMhe / EHVKT if FREQ < 2.055e14 else BOLTEXhe
        AHE1 = (((EXhe - EXLIMhe) * Che
                 + (TRANS[:, None] * BOLThe).sum(axis=0))
                + cff1 * FREEThe * CFREEhe) * STIM

        # ---- He II bf + ff (HE2OP) ----
        N12 = (np.arange(9) + 1.0) ** 2
        BOLT2 = (np.exp(-(54.403 - 54.403 / N12)[:, None] / TKEV)
                 * (2.0 * N12)[:, None] * HE2)
        FREET2 = XNE * HE3 / sqrtT
        XR2 = HE2 / 13.595 * TKEV
        BOLTEX2 = np.exp(-53.859 / TKEV) * XR2
        EXLIM2 = np.exp(-54.403 / TKEV) * XR2
        CONT2 = np.array([_coulx(N, FREQ, 2.0) for N in range(9)])
        FREQ3b = (FREQ * 1e-5) ** 3
        CFREE2 = 3.6919e-07 / FREQ3b * 4.0
        C2c = 2.815e14 * 4.0 / FREQ3b
        EX2 = EXLIM2 / EHVKT if FREQ < 1.31522e14 else BOLTEX2
        AHE2 = ((EX2 - EXLIM2) * C2c
                + (CONT2[:, None] * BOLT2).sum(axis=0))
        AHE2 = (AHE2 + _coulff(TLOG, FREQLG, 2) * CFREE2 * FREET2) * STIM
        AHE2 = np.where(AHE2 >= 1e-20, AHE2, 0.0)

        # ---- He- ff (HEMIOP) ----
        Ahe = 3.397e-26 + (-5.216e-11 + 7.039e5 / FREQ) / FREQ
        Bhe = -4.116e-22 + (1.067e-6 + 8.135e9 / FREQ) / FREQ
        Chem = 5.081e-17 + (-8.724e-3 - 5.659e12 / FREQ) / FREQ
        AHEMIN = (Ahe * T + Bhe + Chem / T) * XNE * HE1 * 1e-20

        # ---- He Rayleigh (HERAOP) ----
        WWhe = (2.997925e3 / min(FREQ * 1e-15, 5.15)) ** 2
        arg = 1.0 + (2.44e5 + 5.94e10 / (WWhe - 2.90e5)) / WWhe
        SIGHE = 5.484e-14 / WWhe / WWhe * arg * arg * HE1

        # ---- cool metals: C I, Mg I, Al I, Si I, Fe I (T < 12000) ----
        ACOOL = np.zeros(Nk)
        cool = T < 12000.0
        if np.any(cool):
            xC1 = _c1op(FREQ, TKEV) * C1n
            xMg1 = _mg1op(FREQ, FREQLG, T, TLOG) * MG1
            xAl1 = (2.1e-17 * (1.443e15 / FREQ) ** 3 * 6.0
                    if FREQ > 1.443e15 else 0.0) * AL1
            xSi1 = _si1op(FREQ, FREQLG, T, TLOG) * SI1
            xFe1 = _fe1op(FREQ, HKT) * FE1
            ACOOL = np.where(cool,
                             (xC1 + xMg1 + xAl1 + xSi1 + xFe1) * STIM, 0.0)

        # ---- luke-warm metals: N I, O I, Mg II, Si II, Ca II ----
        ALUKE = np.zeros(Nk)
        luke = T < 30000.0
        if np.any(luke):
            xN1 = _n1op(FREQ, TKEV) * N1n
            xO1 = (9.0 * _seaton(3.28805e15, 2.94e-18, 1.0, 2.66, FREQ)
                   if FREQ >= 3.28805e15 else 0.0) * O1n
            xMg2 = _mg2op(FREQ, TKEV) * MG2
            xSi2 = _si2op(FREQ, FREQLG, T, TLOG) * SI2
            xCa2 = _ca2op(FREQ, TKEV) * CA2
            ALUKE = np.where(luke,
                             (xN1 + xO1 + xMg2 + xSi2 + xCa2) * STIM, 0.0)

        # ---- electron scattering + H2 Rayleigh ----
        SIGEL = 0.6653e-24 * XNE
        WWh2 = (2.997925e18 / min(FREQ, 2.922e15)) ** 2
        SIGh2 = (8.14e-13 + 1.28e-6 / WWh2 + 1.61 / (WWh2 * WWh2)) / (
            WWh2 * WWh2)
        ARG = (4.477 / TKEV - 4.6628e1
               + (1.8031e-3 + (-5.023e-7 + (8.1424e-11 - 5.0501e-15 * T)
                               * T) * T) * T - 1.5 * TLOG)
        Hpop = H1 * 2.0
        SIGH2R = np.where(ARG > -80.0, np.exp(ARG) * Hpop * Hpop * SIGh2,
                          0.0)

        A = AHYD + AHMIN + AH2P + AHE1 + AHE2 + AHEMIN + ACOOL + ALUKE
        Bsc = SIGH + SIGHE + SIGEL + SIGH2R
        OP[:, iw] = A + Bsc
        SC[:, iw] = Bsc
    return OP, SC


def _peach_interp(FREQ, FREQLG, T, TLOG, PEACH, FREQS, FLOG, TLG,
                  tdiv, ntmax, double_minus_one):
    """Shared bilinear interpolation on a Peach cross-section table
    (Mg I / Si I / Si II).  T-vectorised, frequency scalar."""
    NT = np.clip((T / tdiv).astype(int) - (4 if tdiv == 2000.0 else 3),
                 1, ntmax)
    DT = (TLOG - TLG[NT - 1]) / (TLG[NT] - TLG[NT - 1])
    N = int(np.searchsorted(-FREQS, -FREQ, side='right'))
    N = min(N, FREQS.shape[0] - 1)
    D = (FREQLG - FLOG[N]) / (FLOG[N + 1] - FLOG[N])
    if N > 1:
        N = 2 * N - 1 if double_minus_one else 2 * N - 2
    if not double_minus_one and N == PEACH.shape[0] - 1:
        N = PEACH.shape[0] - 2
    D1 = 1.0 - D
    XWL1 = PEACH[N + 1, NT - 1] * D + PEACH[N, NT - 1] * D1
    XWL2 = PEACH[N + 1, NT] * D + PEACH[N, NT] * D1
    return XWL1 * (1.0 - DT) + XWL2 * DT


def _mg1op(FREQ, FREQLG, T, TLOG):
    tb = _tables()
    return np.exp(_peach_interp(FREQ, FREQLG, T, TLOG, tb['PEACH0'],
                                tb['FREQMG'], tb['FLOG0'], tb['TLG0'],
                                1000.0, 6, True))


def _si1op(FREQ, FREQLG, T, TLOG):
    tb = _tables()
    return np.exp(-_peach_interp(FREQ, FREQLG, T, TLOG, tb['PEACH1'],
                                 tb['FREQSI1'], tb['FLOG1'], tb['TLG1'],
                                 1000.0, 8, True)) * 9.0


def _si2op(FREQ, FREQLG, T, TLOG):
    tb = _tables()
    return np.exp(_peach_interp(FREQ, FREQLG, T, TLOG, tb['PEACH2'],
                                tb['FREQSI2'], tb['FLOG2'], tb['TLG2'],
                                2000.0, 5, False)) * 6.0


def _c1op(FREQ, TKEV):
    C1240 = 5.0 * np.exp(-1.264 / TKEV)
    C1444 = np.exp(-2.683 / TKEV)
    X1100 = (_seaton(2.7254e15, 1.219e-17, 2.0, 3.317, FREQ)
             if FREQ >= 2.7254e15 else 0.0)
    X1240 = (_seaton(2.4196e15, 1.030e-17, 1.5, 2.789, FREQ)
             if FREQ >= 2.4196e15 else 0.0)
    X1444 = (_seaton(2.0761e15, 9.590e-18, 1.5, 3.501, FREQ)
             if FREQ >= 2.0761e15 else 0.0)
    return X1100 * 9.0 + X1240 * C1240 + X1444 * C1444


def _n1op(FREQ, TKEV):
    C1130 = 6.0 * np.exp(-3.575 / TKEV)
    C1020 = 10.0 * np.exp(-2.384 / TKEV)
    X853 = (_seaton(3.517915e15, 1.142e-17, 2.0, 4.29, FREQ)
            if FREQ >= 3.517915e15 else 0.0)
    X1020 = (_seaton(2.941534e15, 4.410e-18, 1.5, 3.85, FREQ)
             if FREQ >= 2.941534e15 else 0.0)
    X1130 = (_seaton(2.653317e15, 4.200e-18, 1.5, 4.34, FREQ)
             if FREQ >= 2.653317e15 else 0.0)
    return X853 * 4.0 + X1020 * C1020 + X1130 * C1130


def _mg2op(FREQ, TKEV):
    C1169 = 6.0 * np.exp(-4.43 / TKEV)
    X824 = (_seaton(3.635492e15, 1.40e-19, 4.0, 6.7, FREQ)
            if FREQ >= 3.635492e15 else 0.0)
    X1169 = (5.11e-19 * (2.564306e15 / FREQ) ** 3
             if FREQ >= 2.564306e15 else 0.0)
    return X824 * 2.0 + X1169 * C1169


def _ca2op(FREQ, TKEV):
    C1218 = 10.0 * np.exp(-1.697 / TKEV)
    C1420 = 6.0 * np.exp(-3.142 / TKEV)
    X1044 = (1.08e-19 * (2.870454e15 / FREQ) ** 3
             if FREQ >= 2.870454e15 else 0.0)
    X1218 = (1.64e-17 * np.sqrt(2.460127e15 / FREQ)
             if FREQ >= 2.460127e15 else 0.0)
    X1420 = (_seaton(2.110779e15, 4.13e-18, 3.0, 0.69, FREQ)
             if FREQ >= 2.110779e15 else 0.0)
    return X1044 + X1218 * C1218 + X1420 * C1420


def _fe1op(FREQ, HKT):
    tb = _tables()
    WAVENO = FREQ / 2.99792458e10
    if WAVENO < 21000.0:
        return np.zeros_like(HKT)
    G1, E1, WNO1 = tb['G1'], tb['E1'], tb['WNO1']
    BOLT = G1[:, None] * np.exp(-E1[:, None] * 2.99792458e10 * HKT)
    XXX = (WNO1 + 3000.0 - WAVENO) / WNO1 / 0.1
    XSECT = np.where(WNO1 < WAVENO, 3e-18 / (1.0 + XXX ** 4), 0.0)
    return (XSECT[:, None] * BOLT).sum(axis=0)
