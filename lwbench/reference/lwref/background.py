"""Background opacities: H-, H ff, H2-/H2+, OH/CH, Thomson/Rayleigh,
passive-atom bound-free.

Equivalent to the reference's BasicBackground
(ref: Source/Background.cpp:1264,
 Source/LwMiddleLayer.pyx:1187-1377).  Computed in numpy
at setup time (it depends only on the atmosphere and LTE populations);
results are pinned as device arrays by the Context.

Data tables (Geltman 1962; Stilley & Callaway 1970; John 1988; Bell 1980;
Bates 1952; Victor & Dalgarno 1969; Kurucz OH/CH) are loaded from
data/background_tables.npz.
"""
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
from scipy.interpolate import CubicSpline

from . import constants as Const

from ._data import DATA_DIR
_T = np.load(DATA_DIR / 'background_tables.npz')


def _frac_index(grid, x):
    """Clamped fractional index of x on an ascending grid (the reference's
    `hunt` + linear fraction)."""
    idx = np.clip(np.searchsorted(grid, x, side='right') - 1, 0,
                  len(grid) - 2)
    frac = (x - grid[idx]) / (grid[idx + 1] - grid[idx])
    return np.clip(idx + frac, 0.0, len(grid) - 1.0)


def _bilinear(table, fi, fj):
    """Bilinear interpolation of table[i, j] at fractional indices
    (fi broadcast x fj broadcast)."""
    i0 = np.clip(np.floor(fi).astype(int), 0, table.shape[0] - 2)
    j0 = np.clip(np.floor(fj).astype(int), 0, table.shape[1] - 2)
    di = fi - i0
    dj = fj - j0
    return ((1 - di) * (1 - dj) * table[i0, j0]
            + di * (1 - dj) * table[i0 + 1, j0]
            + (1 - di) * dj * table[i0, j0 + 1]
            + di * dj * table[i0 + 1, j0 + 1])


def thomson_scattering(ne):
    sigma = (8.0 * np.pi / 3.0
             * (Const.QElectron / (np.sqrt(4.0 * np.pi * Const.Epsilon0)
                                   * np.sqrt(Const.MElectron)
                                   * Const.CLight)) ** 4)
    return ne * sigma


def gaunt_ff(lam, charge, T):
    """Free-free Gaunt factor, Seaton (1960); clamped below at 1."""
    x = (Const.HC / (lam * Const.NM_TO_M)) / (Const.ERydberg * charge ** 2)
    x3 = x ** (1.0 / 3.0)
    y = (2.0 * lam * Const.NM_TO_M * Const.KBoltzmann * T) / Const.HC
    gIII = (1.0 + 0.1728 * x3 * (1.0 + y)
            - 0.0496 * x3 ** 2 * (1.0 + (1.0 + y) * y / 3.0))
    return np.maximum(gIII, 1.0)


def hydrogen_ff(lam, temperature, ne, nProton):
    """H free-free opacity (Mihalas 1978, p. 101). lam: [Nlam, 1] vs
    [Nspace] arrays broadcast."""
    C0 = (Const.QElectron ** 2 / (4.0 * np.pi * Const.Epsilon0)
          / np.sqrt(Const.MElectron))
    sigma = (4.0 / 3.0 * np.sqrt(2.0 * np.pi / (3.0 * Const.KBoltzmann))
             * C0 ** 3 / Const.HC)
    nu3 = ((lam * Const.NM_TO_M) / Const.CLight) ** 3
    hc_kla = Const.HC / (Const.KBoltzmann * Const.NM_TO_M * lam)
    stim = 1.0 - np.exp(-hc_kla / temperature)
    gff = gaunt_ff(lam, 1, temperature)
    return (sigma / np.sqrt(temperature) * nu3 * ne * nProton * stim * gff)


_hmin_bf_spline = CubicSpline(_T['hmin_bf_lambda'], _T['hmin_bf_alpha'],
                              bc_type='natural')


def hminus_bf(lam, temperature, nHMinus):
    """H- bound-free (Geltman 1962): chi and eta including stimulated
    emission."""
    lamBF = _T['hmin_bf_lambda']
    inRange = (lam > lamBF[0]) & (lam < lamBF[-1])
    alpha = np.where(inRange, _hmin_bf_spline(np.clip(lam, lamBF[0],
                                                      lamBF[-1])), 0.0)
    alpha = np.maximum(alpha, 0.0) * 1e-21
    hc_kla = Const.HC / (Const.KBoltzmann * Const.NM_TO_M * lam)
    twohnu3_c2 = 2.0 * Const.HC / (Const.NM_TO_M * lam) ** 3
    stimEmis = np.exp(-hc_kla / temperature)
    chi = nHMinus * (1.0 - stimEmis) * alpha
    eta = nHMinus * twohnu3_c2 * stimEmis * alpha
    return chi, eta


def hminus_ff(lam, temperature, ne, nH0):
    """H- free-free: Stilley & Callaway (1970) table, switching to the
    John (1988) parametrisation beyond its range.  Returns chi."""
    lamFF = _T['hmin_ff_lambda']
    thetaFF = _T['hmin_ff_theta']
    kappaT = _T['hmin_ff_kappa']           # [Nlam_t, Ntheta]
    theta = Const.Theta0 / temperature     # [Nspace]
    thetaIdx = _frac_index(thetaFF, theta)

    pe = ne * Const.KBoltzmann * temperature

    lam = np.asarray(lam)
    short = lam < lamFF[-1]
    lamIdx = _frac_index(lamFF, np.where(short, lam, lamFF[0]))
    # table laid out [lambda, theta]
    kappa = _bilinear(kappaT, lamIdx[:, None], thetaIdx[None, :])
    chi_short = (nH0[None, :] * 1.0e-29) * pe[None, :] * kappa

    # John 1988 long-wavelength fit
    A, B, C, D, E, F = (_T['john_A'], _T['john_B'], _T['john_C'],
                        _T['john_D'], _T['john_E'], _T['john_F'])
    lamMu = lam / Const.MICRON_TO_NM
    lamInv = 1.0 / lamMu
    n = np.arange(1, 6)
    Clam = (lamMu[:, None] ** 2 * A[None, 1:] + B[None, 1:]
            + lamInv[:, None] * (C[None, 1:]
            + lamInv[:, None] * (D[None, 1:]
            + lamInv[:, None] * (E[None, 1:]
            + lamInv[:, None] * F[None, 1:]))))          # [Nlam, 5]
    sqrtTheta = np.sqrt(Const.Theta0 / temperature)      # [Nspace]
    thetaPow = sqrtTheta[None, :] ** n[:, None, None]    # [5, 1, Nspace]
    Ck = Const.KBoltzmann * Const.Theta0 * 1.0e-32
    chi_long = (np.sum(Clam.T[:, :, None] * thetaPow, axis=0)
                * nH0[None, :] * (ne * Ck)[None, :])

    return np.where(short[:, None], chi_short, chi_long)


def h2minus_ff(lam, temperature, ne, nH2):
    """H2- free-free (Bell 1980)."""
    lamT = _T['h2min_ff_lambda']
    thetaT = _T['h2min_ff_theta']
    kappaT = _T['h2min_ff_kappa']
    theta = Const.Theta0 / temperature
    thetaIdx = _frac_index(thetaT, theta)
    valid = lam < lamT[-1]
    lamIdx = _frac_index(lamT, np.where(valid, lam, lamT[0]))
    pe = ne * Const.KBoltzmann * temperature
    kappa = _bilinear(kappaT, lamIdx[:, None], thetaIdx[None, :])
    chi = (nH2[None, :] * 1.0e-29) * pe[None, :] * kappa
    return np.where(valid[:, None], chi, 0.0)


def h2plus_ff(lam, temperature, nH0, nProton):
    """H + H+ free-free (Bates 1952)."""
    lamT = _T['h2plus_ff_lambda']
    tempT = _T['h2plus_ff_temp']
    kappaT = _T['h2plus_ff_kappa']
    tempIdx = _frac_index(tempT, temperature)
    valid = lam < lamT[-1]
    lamIdx = _frac_index(lamT, np.where(valid, lam, lamT[0]))
    kappa = _bilinear(kappaT, lamIdx[:, None], tempIdx[None, :])
    chi = (nH0[None, :] * 1.0e-29) * (nProton[None, :] * 1.0e-20) * kappa
    return np.where(valid[:, None], chi, 0.0)


def rayleigh_h2(lam, nH2):
    """Rayleigh scattering off H2 (Victor & Dalgarno 1969 + long-lambda
    fit)."""
    lamT = _T['rayleigh_h2_lambda']
    sigT = _T['rayleigh_h2_sigma']
    a = _T['rayleigh_h2_a']
    valid = lam >= lamT[0]
    sigma_tab = np.interp(lam, lamT, sigT)
    lam2 = 1.0 / lam ** 2
    sigma_fit = (a[0] + (a[1] + a[2] * lam2) * lam2) * lam2 ** 2
    sigma = np.where(lam <= lamT[-1], sigma_tab, sigma_fit)
    sigma = np.where(valid, sigma, 0.0) * Const.MEGABARN_TO_M2
    return sigma[:, None] * nH2[None, :]


def _molecular_bf(lam, temperature, pops, Egrid, Tgrid, crossLog):
    """OH/CH photodissociation: bilinear in (T, E[eV]) of log10 cgs
    cross-sections."""
    Eev = Const.HC / (lam * Const.NM_TO_M) / Const.EV
    validL = (Eev >= Egrid[0]) & (Eev <= Egrid[-1])
    eIdx = _frac_index(Egrid, np.clip(Eev, Egrid[0], Egrid[-1]))
    validT = (temperature >= Tgrid[0]) & (temperature <= Tgrid[-1])
    tIdx = _frac_index(Tgrid, np.clip(temperature, Tgrid[0], Tgrid[-1]))
    # crossLog laid out [E, T]
    kappa = (10.0 ** _bilinear(crossLog, eIdx[:, None], tIdx[None, :])
             * Const.CM_TO_M ** 2)
    hc_kla = Const.HC / (Const.KBoltzmann * Const.NM_TO_M * lam)
    stimEmis = np.exp(-hc_kla[:, None] / temperature[None, :])
    twohnu3_c2 = (2.0 * Const.HC / (Const.NM_TO_M * lam) ** 3)
    valid = validL[:, None] & validT[None, :]
    chi = np.where(valid, pops[None, :] * (1.0 - stimEmis) * kappa, 0.0)
    eta = np.where(valid, pops[None, :] * twohnu3_c2[:, None]
                   * stimEmis * kappa, 0.0)
    return chi, eta


def oh_bf(lam, temperature, nOH):
    return _molecular_bf(lam, temperature, nOH, _T['oh_E'], _T['oh_T'],
                         _T['oh_cross'])


def ch_bf(lam, temperature, nCH):
    return _molecular_bf(lam, temperature, nCH, _T['ch_E'], _T['ch_T'],
                         _T['ch_cross'])


def rayleigh_lines(lam, atom, pops):
    """Rayleigh scattering in the red wings of an atom's resonance lines
    (H Ly-a etc., He).  ref: Source/LwMiddleLayer.pyx:1662-1727
    Returns sca [Nlam, Nspace]."""
    resonance = [l for l in atom.lines if l.i == 0]
    if not resonance:
        return 0.0
    lambdaRed = {id(l): l.wavelength()[-1] for l in atom.lines}
    lambdaLimit = min(lambdaRed[id(l)] for l in resonance)
    C = (2.0 * np.pi * (Const.QElectron / Const.Epsilon0)
         * Const.QElectron / Const.MElectron / Const.CLight)
    sigmaE = (8.0 * np.pi / 3.0
              * (Const.QElectron / (np.sqrt(4.0 * np.pi * Const.Epsilon0)
                                    * np.sqrt(Const.MElectron)
                                    * Const.CLight)) ** 4)
    g0 = atom.levels[0].g
    fomega = np.zeros_like(lam)
    for l in resonance:
        lr = lambdaRed[id(l)]
        use = lam > np.maximum(lr, lambdaLimit)
        denom = np.where(use, (lam / l.lambda0) ** 2 - 1.0, 1.0)
        lam2 = np.where(use, 1.0 / denom, 0.0)
        f = l.Aji * (l.jLevel.g / g0) * (l.lambda0 * Const.NM_TO_M) ** 2 / C
        fomega += np.where(use, f * lam2 ** 2, 0.0)
    sigmaRayleigh = sigmaE * fomega
    return sigmaRayleigh[:, None] * pops[0][None, :]


@dataclass
class Background:
    """chi/eta/sca on the full wavelength grid [Nlam, Nspace]; chi
    includes sca (as in the reference)."""
    chi: np.ndarray
    eta: np.ndarray
    sca: np.ndarray


def basic_background(spect, atmos, eqPops, radSet) -> Background:
    """The default background package: H- bf/ff, H ff, H2 terms if
    molecular pops present, OH/CH if present, Thomson + Rayleigh(H, He),
    and passive-atom b-f."""
    lam = np.asarray(spect.wavelength)
    Nlam = lam.shape[0]
    Nspace = atmos.Nspace
    T = atmos.temperature
    ne = atmos.ne

    chi = np.zeros((Nlam, Nspace))
    eta = np.zeros((Nlam, Nspace))
    sca = np.zeros((Nlam, Nspace))

    nH = eqPops['H']
    nH0 = nH[0]
    nProton = nH[-1]
    nHMinus = eqPops.HminPops

    sca += thomson_scattering(ne)[None, :]

    Bnu = (2.0 * Const.HC / (Const.NM_TO_M * lam[:, None]) ** 3
           / np.expm1(np.minimum(Const.HC_K / lam[:, None] / T[None, :],
                                 500.0)))

    c, e = hminus_bf(lam[:, None], T[None, :], nHMinus[None, :])
    chi += c
    eta += e

    c = hminus_ff(lam, T, ne, nH0)
    chi += c
    eta += c * Bnu

    c = hydrogen_ff(lam[:, None], T[None, :], ne[None, :], nProton[None, :])
    chi += c
    eta += c * Bnu

    # H2+ ff needs only H populations, so the reference computes it
    # unconditionally (ref: Source/Background.cpp:295
    # `computePlus(a.Nspace == H.shape(1))`); H2- ff and H2 Rayleigh
    # additionally need molecular H2 populations.
    c = h2plus_ff(lam, T, nH0, nProton)
    chi += c
    eta += c * Bnu
    if 'H2' in eqPops:
        nH2 = eqPops['H2']
        c = h2minus_ff(lam, T, ne, nH2)
        chi += c
        eta += c * Bnu
        sca += rayleigh_h2(lam, nH2)
    if 'OH' in eqPops:
        c, e = oh_bf(lam, T, eqPops['OH'])
        chi += c
        eta += e
    if 'CH' in eqPops:
        c, e = ch_bf(lam, T, eqPops['CH'])
        chi += c
        eta += e

    if 'H' in radSet:
        sca += rayleigh_lines(lam, radSet['H'], nH)
    if 'He' in radSet:
        sca += rayleigh_lines(lam, radSet['He'], eqPops['He'])

    # Passive atom bound-free
    hc_k = Const.HC / (Const.KBoltzmann * Const.NM_TO_M)
    expla = np.exp(-hc_k / lam[:, None] / T[None, :])
    twohnu3_c2 = 2.0 * Const.HC / (Const.NM_TO_M * lam) ** 3
    for a in radSet.passiveAtoms:
        state = eqPops.atomicPops[a.element]
        nStar = state.nStar
        n = state.n
        for cont in a.continua:
            alpha = cont.alpha(lam)                       # [Nlam]
            gijk = (nStar[cont.i][None, :] / nStar[cont.j][None, :]) * expla
            chi += alpha[:, None] * (1.0 - expla) * n[cont.i][None, :]
            eta += (twohnu3_c2[:, None] * gijk * alpha[:, None]
                    * n[cont.j][None, :])

    chi += sca
    return Background(chi=chi, eta=eta, sca=sca)
