"""The Context: device state + the MALI iteration, in PyTorch.

Port of the 1D path of lightweaver_tpu/context.py: the
'piecewise_bezier3_1d' formal solver, factored Gamma, no Ng on the
populations and no charge conservation; complete redistribution,
angle-averaged PRD and hybrid PRD (prd_redistribute).  Everything outside
that slice raises ValueError rather than running something else.

Precision, as in the JAX package: a float64 state, or a float32 working
dtype (the f32 state, lightweaverrc ``Precision: mixed``) with the
accumulation dtype accumDtype = float64.  In the f32 state the ray
tensors and the kernels run in float32; the Context's own state
(populations, background, thermodynamics, rho, collisional rates) stays
float64 and _working_params casts what the ray math reads; J, Gamma and
the rates are float64 (the sweep and fused kernels sum J in float64, the
line Gamma kernel's float block partials are summed in float64, and the
lambda contractions of gamma_rates run through _sum_lmd_split or, with
gammaAccum='blocked', _sum_lam_blocked).

All ray tensors are direction-major [2, Nlam, Nmu, Nk] (d = 0 the down
sweep, d = 1 the up sweep), the layout the depth-sweep kernel takes.  The
iteration is split into three stage functions with one interface each:

    gather(cfg, params, scaJ)                  -> chiTot, srcNum
    formal_solve(cfg, params, chiTot, srcNum)  -> I, Psi, IeffBase, moments
    gamma_rates(cfg, params, I, Psi, IeffBase, srcNum, moments)
                                               -> Gamma, Rij, Rji

The formal solve goes through ops/sweep.py, which launches the CUDA kernel
on a CUDA device; the other stages are plain torch ops on the chosen
device, as the JAX package leaves them to XLA.  PRD lines carry their
emission-profile ratio rho (params['rhoPrd']) into every stage through
_uv; between MALI steps prd_redistribute refreshes rho (ops/prd.py) and
re-solves the PRD-active wavelengths (build_prd_subset_fn, again through
ops/sweep.py).

Two iteration schemes (Context.set_fs_iter_scheme) put a further kernel
behind a stage:

    'mali_full_precond_pallas': line_kernel_stage runs ops/gamma.py per
        same-atom line group; gamma_rates takes the lines from it.
    'mali_full_precond_fused': fused_stage runs ops/fused.py in place of
        gather and formal_solve (chiTot and srcNum are never formed).

Both take rho from the params of each call; neither covers hybrid PRD.
"""
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import constants as Const
from .atmosphere import Atmosphere, ThermalisedRadiation
from .atomic_model import (AtomicLine, AtomicModel, LineProfileState,
                           LineType)
from .background import basic_background
from .iteration_update import IterationUpdate
from .ops import fused as fusedOps
from .ops import gamma as gammaOps
from .ops.faddeeva import voigt_H
from .ops.linalg import solve_KxK_over_depth
from .ops.ng import Ng
from .ops.planck import planck_nu
from .ops.prd import interp, prd_scatter_rho
from .ops.sweep import formal_solve_sweep
from .utils import ExplodingMatrixError, InitialSolution

DEFAULT_DTYPE = torch.float64
# the dtype of the Context's state and of J, Gamma and the rates in both
# precisions (the JAX package's accumDtype for the f32 state)
STATE_DTYPE = torch.float64
GAMMA_ACCUM = ('exact', 'blocked')

SCHEME_DEFAULT = 'mali_full_precond'
SCHEME_PALLAS = 'mali_full_precond_pallas'
SCHEME_FUSED = 'mali_full_precond_fused'


@dataclass
class TransStatic:
    """Static description of one transition's place in the global
    wavelength grid, with its per-window constants on the device."""
    isLine: bool
    i: int
    j: int
    Nblue: int
    Nred: int
    lambda0: float
    Aji: float = 0.0
    Bji: float = 0.0
    Bij: float = 0.0
    wavelength: np.ndarray = None       # [W] window grid
    wlambda: np.ndarray = None          # [W] integration weights
    alpha: np.ndarray = None            # [W] continuum cross-section
    isPrd: bool = False                 # a PRD line of an active atom
    # device copies of the three arrays above (IterConfig fills them)
    wavelengthT: Optional[torch.Tensor] = None
    wlambdaT: Optional[torch.Tensor] = None
    alphaT: Optional[torch.Tensor] = None

    @property
    def W(self):
        return self.Nred - self.Nblue


def _wlambda(grid: np.ndarray, dopplerWidth: float) -> np.ndarray:
    """Trapezoidal wavelength integration weights over a window
    (ref: Source/LwTransition.hpp:72-82)."""
    w = np.empty_like(grid)
    w[0] = 0.5 * (grid[1] - grid[0])
    w[-1] = 0.5 * (grid[-1] - grid[-2])
    w[1:-1] = 0.5 * (grid[2:] - grid[:-2])
    return w * dopplerWidth


@dataclass
class AtomStatic:
    model: AtomicModel
    Nlevel: int
    trans: List[TransStatic]
    detailed: bool = False
    # overlap analysis: for each level, [(trans_idx, sign)] for chi sums
    chiLists: List[List[Tuple[int, int]]] = field(default_factory=list)
    # for each level, [trans_idx] with j == level (U accumulators)
    ULists: List[List[int]] = field(default_factory=list)

    def build_overlaps(self):
        self.chiLists = [[] for _ in range(self.Nlevel)]
        self.ULists = [[] for _ in range(self.Nlevel)]
        for idx, t in enumerate(self.trans):
            self.chiLists[t.i].append((idx, +1))
            self.chiLists[t.j].append((idx, -1))
            self.ULists[t.j].append(idx)


@dataclass
class IterConfig:
    """Static configuration of the iteration, with the wavelength grid,
    quadrature and per-transition constants placed on ``device``."""
    activeAtoms: List[AtomStatic]
    detailedAtoms: List[AtomStatic]
    Nlam: int
    Nmu: int
    Nk: int
    lowerThermalised: bool
    upperThermalised: bool
    wavelength: np.ndarray      # [Nlam]
    muz: np.ndarray             # [Nmu]
    wmu: np.ndarray             # [Nmu]
    device: torch.device = torch.device('cuda')
    # working dtype of the ray tensors and kernels
    dtype: torch.dtype = DEFAULT_DTYPE
    # dtype of J, Gamma and the rates (float64 for either working dtype)
    accumDtype: torch.dtype = STATE_DTYPE
    # lambda reduction of Gamma/rates under the f32 state: 'exact' in
    # accumDtype, 'blocked' with working-dtype partials of _GAMMA_BLOCK
    # rows (the line Gamma kernel's contract); ignored in float64
    gammaAccum: str = 'exact'
    fsIterScheme: str = SCHEME_DEFAULT
    # hybrid PRD (Context._configure_hprd_coeffs; ref: Source/Prd.cpp:
    # 697-945): the PRD-active wavelength rows, the map from the global
    # grid to them (-1 elsewhere), the comoving-frame interpolation
    # coefficients per PRD line ((ai, ti) -> (i0, frac), each
    # [W, Nmu, 2, Nk] as the JAX package lays them out) and vlos mu [Nmu, Nk]
    hprd: bool = False
    prdIdxs: Optional[np.ndarray] = None
    laToPrdLa: Optional[np.ndarray] = None
    hprdCoeffs: Optional[Dict] = None
    vlosMu: Optional[np.ndarray] = None

    def __post_init__(self):
        self.device = torch.device(self.device)
        t_ = self.tensor
        self.wavelengthT = t_(self.wavelength)
        self.muzT = t_(self.muz)
        self.wmuT = t_(self.wmu)
        for a in self.activeAtoms + self.detailedAtoms:
            for t in a.trans:
                t.wavelengthT = t_(t.wavelength)
                t.wlambdaT = t_(t.wlambda)
                t.alphaT = None if t.alpha is None else t_(t.alpha)

    def tensor(self, x):
        """x in the working dtype on the device."""
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)

    def state(self, x):
        """x in the state dtype (float64) on the device."""
        return torch.as_tensor(np.asarray(x), dtype=STATE_DTYPE,
                               device=self.device)

    @property
    def allAtoms(self):
        return self.activeAtoms + self.detailedAtoms


def _sum_mu(x, wmu):
    """Angular moment: contract x [2, W, Nmu, Nk] against wmu [Nmu] over
    the (up/down, mu) axes -> [W, Nk]."""
    return torch.sum(x * wmu[None, None, :, None], dim=(0, 2))


def _sum_lmd(x, wla, wmu):
    """Full transition integral: contract x [2, W, Nmu, Nk] against
    wla [W, Nk] and wmu [Nmu] over (up/down, lambda, mu) -> [Nk]."""
    return torch.sum(x * wla[None, :, None, :] * wmu[None, None, :, None],
                     dim=(0, 1, 2))


_GAMMA_BLOCK = 32


def _sum_lam_blocked(x, adt):
    """Lambda reduction of x [W, Nk]: working-dtype partials of at most
    _GAMMA_BLOCK rows, the sum of the partials in ``adt`` (the line Gamma
    kernel's contract; gammaAccum='blocked')."""
    W, Nk = x.shape
    nb = -(-W // _GAMMA_BLOCK)
    x = torch.cat([x, x.new_zeros((nb * _GAMMA_BLOCK - W, Nk))])
    part = x.reshape(nb, _GAMMA_BLOCK, Nk).sum(dim=1)
    return part.to(adt).sum(dim=0)


def _sum_lmd_split(x, wla_adt, wmu_adt, wmu_dt, adt, blocked=False):
    """_sum_lmd with the (up/down, mu) contraction in the dtype of x and
    the lambda sum, the one with thousands of terms whose weights span
    decades, in ``adt`` (blocked: _sum_lam_blocked).  x already in adt
    takes the single-pass _sum_lmd (the float64 path)."""
    if x.dtype == adt:
        return _sum_lmd(x, wla_adt, wmu_adt)
    xm = torch.sum(x * wmu_dt[None, None, :, None], dim=(0, 2))
    if blocked:
        return _sum_lam_blocked(xm * wla_adt.to(x.dtype), adt)
    return torch.sum(xm.to(adt) * wla_adt, dim=0)


def line_rho(params, ai: int, ti: int, t: TransStatic):
    """The PRD emission-profile ratio rho [W, Nk] of line (ai, ti) in
    this call's params, or None (complete redistribution)."""
    if not t.isPrd or params.get('rhoPrd') is None:
        return None
    return params['rhoPrd'][ai][ti]


def _uv(cfg: IterConfig, params, ai: int, ti: int, t: TransStatic,
        lo: Optional[int] = None, hi: Optional[int] = None):
    """Uji, Vij, Vji for one transition on the GLOBAL wavelength rows
    [lo, hi) of its window (default: the whole window).
    Lines: [2, w, Nmu, Nk]; continua: [1, w, 1, Nk].
    ref: Source/LwTransition.hpp:93-144"""
    if lo is None:
        lo, hi = t.Nblue, t.Nred
    sl = slice(lo - t.Nblue, hi - t.Nblue)
    lam = t.wavelengthT[sl]
    if t.isLine:
        phi = params['phi'][ai][ti][:, sl]
        hnu_4pi = Const.HC_FOURPI * (t.lambda0 / lam)
        Vij = hnu_4pi[None, :, None, None] * t.Bij * phi
        Vji = (t.Bji / t.Bij) * Vij
        rho = line_rho(params, ai, ti, t)
        if rho is not None:
            i0s = params.get('hprdI0')
            if cfg.hprd and i0s is not None and i0s[ai][ti] is not None:
                # comoving-frame rho: linear interpolation at the
                # Doppler-shifted window position per (d, mu, k); rho
                # stays full-window (shifts cross rows), i0/frac slice
                # (ref: Source/LwTransition.hpp:118-126)
                i0 = i0s[ai][ti][:, sl]
                frac = params['hprdFrac'][ai][ti][:, sl]
                kIdx = torch.arange(rho.shape[1], device=rho.device)
                Vji = Vji * ((1.0 - frac) * rho[i0, kIdx]
                             + frac * rho[i0 + 1, kIdx])
            else:
                # emission profile psi = rho phi: scales Vji and Uji
                # (ref: Source/LwAtom.hpp:119-123)
                Vji = Vji * rho[sl][None, :, None, :]
        Uji = (t.Aji / t.Bji) * Vji
    else:
        nStar = params['allNStar'][ai]
        hc_kl = Const.HC_K / lam                        # [w]
        gij = (nStar[t.i][None, :] / nStar[t.j][None, :]
               * torch.exp(-hc_kl[:, None] / params['temperature'][None, :]))
        alpha = t.alphaT[sl]
        Vij = alpha[:, None].expand(gij.shape)[None, :, None, :]
        Vji = (gij * alpha[:, None])[None, :, None, :]
        twohc = Const.TwoHC / lam ** 3
        Uji = twohc[None, :, None, None] * Vji
    return Uji, Vij, Vji


def _wla(cfg: IterConfig, params, ai: int, ti: int, t: TransStatic):
    """Integration weight wla [W, Nk] (without the 0.5 wmu factor).
    ref: Source/LwAtom.hpp:82-128"""
    wla = t.wlambdaT
    if t.isLine:
        wphi = params['wphi'][ai][ti]
        return wla[:, None] * wphi[None, :] * Const.FOURPI_HC
    w = (wla / t.wavelengthT) * Const.FOURPI_H
    return w[:, None].expand(t.W, cfg.Nk)


def chi_eta_w(cfg, params, ai, ti, lo, hi):
    """(chi_t, eta_t) of transition (ai, ti) on rows [lo, hi)."""
    t = cfg.allAtoms[ai].trans[ti]
    n = params['allPops'][ai]
    Uji, Vij, Vji = _uv(cfg, params, ai, ti, t, lo, hi)
    return n[t.i] * Vij - n[t.j] * Vji, n[t.j] * Uji


def chiW(cfg, params, ai, ti, lo, hi):
    return chi_eta_w(cfg, params, ai, ti, lo, hi)[0]


def etaW(cfg, params, ai, ti, lo, hi):
    return chi_eta_w(cfg, params, ai, ti, lo, hi)[1]


def UjiW(cfg, params, ai, ti, lo, hi):
    t = cfg.allAtoms[ai].trans[ti]
    return _uv(cfg, params, ai, ti, t, lo, hi)[0]


def _working_params(cfg: IterConfig, params):
    """params with everything the ray-tensor math reads in the working
    dtype, plus 'allPops'/'allNStar' (active then detailed atoms): the
    populations, background, thermodynamics, profiles and rho are cast (no
    copy in float64); J stays in accumDtype, C in float64."""
    def cast(x):
        return None if x is None else x.to(cfg.dtype)
    params = dict(params)
    params['allPops'] = [cast(n) for n in
                         list(params['pops']) + list(params['detPops'])]
    params['allNStar'] = [cast(n) for n in
                          list(params['nStar']) + list(params['detNStar'])]
    for key in ('bgChi', 'bgEta', 'bgSca', 'temperature', 'height',
                'upperBcData', 'lowerBcData'):
        params[key] = cast(params.get(key))
    for key in ('phi', 'wphi', 'rhoPrd'):
        if params.get(key) is not None:
            params[key] = [[cast(x) for x in row] for row in params[key]]
    return params


# ---- stage 1: opacity/emissivity gather ---------------------------------
def gather(cfg: IterConfig, params, scaJ):
    """chiTot and srcNum = etaTot + sca*J as [2, Nlam, Nmu, Nk].

    The grid is cut at every window edge; between two edges the covering
    transition set is fixed, so each segment is background + covering
    windows (+ scaJ last, the order of srcNum = etaTot + scaJ) and every
    element is written once by the final concatenation."""
    Nlam, Nmu, Nk = cfg.Nlam, cfg.Nmu, cfg.Nk
    spans = [(t.Nblue, t.Nred, ai, ti)
             for ai, a in enumerate(cfg.allAtoms)
             for ti, t in enumerate(a.trans)]
    edges = sorted({0, Nlam, *(s[0] for s in spans), *(s[1] for s in spans)})
    segsChi, segsSrc = [], []
    for s0, s1 in zip(edges[:-1], edges[1:]):
        segChi = params['bgChi'][s0:s1][None, :, None, :]
        segEta = params['bgEta'][s0:s1][None, :, None, :]
        for (nb, nr, ai, ti) in spans:
            if nb <= s0 and s1 <= nr:
                c, e = chi_eta_w(cfg, params, ai, ti, s0, s1)
                segChi = segChi + c
                segEta = segEta + e
        segEta = segEta + scaJ[s0:s1][None, :, None, :]
        shape = (2, s1 - s0, Nmu, Nk)
        segsChi.append(segChi.expand(shape))
        segsSrc.append(segEta.expand(shape))
    return torch.cat(segsChi, dim=1), torch.cat(segsSrc, dim=1)


# ---- stage 2: formal solution + angular moments -------------------------
def sweep_inputs(cfg: IterConfig, params, chiTot, srcNum):
    """The arguments of ops/sweep.py:formal_solve_sweep for the full grid:
    the ray tensors, the boundary intensities and the quadrature."""
    Iupw_d, Iupw_u = _upwind_intensities(cfg, params, chiTot,
                                         cfg.wavelengthT)
    return (chiTot, srcNum, params['height'], cfg.muzT, Iupw_d, Iupw_u,
            cfg.wmuT)


def formal_solve(cfg: IterConfig, params, chiTot, srcNum):
    """Boundary intensities, then the depth sweep of every ray with its
    angular moments (ops/sweep.py: the CUDA kernel on a CUDA device).
    Returns (I, Psi, IeffBase, moments)."""
    return formal_solve_sweep(*sweep_inputs(cfg, params, chiTot, srcNum))


def _upwind_intensities(cfg: IterConfig, params, chiTot, lam, rows=None):
    """Boundary intensities [NL, Nmu] of the down (upper BC) and up (lower
    BC) sweeps over the rows of chiTot [2, NL, Nmu, Nk], whose wavelengths
    are lam [NL] and, when ``rows`` is given, global grid rows ``rows``."""
    T = params['temperature']
    height = params['height']
    muz = cfg.muzT
    Nk = cfg.Nk
    shape = chiTot.shape[1:3]

    def data(key):
        x = params[key]
        return x if rows is None else x[rows]

    # down sweep (d = 0): upper BC
    if params.get('upperBcData') is not None:
        Iupw_d = data('upperBcData')
    elif cfg.upperThermalised:
        Bnu0 = planck_nu(T[0], lam)
        Bnu1 = planck_nu(T[1], lam)
        dtau = (0.5 * (chiTot[0, :, :, 0] + chiTot[0, :, :, 1])
                * torch.abs(height[0] - height[1]) / muz[None, :])
        Iupw_d = Bnu0[:, None] - (Bnu1[:, None] - Bnu0[:, None]) / dtau
    else:
        Iupw_d = torch.zeros(shape, dtype=cfg.dtype, device=cfg.device)

    # up sweep (d = 1): lower BC
    if params.get('lowerBcData') is not None:
        Iupw_u = data('lowerBcData')
    elif cfg.lowerThermalised:
        BnuN = planck_nu(T[Nk - 1], lam)
        BnuN1 = planck_nu(T[Nk - 2], lam)
        dtau = (0.5 * (chiTot[1, :, :, Nk - 1] + chiTot[1, :, :, Nk - 2])
                * torch.abs(height[Nk - 1] - height[Nk - 2]) / muz[None, :])
        Iupw_u = BnuN[:, None] - (BnuN1[:, None] - BnuN[:, None]) / dtau
    else:
        Iupw_u = torch.zeros(shape, dtype=cfg.dtype, device=cfg.device)
    return Iupw_d, Iupw_u


# ---- scheme 'mali_full_precond_fused': stages 1 and 2 in one kernel ----
def _boundary(cfg, params, key, thermalised, k0, k1):
    """One end's boundary for ops/fused.py: caller data, the Planck rows at
    depths (k0, k1) of a thermalised end, or zero."""
    if params.get(key) is not None:
        return 'data', params[key].contiguous()
    if thermalised:
        T, lam = params['temperature'], cfg.wavelengthT
        return 'therm', torch.stack([planck_nu(T[k0], lam),
                                     planck_nu(T[k1], lam)], dim=1)
    return 'zero', None


def fused_pack(cfg: IterConfig, params):
    """The iteration-constant input of the fused stage: the line profiles
    slot-packed as phiP [C, 2, Nlam, Nmu, Nk] (ops/fused.py), and per slot
    its members (ai, ti, a1 [W]) with a1 = (hc/4pi)(lambda0/lambda) Bij."""
    slots, C = fusedOps.assign_line_slots(cfg.allAtoms)
    phiP = torch.zeros((C, 2, cfg.Nlam, cfg.Nmu, cfg.Nk), dtype=cfg.dtype,
                       device=cfg.device)
    members = [[] for _ in range(C)]
    for (ai, ti), c in sorted(slots.items()):
        t = cfg.allAtoms[ai].trans[ti]
        phiP[c, :, t.Nblue:t.Nred] = params['phi'][ai][ti]
        a1 = cfg.tensor(Const.HC_FOURPI * (t.lambda0 / t.wavelength) * t.Bij)
        members[c].append((ai, ti, a1))
    return {'phiP': phiP, 'members': members}


def fused_inputs(cfg: IterConfig, params, scaJ, pack):
    """The arguments of ops/fused.py:fused_lambda_step for this iteration:
    the background rows (continua folded in), the slots' coefficient rows
    (they hold the populations and a PRD line's rho) and the boundaries;
    and the continuum eta rows of each atom of allAtoms."""
    Nlam, Nk = cfg.Nlam, cfg.Nk

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=cfg.device)

    contChi = zeros(Nlam, Nk)
    contEtaA = [zeros(Nlam, Nk) for _ in cfg.allAtoms]
    for ai, a in enumerate(cfg.allAtoms):
        for ti, t in enumerate(a.trans):
            if t.isLine:
                continue
            c, e = chi_eta_w(cfg, params, ai, ti, t.Nblue, t.Nred)
            contChi[t.Nblue:t.Nred] += c[0, :, 0, :]
            contEtaA[ai][t.Nblue:t.Nred] += e[0, :, 0, :]
    contEta = contEtaA[0]
    for e in contEtaA[1:]:
        contEta = contEta + e

    C = pack['phiP'].shape[0]
    chiCo, etaCo = zeros(C, Nlam, Nk), zeros(C, Nlam, Nk)
    for c, members in enumerate(pack['members']):
        for ai, ti, a1 in members:
            t = cfg.allAtoms[ai].trans[ti]
            n = params['allPops'][ai]
            gS, uS = t.Bji / t.Bij, t.Aji / t.Bji
            ni, nj = n[t.i][None, :], n[t.j][None, :]
            rho = line_rho(params, ai, ti, t)
            if rho is None:
                chiCo[c, t.Nblue:t.Nred] = (ni - gS * nj) * a1[:, None]
                etaCo[c, t.Nblue:t.Nred] = (uS * gS) * a1[:, None] * nj
            else:
                chiCo[c, t.Nblue:t.Nred] = (ni - gS * rho * nj) * a1[:, None]
                etaCo[c, t.Nblue:t.Nred] = ((uS * gS) * a1[:, None] * rho
                                            * nj)

    upper = _boundary(cfg, params, 'upperBcData', cfg.upperThermalised, 0, 1)
    lower = _boundary(cfg, params, 'lowerBcData', cfg.lowerThermalised,
                      Nk - 1, Nk - 2)
    args = (pack['phiP'], chiCo, etaCo, params['bgChi'] + contChi,
            params['bgEta'] + contEta, scaJ, params['height'], cfg.muzT,
            cfg.wmuT, upper, lower)
    return args, contEtaA


def fused_stage(cfg: IterConfig, params, scaJ, pack):
    """Stages 1 and 2 of the fused scheme: fused_inputs, then one call of
    ops/fused.py:fused_lambda_step (the CUDA kernel on a CUDA device).

    Returns (I, Psi, IeffBase, moments, srcRowsA): srcRowsA[ai], per active
    atom, is the mu-independent part of srcNum - etaAtom (bgEta + sca*J +
    the other atoms' continua); gamma_rates adds the other atoms' line eta
    to form the compensated Ieff from positive terms, since srcNum itself
    is never formed."""
    args, contEtaA = fused_inputs(cfg, params, scaJ, pack)
    I, Psi, IeffBase, moments = fusedOps.fused_lambda_step(*args)
    srcRowsA = []
    for ai in range(len(cfg.activeAtoms)):
        srcA = params['bgEta'] + scaJ
        for aj in range(len(cfg.allAtoms)):
            if aj != ai:
                srcA = srcA + contEtaA[aj]
        srcRowsA.append(srcA)
    return I, Psi, IeffBase, moments, srcRowsA


# ---- scheme 'mali_full_precond_pallas': the line part of stage 3 --------
def line_pack(cfg: IterConfig, params):
    """The iteration-constant input of the line Gamma kernel: the
    ops/gamma.py:LineTable of every line group (ops/gamma.py:line_groups)
    of every active atom, with the members' profiles on the group's union
    window [K, 2, Wu, Nmu, Nk], the coefficient rows coef [K, Wu, 4] =
    (a1, Bji/Bij, Aji/Bji, wlambda 4pi/hc), zero outside each member's
    window, wphi [K, Nk], the level statics and a packed rho of ones.
    rho changes between calls (prd_redistribute), so line_inputs writes
    the PRD members' windows of it from each call's params."""
    groups = []
    for ai, a in enumerate(cfg.activeAtoms):
        for members in gammaOps.line_groups(a):
            ts = [a.trans[ti] for ti in members]
            K = len(ts)
            row0 = min(t.Nblue for t in ts)
            Wu = max(t.Nred for t in ts) - row0
            phi = torch.zeros((K, 2, Wu, cfg.Nmu, cfg.Nk), dtype=cfg.dtype,
                              device=cfg.device)
            coef = np.zeros((K, Wu, 4))
            for m, (t, ti) in enumerate(zip(ts, members)):
                lo = t.Nblue - row0
                phi[m, :, lo:lo + t.W] = params['phi'][ai][ti]
                coef[m, lo:lo + t.W, 0] = (Const.HC_FOURPI
                                           * (t.lambda0 / t.wavelength)
                                           * t.Bij)
                coef[m, lo:lo + t.W, 1] = t.Bji / t.Bij
                coef[m, lo:lo + t.W, 2] = t.Aji / t.Bji
                coef[m, lo:lo + t.W, 3] = t.wlambda * Const.FOURPI_HC
            groups.append({
                'ai': ai, 'members': members, 'row0': row0, 'phi': phi,
                'coef': cfg.tensor(coef),
                'wphi': torch.stack([params['wphi'][ai][ti]
                                     for ti in members]).to(cfg.dtype),
                'statics': gammaOps.group_statics(ts)})
    return gammaOps.LineTable(groups, [a.Nlevel for a in cfg.activeAtoms],
                              cfg.Nmu, cfg.Nk)


def line_inputs(cfg: IterConfig, params, I, Psi, IeffBase, srcNum, table):
    """The arguments of ops/gamma.py:line_gamma_rates for this call: the
    table, its packed rho with each PRD member's window written from this
    call's params (ones elsewhere), the ray tensors, and the active
    atoms' per-level continuum chi/U rows, continuum eta and populations
    of this iteration, stacked over the atoms."""
    Nlam, Nk = cfg.Nlam, cfg.Nk
    chiCL = torch.zeros((table.nLev, Nlam, Nk), dtype=cfg.dtype,
                        device=cfg.device)
    UCL = torch.zeros_like(chiCL)
    etaC = torch.zeros((table.nAtoms, Nlam, Nk), dtype=cfg.dtype,
                       device=cfg.device)
    for ai, a in enumerate(cfg.activeAtoms):
        off = table.levOffs[ai]
        for ti, t in enumerate(a.trans):
            if t.isLine:
                continue
            sl = slice(t.Nblue, t.Nred)
            c, e = chi_eta_w(cfg, params, ai, ti, t.Nblue, t.Nred)
            etaC[ai, sl] += e[0, :, 0, :]
            chiCL[off + t.i, sl] += c[0, :, 0, :]
            chiCL[off + t.j, sl] -= c[0, :, 0, :]
            UCL[off + t.j, sl] += UjiW(cfg, params, ai, ti, t.Nblue,
                                       t.Nred)[0, :, 0, :]
    n = torch.cat([params['allPops'][ai]
                   for ai in range(len(cfg.activeAtoms))])
    for gi, g in enumerate(table.groups):
        a = cfg.activeAtoms[g.ai]
        for m, ti in enumerate(g.members):
            t = a.trans[ti]
            r = line_rho(params, g.ai, ti, t)
            if r is not None:
                lo = t.Nblue - g.row0
                table.inputs(gi)[1][m, lo:lo + t.W] = r
    return (table, table.rho, Psi, IeffBase, I, srcNum, chiCL, UCL, etaC, n,
            (0.5 * cfg.wmuT).contiguous())


def line_kernel_stage(cfg: IterConfig, params, I, Psi, IeffBase, srcNum,
                      table):
    """The line kernel of every group of every active atom, in one call of
    ops/gamma.py:line_gamma_rates (one launch of the CUDA kernel on a
    CUDA device).

    Returns per active atom {'line': {ti: {'G4', 'row0', 'chiPsiBar',
    'UPsiBar', 'etaPsiBar'}}, 'pair': {(ti, ti2): {'row0', 'chiU',
    'UChi'}}}: the Gamma/rate block partials and the mu-reduced chi/U/eta
    x Psi rows of each line (and line pair, ti < ti2) on its group's
    window, which gamma_rates uses in place of the line windows."""
    args = line_inputs(cfg, params, I, Psi, IeffBase, srcNum, table)
    outs = table.views(*gammaOps.line_gamma_rates(*args))
    out = [{'line': {}, 'pair': {}} for _ in cfg.activeAtoms]
    for gi, (g, (G4, PPB, PairPPB)) in enumerate(zip(table.groups, outs)):
        a = cfg.activeAtoms[g.ai]
        n = params['allPops'][g.ai]
        line, pair = out[g.ai]['line'], out[g.ai]['pair']
        members, row0 = g.members, g.row0
        _, rhoG, coef, _ = table.inputs(gi)
        chiFac, UFac = [], []
        for m, ti in enumerate(members):
            t = a.trans[ti]
            a1 = coef[m, :, 0][:, None]
            rho = rhoG[m]
            gS, uS = t.Bji / t.Bij, t.Aji / t.Bji
            chiFac.append((n[t.i][None, :] - gS * rho * n[t.j][None, :])
                          * a1)
            UFac.append(uS * gS * a1 * rho)
            line[ti] = {'G4': G4[m], 'row0': row0,
                        'chiPsiBar': chiFac[m] * PPB[m],
                        'UPsiBar': UFac[m] * PPB[m],
                        'etaPsiBar': n[t.j][None, :] * UFac[m] * PPB[m]}
        pairs = [(m, m2) for m in range(len(members))
                 for m2 in range(m + 1, len(members))]
        for p, (m, m2) in enumerate(pairs):
            pair[(members[m], members[m2])] = {
                'row0': row0,
                'chiU': chiFac[m] * UFac[m2] * PairPPB[p],
                'UChi': UFac[m] * chiFac[m2] * PairPPB[p]}
    return out


# ---- stage 3: factored Gamma and rates ----------------------------------
def gamma_rates(cfg: IterConfig, params, I, Psi, IeffBase, srcNum, moments,
                lineTerms=None, srcRowsA=None):
    """Preconditioned rate matrices Gamma [Nl, Nl, Nk] and radiative rates
    Rij/Rji [Nk] per transition, for each active atom.

    Factored: mu-independent (continuum) transitions contract against the
    sweep's angular moments (PsiBar, IBar, IeffSrcBar) instead of the full
    ray tensors; lines contract over their own windows.  With
    ``lineTerms`` (line_kernel_stage, scheme 'mali_full_precond_pallas')
    the lines' Gamma/rates and their products with Psi come from the line
    kernel instead.  Under the fused scheme srcNum is None and
    ``srcRowsA`` (fused_stage) forms the compensated Ieff of the lines.

    Gamma, Rij and Rji come out in accumDtype.  The ray-tensor integrands
    are in the working dtype; the moments are cast to accumDtype and every
    lambda contraction runs in it (_sum_lmd_split, lam_sum), the JAX
    package's mixed-precision contract (lightweaver_tpu/context.py:
    1098-1522); in float64 all of it is float64.
    ref: Source/SimdFullIterationTemplates.hpp:240-508"""
    Nmu, Nk = cfg.Nmu, cfg.Nk
    dt, adt, dev = cfg.dtype, cfg.accumDtype, cfg.device
    wmu2 = (0.5 * cfg.wmuT).to(adt)
    wmu2w = 0.5 * cfg.wmuT
    oneBar = torch.sum(wmu2) * 2.0
    blockedAcc = cfg.gammaAccum == 'blocked' and dt != adt
    # element dtype of the [W, Nk] lambda integrands
    cdt = dt if blockedAcc else adt
    PsiBar = moments['PsiBar'].to(adt)
    IBar = moments['IBar'].to(adt)
    IeffBaseSrcBar = moments['IeffSrcBar'].to(adt)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def lam_sum(x):
        """Lambda reduction of a [W, Nk] integrand in cdt."""
        if blockedAcc:
            return _sum_lam_blocked(x, adt)
        return torch.sum(x, dim=0)

    def sum_lmd(x, wlaA):
        return _sum_lmd_split(x, wlaA, wmu2, wmu2w, adt, blockedAcc)

    GammaOut, RijOut, RjiOut = [], [], []
    for ai, a in enumerate(cfg.activeAtoms):
        lt = None if lineTerms is None else lineTerms[ai]

        def fn_on(fn, t2i, lo, hi):
            return fn(cfg, params, ai, t2i, lo, hi)

        def kernel_rows(t2i, key, lo, hi):
            """Rows [lo, hi) of the line kernel's [Wu, Nk] row ``key``."""
            pl = lt['line'][t2i]
            return pl[key][lo - pl['row0']:hi - pl['row0']]

        def level_sum_on_window(t, items, fn, signed):
            """Level-list sum over t's window [2, W, Nmu, Nk], members
            recomputed on the overlap rows via ``fn``."""
            out = zeros(2, t.W, Nmu, Nk)
            for item in items:
                t2i, sign = item if signed else (item, 1)
                t2 = a.trans[t2i]
                lo, hi = max(t.Nblue, t2.Nblue), min(t.Nred, t2.Nred)
                if hi <= lo:
                    continue
                out[:, lo - t.Nblue:hi - t.Nblue] += sign * fn_on(fn, t2i,
                                                                  lo, hi)
            return out

        def eta_atom_on_window(lo, hi):
            """Atom's total eta restricted to [lo, hi) as [2, hi-lo, ...]."""
            out = zeros(2, hi - lo, Nmu, Nk)
            for t2i, t2 in enumerate(a.trans):
                l2, h2 = max(lo, t2.Nblue), min(hi, t2.Nred)
                if h2 <= l2:
                    continue
                out[:, l2 - lo:h2 - lo] += fn_on(etaW, t2i, l2, h2)
            return out

        def eta_lines_other_on_window(lo, hi):
            """The OTHER atoms' line eta on [lo, hi): with srcRowsA it
            completes srcNum - etaAtom as a sum of positive terms."""
            out = zeros(2, hi - lo, Nmu, Nk)
            for aj, a2 in enumerate(cfg.allAtoms):
                if aj == ai:
                    continue
                for tj, t2 in enumerate(a2.trans):
                    l2, h2 = max(lo, t2.Nblue), min(hi, t2.Nred)
                    if not t2.isLine or h2 <= l2:
                        continue
                    out[:, l2 - lo:h2 - lo] += etaW(cfg, params, aj, tj, l2,
                                                    h2)
            return out

        def cont_part_on(fn, items, signed, lo, hi):
            """[hi-lo, Nk] sum of the continuum members of a level list
            restricted to [lo, hi), in cdt."""
            out = zeros(hi - lo, Nk, dtype=cdt)
            for item in items:
                t2i, sign = item if signed else (item, 1)
                t2 = a.trans[t2i]
                if t2.isLine:
                    continue
                l2, h2 = max(lo, t2.Nblue), min(hi, t2.Nred)
                if h2 <= l2:
                    continue
                out[l2 - lo:h2 - lo] += sign * fn_on(
                    fn, t2i, l2, h2)[0, :, 0, :].to(cdt)
            return out

        def cross_bar(t, listX, listU, wlaA):
            """[Nk] = sum over t's window of wla * wmu2 * Psi * chiLevel
            * ULevel (continuum x continuum through PsiBar, line terms
            over their overlap rows)."""
            lo, hi = t.Nblue, t.Nred
            XC = cont_part_on(chiW, listX, True, lo, hi)
            UC = cont_part_on(UjiW, listU, False, lo, hi)
            total = lam_sum(XC * UC * wlaA.to(cdt) * PsiBar[lo:hi].to(cdt))
            # line(chi) x continuum(U) and line x line terms
            for t2i, sign in listX:
                t2 = a.trans[t2i]
                if not t2.isLine:
                    continue
                l2, h2 = max(lo, t2.Nblue), min(hi, t2.Nred)
                if h2 <= l2:
                    continue
                if lt is not None:
                    # chi_t2 is mu-independent x phi: the angular sum
                    # factors into the kernel's phi x Psi moment
                    total = total + sign * torch.sum(
                        kernel_rows(t2i, 'chiPsiBar', l2, h2).to(adt)
                        * UC[l2 - lo:h2 - lo] * wlaA[l2 - lo:h2 - lo], dim=0)
                else:
                    chiSub = fn_on(chiW, t2i, l2, h2)
                    total = total + sign * sum_lmd(
                        chiSub * Psi[:, l2:h2],
                        UC[l2 - lo:h2 - lo] * wlaA[l2 - lo:h2 - lo])
                for t3i in listU:
                    t3 = a.trans[t3i]
                    if not t3.isLine:
                        continue
                    l3, h3 = max(l2, t3.Nblue), min(h2, t3.Nred)
                    if h3 <= l3:
                        continue
                    if lt is not None:
                        # the pair moment: chi_t2 U_t3 Psi, mu-reduced
                        pp = lt['pair'][(min(t2i, t3i), max(t2i, t3i))]
                        rows = pp['chiU'] if t2i < t3i else pp['UChi']
                        total = total + sign * torch.sum(
                            rows[l3 - pp['row0']:h3 - pp['row0']].to(adt)
                            * wlaA[l3 - lo:h3 - lo], dim=0)
                        continue
                    total = total + sign * sum_lmd(
                        fn_on(chiW, t2i, l3, h3) * fn_on(UjiW, t3i, l3, h3)
                        * Psi[:, l3:h3], wlaA[l3 - lo:h3 - lo])
            # continuum(chi) x line(U) terms
            for t3i in listU:
                t3 = a.trans[t3i]
                if not t3.isLine:
                    continue
                l3, h3 = max(lo, t3.Nblue), min(hi, t3.Nred)
                if h3 <= l3:
                    continue
                if lt is not None:
                    total = total + torch.sum(
                        kernel_rows(t3i, 'UPsiBar', l3, h3).to(adt)
                        * XC[l3 - lo:h3 - lo] * wlaA[l3 - lo:h3 - lo], dim=0)
                    continue
                total = total + sum_lmd(
                    fn_on(UjiW, t3i, l3, h3) * Psi[:, l3:h3],
                    XC[l3 - lo:h3 - lo] * wlaA[l3 - lo:h3 - lo])
            return total

        Gamma = (params['crsw'] * params['C'][ai]).to(adt)

        # IeffBar for this atom: global moment minus the Psi*etaAtom
        # moment (continua via PsiBar, lines over their windows)
        PsiEtaBar = zeros(cfg.Nlam, Nk, dtype=adt)
        for ti, t in enumerate(a.trans):
            sl = slice(t.Nblue, t.Nred)
            if t.isLine and lt is not None:
                PsiEtaBar[sl] += kernel_rows(ti, 'etaPsiBar', t.Nblue,
                                             t.Nred).to(adt)
                continue
            eta = fn_on(etaW, ti, t.Nblue, t.Nred)
            if t.isLine:
                PsiEtaBar[sl] += _sum_mu(eta * Psi[:, sl], wmu2w).to(adt)
            else:
                PsiEtaBar[sl] += eta[0, :, 0, :].to(adt) * PsiBar[sl]
        IeffBarA = IeffBaseSrcBar - PsiEtaBar

        Rij, Rji = [], []
        for ti, t in enumerate(a.trans):
            sl = slice(t.Nblue, t.Nred)
            if t.isLine and lt is not None:
                # the kernel's lambda-block partials, summed here in adt
                G4 = lt['line'][ti]['G4'].to(adt)
                Gamma[t.i, t.j] += torch.sum(G4[0], dim=0)
                Gamma[t.j, t.i] += torch.sum(G4[1], dim=0)
                Rij.append(torch.sum(G4[2], dim=0))
                Rji.append(torch.sum(G4[3], dim=0))
                continue
            Uji, Vij, Vji = _uv(cfg, params, ai, ti, t)
            wlaA = _wla(cfg, params, ai, ti, t).to(adt)  # [W, Nk]

            if not t.isLine:
                UjiC, VijC, VjiC = (x[0, :, 0, :].to(cdt)
                                    for x in (Uji, Vij, Vji))
                wlaB = wlaA.to(cdt)
                oneBarC = oneBar.to(cdt)
                Ieff_b = IeffBarA[sl].to(cdt)
                Gij = (lam_sum((UjiC * oneBarC + VjiC * Ieff_b) * wlaB)
                       - cross_bar(t, a.chiLists[t.i], a.ULists[t.j], wlaA))
                Gji = (lam_sum(VijC * Ieff_b * wlaB)
                       - cross_bar(t, a.chiLists[t.j], a.ULists[t.i], wlaA))
                Gamma[t.i, t.j] += Gij
                Gamma[t.j, t.i] += Gji
                IBar_w = IBar[sl].to(cdt)
                Rij.append(lam_sum(VijC * IBar_w * wlaB))
                Rji.append(lam_sum((UjiC * oneBarC + VjiC * IBar_w) * wlaB))
                continue

            # compensated MALI effective intensity on the line window:
            # I - Psi*etaAtom assembled from non-cancelling terms
            Psi_w = Psi[:, sl]
            I_w = I[:, sl]
            if srcNum is None:
                srcO = (srcRowsA[ai][sl][None, :, None, :]
                        + eta_lines_other_on_window(t.Nblue, t.Nred))
                Ieff_w = IeffBase[:, sl] + Psi_w * srcO
            else:
                etaA_w = eta_atom_on_window(t.Nblue, t.Nred)
                Ieff_w = IeffBase[:, sl] + Psi_w * (srcNum[:, sl] - etaA_w)
            chi_i = level_sum_on_window(t, a.chiLists[t.i], chiW, True)
            chi_j = level_sum_on_window(t, a.chiLists[t.j], chiW, True)
            U_i = level_sum_on_window(t, a.ULists[t.i], UjiW, False)
            U_j = level_sum_on_window(t, a.ULists[t.j], UjiW, False)
            integ_ij = (Uji + Vji * Ieff_w) - Psi_w * chi_i * U_j
            integ_ji = (Vij * Ieff_w) - Psi_w * chi_j * U_i
            Gamma[t.i, t.j] += sum_lmd(integ_ij, wlaA)
            Gamma[t.j, t.i] += sum_lmd(integ_ji, wlaA)
            Rij.append(sum_lmd(I_w * Vij, wlaA))
            Rji.append(sum_lmd(Uji + I_w * Vji, wlaA))

        # finalise: diagonal = -column sums of off-diagonals
        eye = torch.eye(a.Nlevel, dtype=adt, device=dev)[:, :, None]
        Gamma = Gamma * (1.0 - eye)
        colSum = torch.sum(Gamma, dim=0)
        Gamma = Gamma - eye * colSum[None, :, :]
        GammaOut.append(Gamma)
        RijOut.append(Rij)
        RjiOut.append(Rji)
    return GammaOut, RijOut, RjiOut


def _sca_j(cfg: IterConfig, params):
    """The coherent scattering emissivity bgSca * J of working params in
    the working dtype: J is carried in accumDtype, the formal solve reads
    it in the working dtype."""
    return params['bgSca'] * params['J'].to(cfg.dtype)


def build_iteration_fn(cfg: IterConfig):
    """The full MALI step as a function of the params dict.

    params = {
      'J': [Nlam, Nk], 'bgChi'/'bgEta'/'bgSca': [Nlam, Nk],
      'temperature'/'height': [Nk],
      'pops'/'nStar': per active atom [Nlevel, Nk],
      'detPops'/'detNStar': per detailed atom,
      'C': per active atom [Nl, Nl, Nk] collisional matrices,
      'crsw': collisional-radiative switching factor (float),
      'phi': nested [atom][trans] -> [2, W, Nmu, Nk] or None,
      'wphi': nested [atom][trans] -> [Nk] or None,
      'rhoPrd': nested [atom][trans] -> [W, Nk] for PRD lines, else None
                (the key may be absent: complete redistribution),
      'vlosMu': [Nmu, Nk], 'hprdI0'/'hprdFrac': nested [atom][trans] ->
                [2, W, Nmu, Nk] (int64 / float) for PRD lines, under
                cfg.hprd only,
      'upperBcData'/'lowerBcData': [Nlam, Nmu] or None,
      'pack': the scheme's iteration-constant kernel input (iteration.pack)
              or None; built in the call when absent,
    }
    Returns {'Gamma', 'Rij', 'Rji', 'J', 'I' (emergent [Nlam, Nmu]),
    'dJ' (0-d tensor)}, and under cfg.hprd 'JRest' [Nprd, Nk].  The
    stages are exposed as attributes.

    cfg.fsIterScheme selects the stages: 'mali_full_precond' runs gather,
    formal_solve and gamma_rates; 'mali_full_precond_pallas' adds the line
    kernel stage before gamma_rates; 'mali_full_precond_fused' replaces
    gather and formal_solve with fused_stage.
    """
    scheme = cfg.fsIterScheme

    def pack(params):
        if scheme == SCHEME_PALLAS:
            return line_pack(cfg, params)
        if scheme == SCHEME_FUSED:
            return fused_pack(cfg, params)
        return None

    def iteration(params):
        packed = params.get('pack')
        if packed is None:
            packed = pack(params)
        params = _working_params(cfg, params)
        Jdag = params['J'].to(cfg.accumDtype)
        scaJ = _sca_j(cfg, params)
        srcNum = srcRowsA = lineTerms = None
        if scheme == SCHEME_FUSED:
            I, Psi, IeffBase, moments, srcRowsA = fused_stage(
                cfg, params, scaJ, packed)
        else:
            chiTot, srcNum = gather(cfg, params, scaJ)
            I, Psi, IeffBase, moments = formal_solve(cfg, params, chiTot,
                                                     srcNum)
        if scheme == SCHEME_PALLAS:
            lineTerms = line_kernel_stage(cfg, params, I, Psi, IeffBase,
                                          srcNum, packed)
        Jnew = moments['J']
        dJ = torch.max(torch.abs(1.0 - torch.where(
            Jnew != 0.0, Jdag / Jnew, torch.ones_like(Jnew))))
        Gamma, Rij, Rji = gamma_rates(cfg, params, I, Psi, IeffBase, srcNum,
                                      moments, lineTerms, srcRowsA)
        out = {'Gamma': Gamma, 'Rij': Rij, 'Rji': Rji, 'J': Jnew,
               'I': I[1, :, :, 0], 'dJ': dJ}
        if cfg.hprd:
            out['JRest'] = rest_frame_J(cfg, params, cfg.wavelengthT, I)
        return out

    iteration.pack = pack
    iteration.gather = lambda params, scaJ: gather(
        cfg, _working_params(cfg, params), scaJ)
    iteration.formal_solve = lambda params, chiTot, srcNum: formal_solve(
        cfg, _working_params(cfg, params), chiTot, srcNum)
    iteration.sweep_inputs = lambda params, chiTot, srcNum: sweep_inputs(
        cfg, _working_params(cfg, params), chiTot, srcNum)
    iteration.scaJ = lambda params: _sca_j(cfg, _working_params(cfg, params))
    iteration.fused_stage = lambda params, scaJ, packed: fused_stage(
        cfg, _working_params(cfg, params), scaJ, packed)
    iteration.line_kernel_stage = lambda params, *rays: line_kernel_stage(
        cfg, _working_params(cfg, params), *rays)
    iteration.line_inputs = lambda params, *rays: line_inputs(
        cfg, _working_params(cfg, params), *rays)
    iteration.fused_inputs = lambda params, scaJ, packed: fused_inputs(
        cfg, _working_params(cfg, params), scaJ, packed)[0]
    iteration.gamma_rates = lambda params, *rays: gamma_rates(
        cfg, _working_params(cfg, params), *rays)
    return iteration


def rest_frame_J(cfg: IterConfig, params, lam, I):
    """Hybrid PRD's rest-frame mean intensity JRest [Nprd, Nk] on the
    PRD-active rows cfg.prdIdxs: each ray's spectrum I [2, NL, Nmu, Nk] on
    the wavelengths lam [NL], Doppler-shifted by its vlos mu, resampled
    linearly at the rest wavelengths, then the mu moment -- the adjoint-
    tent accumulation of the reference expressed as resampling (ref:
    Source/Prd.cpp:816-897, SimdFullIterationTemplates.hpp:397-408)."""
    lamPrd = cfg.wavelengthT[torch.as_tensor(cfg.prdIdxs, device=cfg.device)]
    sgn = cfg.tensor([-1.0, 1.0])
    fac = 1.0 + (sgn[:, None, None] * params['vlosMu'][None]
                 / Const.CLight)                         # [2, Nmu, Nk]
    IRest = interp(lamPrd, lam * fac[..., None],
                   I.permute(0, 2, 3, 1))                # [2, Nmu, Nk, Nprd]
    return torch.sum(IRest * (0.5 * cfg.wmuT)[None, :, None, None],
                     dim=(0, 1)).T


def build_prd_subset_fn(cfg: IterConfig, subIdxs: np.ndarray,
                        prdLines: List[tuple]):
    """Formal solution restricted to the PRD-active wavelength subset.

    The reference's ``FsMode::UpdateJ | UpdateRates | PrdOnly``
    (ref: Source/PrdTemplates.hpp:19-113), as lightweaver_tpu's
    build_prd_subset_fn: solve I only at the ``subIdxs`` rows of the
    global grid, update J (and JRest under hybrid PRD) there, and
    accumulate Rij/Rji for the PRD lines alone; Gamma and all other
    transitions' rates are untouched.  The sweep is ops/sweep.py's, the
    CUDA kernel on a CUDA device, over the Nsub rows.

    ``subIdxs`` is a sorted index array; each PRD line's window must be
    contained in it.  ``prdLines`` is a list of (ai, ti) into
    cfg.activeAtoms.  Returns prd_subset_stage(params) -> {'J' [Nsub, Nk],
    'I' [Nsub, Nmu] (up sweep at k = 0), 'dJ', 'Rij', 'Rji' (per PRD
    line, [Nk])}, plus 'JRest' [Nprd, Nk] under cfg.hprd.
    """
    subIdxs = np.asarray(subIdxs, np.int64)
    Nsub = len(subIdxs)
    Nmu, Nk = cfg.Nmu, cfg.Nk
    subT = torch.as_tensor(subIdxs, device=cfg.device)
    lamSub = cfg.wavelengthT[subT]

    # per transition that meets the subset: the subset positions [p0, p1)
    # inside its window, the global rows [lo, hi) they span, and the
    # window rows relative to lo (a slice where they are contiguous)
    spans = []
    for ai, a in enumerate(cfg.allAtoms):
        for ti, t in enumerate(a.trans):
            p0, p1 = np.searchsorted(subIdxs, [t.Nblue, t.Nred])
            if p1 <= p0:
                continue
            lo, hi = int(subIdxs[p0]), int(subIdxs[p1 - 1]) + 1
            rows = (slice(None) if hi - lo == p1 - p0 else torch.as_tensor(
                subIdxs[p0:p1] - lo, device=cfg.device))
            spans.append((ai, ti, int(p0), int(p1), lo, hi, rows))

    lineStarts = []
    for (ai, ti) in prdLines:
        t = cfg.activeAtoms[ai].trans[ti]
        s0 = int(np.searchsorted(subIdxs, t.Nblue))
        if not np.array_equal(subIdxs[s0:s0 + t.W],
                              np.arange(t.Nblue, t.Nred)):
            raise ValueError('PRD line window not contained in subset')
        lineStarts.append(s0)

    def sweep_inputs(params):
        """The arguments of formal_solve_sweep on the subset rows."""
        shape = (2, Nsub, Nmu, Nk)
        chiSub = params['bgChi'][subT][None, :, None, :].expand(shape).clone()
        etaSub = params['bgEta'][subT][None, :, None, :].expand(shape).clone()
        for ai, ti, p0, p1, lo, hi, rows in spans:
            c, e = chi_eta_w(cfg, params, ai, ti, lo, hi)
            chiSub[:, p0:p1] += c[:, rows]
            etaSub[:, p0:p1] += e[:, rows]

        srcSub = etaSub + _sca_j(cfg, params)[subT][None, :, None, :]
        Iupw_d, Iupw_u = _upwind_intensities(cfg, params, chiSub, lamSub,
                                             rows=subT)
        return (chiSub, srcSub, params['height'], cfg.muzT, Iupw_d, Iupw_u,
                cfg.wmuT)

    def prd_subset_stage(params):
        params = _working_params(cfg, params)
        I, Psi, IeffBase, moments = formal_solve_sweep(*sweep_inputs(params))
        adt = cfg.accumDtype
        Jdag = params['J'][subT].to(adt)
        Jnew = moments['J']
        dJ = torch.max(torch.abs(1.0 - torch.where(
            Jnew != 0.0, Jdag / Jnew, torch.ones_like(Jnew))))

        wmu2w = 0.5 * cfg.wmuT
        wmu2 = wmu2w.to(adt)
        RijOut, RjiOut = [], []
        for (ai, ti), s0 in zip(prdLines, lineStarts):
            t = cfg.activeAtoms[ai].trans[ti]
            I_w = I[:, s0:s0 + t.W]
            Uji, Vij, Vji = _uv(cfg, params, ai, ti, t)
            wlaA = _wla(cfg, params, ai, ti, t).to(adt)
            RijOut.append(_sum_lmd_split(I_w * Vij, wlaA, wmu2, wmu2w, adt))
            RjiOut.append(_sum_lmd_split(Uji + I_w * Vji, wlaA, wmu2, wmu2w,
                                         adt))

        out = {'J': Jnew, 'I': I[1, :, :, 0], 'dJ': dJ, 'Rij': RijOut,
               'Rji': RjiOut}
        if cfg.hprd:
            out['JRest'] = rest_frame_J(cfg, params, lamSub, I)
        return out

    prd_subset_stage.sweep_inputs = lambda params: sweep_inputs(
        _working_params(cfg, params))
    return prd_subset_stage


def _stat_eq_solve(Gamma, n, nTotal):
    """Batched-over-depth statistical equilibrium: replace the row of the
    largest population with particle conservation and solve.
    ref: Source/UpdatePopulations.cpp:7-47"""
    Nl = Gamma.shape[0]
    iElim = torch.argmax(n, dim=0)                              # [Nk]
    rowMask = (torch.arange(Nl, device=n.device)[:, None]
               == iElim[None, :])                               # [Nl, Nk]
    G = torch.where(rowMask[:, None, :], 1.0, Gamma)            # [Nl, Nl, Nk]
    rhs = torch.where(rowMask, nTotal[None, :], 0.0)            # [Nl, Nk]
    return solve_KxK_over_depth(G, rhs)


def phi_direction_major(phi):
    """[W, Nmu, 2, Nk] profile (the JAX package's layout) -> contiguous
    [2, W, Nmu, Nk], the iteration's layout."""
    return torch.movedim(phi, 2, 0).contiguous()


class Context:
    """NLTE radiative transfer context over a single 1D atmosphere.

    Mirrors the user-facing API of lightweaver_tpu.Context on the ported
    slice: construct from (atmos, spect, eqPops), then iterate
    formal_sol_gamma_matrices / stat_equil (and prd_redistribute for PRD
    lines) to convergence (e.g. with iterate_ctx_se(ctx, prd=True)), and
    read I / J / populations / rhoPrd.  All state lives on ``device``, the
    card unless the caller passes device='cpu'; on a CUDA device every
    stage with a kernel launches it.  ``hprd=True`` selects hybrid PRD
    (comoving-frame rho, default scheme only).

    ``dtype`` is the working dtype: float64, or float32 for the f32 state
    (the default under lightweaverrc ``Precision: mixed``), whose J, Gamma
    and rates are in ``accumDtype`` = float64.  ``gammaAccum`` ('exact' or
    'blocked'; default config.params' ``GammaAccum``, else 'exact', as in
    the JAX package) picks the lambda reduction of Gamma/rates under the
    f32 state.
    """

    def __init__(self, atmos: Atmosphere, spect, eqPops,
                 ngOptions=None, initSol=None, conserveCharge: bool = False,
                 hprd: bool = False,
                 formalSolver: str = 'piecewise_bezier3_1d',
                 crswCallback=None,
                 dtype: Optional[torch.dtype] = None,
                 accumDtype: Optional[torch.dtype] = None, device='cuda',
                 gammaMode: str = 'factored',
                 fsIterScheme: Optional[str] = None,
                 gammaAccum: Optional[str] = None):
        from .config import params as cfgParams
        if dtype is None:
            dtype = (torch.float32 if cfgParams.get('Precision') == 'mixed'
                     else DEFAULT_DTYPE)
        if accumDtype is None:
            accumDtype = STATE_DTYPE
        if gammaAccum is None:
            gammaAccum = cfgParams.get('GammaAccum', 'exact')
        unsupported = {
            'a 2D/3D atmosphere': atmos.Ndim != 1,
            'Ng acceleration (ngOptions)': ngOptions is not None,
            'charge conservation': conserveCharge,
            f'formalSolver={formalSolver!r}':
                formalSolver != 'piecewise_bezier3_1d',
            f'gammaMode={gammaMode!r}': gammaMode != 'factored',
            f'dtype={dtype}': dtype not in (torch.float64, torch.float32),
            f'accumDtype={accumDtype}': accumDtype != STATE_DTYPE,
            f'gammaAccum={gammaAccum!r}': gammaAccum not in GAMMA_ACCUM,
            'hybrid PRD with a float32 state':
                hprd and dtype == torch.float32,
            f'initSol={initSol}':
                initSol not in (None, InitialSolution.Lte),
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError('lightweaver_tpu_torch does not support '
                             + ', '.join(bad) + ' yet')
        if atmos.muz is None:
            raise ValueError('Atmosphere angular quadrature not set')
        device = torch.device(device)
        if device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the Context (the default "
                               "device is 'cuda'; pass device='cpu' to run "
                               "on the CPU)")

        self.atmos = atmos
        self.spect = spect
        self.eqPops = eqPops
        self.crswCallback = crswCallback
        self.crswDone = crswCallback is None
        self.dtype = dtype
        self.accumDtype = accumDtype
        self.device = device
        radSet = spect.radSet

        activeAtoms = [self._build_atom_static(m, False)
                       for m in sorted(radSet.activeAtoms,
                                       key=lambda a: a.element)]
        detailedAtoms = [self._build_atom_static(m, True)
                         for m in sorted(radSet.detailedAtoms,
                                         key=lambda a: a.element)]
        self.cfg = IterConfig(
            activeAtoms=activeAtoms, detailedAtoms=detailedAtoms,
            Nlam=spect.Nspect, Nmu=atmos.Nrays, Nk=atmos.Nspace,
            lowerThermalised=isinstance(atmos.lowerBc, ThermalisedRadiation),
            upperThermalised=isinstance(atmos.upperBc, ThermalisedRadiation),
            wavelength=np.asarray(spect.wavelength),
            muz=np.asarray(atmos.muz), wmu=np.asarray(atmos.wmu),
            device=self.device, dtype=dtype, accumDtype=accumDtype,
            gammaAccum=gammaAccum)

        bg = basic_background(spect, atmos, eqPops, radSet)
        self.background = bg

        # the state stays float64 in either precision (_working_params
        # casts what the ray math reads)
        t_ = self.cfg.state
        self.bgChi = t_(bg.chi)
        self.bgEta = t_(bg.eta)
        self.bgSca = t_(bg.sca)
        self.temperature = t_(atmos.temperature)
        self.height = t_(atmos.height)

        self.J = torch.zeros((spect.Nspect, atmos.Nspace), dtype=accumDtype,
                             device=self.device)
        self.I = torch.zeros((spect.Nspect, atmos.Nrays), dtype=dtype,
                             device=self.device)
        self.popsState = []
        for a in activeAtoms:
            st = eqPops.atomicPops[a.model.element]
            self.popsState.append({'n': t_(st.n), 'nStar': t_(st.nStar)})
        self.detailedPops = []
        for a in detailedAtoms:
            st = eqPops.atomicPops[a.model.element]
            self.detailedPops.append({'n': t_(st.n), 'nStar': t_(st.nStar)})

        self.C = [np.zeros((a.Nlevel, a.Nlevel, atmos.Nspace))
                  for a in activeAtoms]
        self.compute_collisions()
        self.compute_profiles()

        # PRD emission-profile ratio rho per (active atom, PRD line);
        # detailed atoms padded with None so all-atom indexing works
        self.rhoPrd = [[t_(np.ones((t.W, atmos.Nspace)))
                        if (t.isLine and t.isPrd) else None
                        for t in a.trans] for a in activeAtoms]
        self.rhoPrd += [[None] * len(a.trans) for a in detailedAtoms]
        self.JRest = None
        if hprd and self._prd_lines():
            self._configure_hprd_coeffs()
        # persistent per-line Ng accelerators on rho.  The reference
        # tracks rho with Ng(0,0,0) (ref: PrdTemplates.hpp:205,263);
        # prdNgOptions opts in to actual extrapolation.
        self.prdNgOptions = None
        self._prdNgs = None
        # 'subset' = the reference's FsMode::PrdOnly (the formal solution
        # of a rho sub-iteration covers the PRD-active wavelengths only);
        # 'full' re-runs the full-grid MALI step instead
        self.prdFsMode = 'subset'
        self._crswVal = 1.0
        self._prd_fs_fn = None
        self._prdSubIdxs = None
        self._rhoHost = {}

        self._iter_fn = build_iteration_fn(self.cfg)
        self._params = None
        self._Gamma = None
        self._Rij = None
        self._Rji = None
        if fsIterScheme is not None:
            self.set_fs_iter_scheme(fsIterScheme)

    @property
    def activeAtoms(self):
        return self.cfg.activeAtoms

    @property
    def detailedAtoms(self):
        return self.cfg.detailedAtoms

    # ------------------------------------------------------------------
    def _build_atom_static(self, model: AtomicModel, detailed: bool) \
            -> AtomStatic:
        spect = self.spect
        trans = []
        for t in model.transitions:
            ident = t.transId
            if ident not in spect.blueIdx:
                continue
            Nblue = spect.blueIdx[ident]
            Nred = spect.redIdx[ident]
            grid = spect.wavelength[Nblue:Nred]
            # a PRD-typed line of a detailed (fixed-population) atom runs
            # with complete redistribution, as in the JAX package
            if isinstance(t, AtomicLine):
                ts = TransStatic(
                    isLine=True, i=t.i, j=t.j, Nblue=Nblue, Nred=Nred,
                    lambda0=t.lambda0, Aji=t.Aji, Bji=t.Bji, Bij=t.Bij,
                    wavelength=np.asarray(grid),
                    wlambda=_wlambda(grid, Const.CLight / t.lambda0),
                    isPrd=(t.type == LineType.PRD and not detailed))
            else:
                ts = TransStatic(
                    isLine=False, i=t.i, j=t.j, Nblue=Nblue, Nred=Nred,
                    lambda0=t.lambda0,
                    wavelength=np.asarray(grid),
                    wlambda=_wlambda(grid, 1.0),
                    alpha=t.alpha(np.asarray(grid)))
            trans.append(ts)
        a = AtomStatic(model=model, Nlevel=len(model.levels), trans=trans,
                       detailed=detailed)
        a.build_overlaps()
        return a

    # ------------------------------------------------------------------
    def compute_profiles(self):
        """Voigt profiles phi [W, Nmu, 2, Nspace] (Voigt evaluated in f64
        on the device, kept in the working dtype) and normalisation wphi
        per line, with each line's damping
        aDamp and elastic collision rate Qelast [Nspace] (numpy; PRD's
        inputs) (ref: Source/FormalScalar.cpp:28-134)."""
        atmos = self.atmos
        t_ = self.cfg.tensor
        vlosMu = t_(atmos.vlos_mu())                    # [Nmu, Nk]
        wmu = self.cfg.wmuT
        s = t_([-1.0, 1.0])
        self.phi = []      # [atom][trans] -> [W, Nmu, 2, Nk] or None
        self.wphi = []     # [atom][trans] -> [Nk] or None
        self.aDamp = []    # [atom][trans] -> [Nk] np or None
        self.Qelast = []   # [atom][trans] -> [Nk] np or None
        for a in self.cfg.allAtoms:
            vBroad = a.model.vBroad(atmos)
            phiA, wphiA, aDampA, QelastA = [], [], [], []
            lineByIdx = {(l.i, l.j): l for l in a.model.lines}
            for t in a.trans:
                if not t.isLine:
                    for lst in (phiA, wphiA, aDampA, QelastA):
                        lst.append(None)
                    continue
                line = lineByIdx[(t.i, t.j)]
                vBase = (t.wavelengthT - t.lambda0) * Const.CLight / t.lambda0

                def voigt_cb(aDamp, vB, _vBase=vBase):
                    # float64 whatever the working dtype, as the JAX
                    # package evaluates it: correctly rounded f32 profiles
                    f64 = self.cfg.state
                    aDamp = f64(aDamp)
                    vB = f64(vB)
                    vk = ((_vBase.double()[:, None, None, None]
                           + (s.double()[None, None, :, None]
                              * vlosMu.double()[None, :, None, :]))
                          / vB[None, None, None, :])
                    return (voigt_H(aDamp[None, None, None, :], vk)
                            / (Const.SqrtPi * vB[None, None, None, :]))

                # LineProfileState protocol: AtomicLine subclasses may
                # override compute_phi for custom profiles
                res = line.compute_phi(LineProfileState(
                    wavelength=np.asarray(t.wavelength),
                    vlosMu=atmos.vlos_mu(), atmos=atmos, eqPops=self.eqPops,
                    default_voigt_callback=voigt_cb,
                    vBroad=np.asarray(vBroad)))
                aDampA.append(np.asarray(res.aDamp))
                QelastA.append(np.asarray(res.Qelast))
                phi = torch.as_tensor(res.phi, dtype=self.dtype,
                                      device=self.device)
                wphi_inv = torch.einsum('lmdk,l,m->k', phi, t.wlambdaT,
                                        0.5 * wmu)
                phiA.append(phi)
                wphiA.append(1.0 / wphi_inv)
            self.phi.append(phiA)
            self.wphi.append(wphiA)
            self.aDamp.append(aDampA)
            self.Qelast.append(QelastA)
        # the params (and the schemes' packed profiles) hold the profiles,
        # the PRD statics the damping
        self._params = None
        self._prdStatics = None

    # ------------------------------------------------------------------
    def compute_collisions(self, force: bool = False):
        """(Re)compute collisional rate matrices.  Cached: they depend only
        on (T, ne, nStar), which do not change during MALI iteration."""
        if not force and getattr(self, '_collisionsClean', False):
            return
        for a, C in zip(self.cfg.activeAtoms, self.C):
            C.fill(0.0)
            for col in a.model.collisions:
                col.compute_rates(self.atmos, self.eqPops, C)
            np.clip(C, 0.0, None, out=C)
        self._collisionsClean = True
        self._CDev = None

    def _deviceC(self):
        if self._CDev is None:
            self._CDev = [self.cfg.state(C) for C in self.C]
        return self._CDev

    def _bc_data(self, bc):
        """A user-callable boundary condition as I_incident[Nlam, Nmu],
        or None for analytic BC types.
        ref: Source/LwMiddleLayer.pyx:765-829"""
        data = bc.compute_bc(self.atmos, self.spect)
        if data is None:
            return None
        data = np.asarray(data, np.float64)
        if data.ndim == 3:          # [Nlam, Nmu, Nspatial=1]
            data = data[..., 0]
        return self.cfg.tensor(data)

    # ------------------------------------------------------------------
    def build_params(self, crswVal: float = 1.0) -> Dict:
        params = {
            'J': self.J,
            'bgChi': self.bgChi, 'bgEta': self.bgEta, 'bgSca': self.bgSca,
            'temperature': self.temperature, 'height': self.height,
            'pops': [st['n'] for st in self.popsState],
            'nStar': [st['nStar'] for st in self.popsState],
            'detPops': [st['n'] for st in self.detailedPops],
            'detNStar': [st['nStar'] for st in self.detailedPops],
            'C': self._deviceC(),
            'crsw': float(crswVal),
            'phi': [[None if p is None else phi_direction_major(p)
                     for p in pa] for pa in self.phi],
            'wphi': self.wphi,
            'rhoPrd': self.rhoPrd,
            'upperBcData': self._bc_data(self.atmos.upperBc),
            'lowerBcData': self._bc_data(self.atmos.lowerBc),
            'vlosMu': (self.cfg.tensor(self.cfg.vlosMu) if self.cfg.hprd
                       else None),
            'hprdI0': self._hprd_coeff_params(0),
            'hprdFrac': self._hprd_coeff_params(1),
        }
        params['pack'] = self._iter_fn.pack(params)
        return params

    def _hprd_coeff_params(self, which: int):
        """Nested [atom][trans] list of the hybrid-PRD interpolation
        coefficients in the direction-major layout [2, W, Nmu, Nk]
        (0 = the i0 indices, int64; 1 = the fractions), None-padded like
        phi; None without hybrid PRD."""
        if not self.cfg.hprd:
            return None
        out = []
        for ai, a in enumerate(self.cfg.allAtoms):
            row = []
            for ti in range(len(a.trans)):
                c = self.cfg.hprdCoeffs.get((ai, ti))
                if c is None:
                    row.append(None)
                    continue
                x = np.moveaxis(c[which], 2, 0)
                row.append(torch.as_tensor(
                    np.ascontiguousarray(x, np.int64) if which == 0
                    else np.ascontiguousarray(x),
                    dtype=torch.int64 if which == 0 else self.dtype,
                    device=self.device))
            out.append(row)
        return out

    # ------------------------------------------------------------------
    def set_fs_iter_scheme(self, name: str):
        """Select the iteration scheme (the reference's per-SIMD plugin
        registry, LwMiddleLayer.pyx:3077-3098; the JAX package's names):
        'mali_full_precond' (the stages in torch ops around the sweep
        kernel), 'mali_full_precond_fused' (the fused lambda-step kernel,
        ops/fused.py) or 'mali_full_precond_pallas' (the line Gamma
        kernel, ops/gamma.py).  The reference's per-SIMD suffixes
        (_scalar/_SSE2/_AVX*) alias the base name.  A configuration that
        the scheme's kernel does not cover raises ValueError."""
        base = name.partition('_scalar')[0].partition('_SSE2')[0] \
                   .partition('_AVX')[0]
        supported = {
            SCHEME_DEFAULT: (lambda cfg: True, ''),
            SCHEME_FUSED: (fusedOps.fused_scheme_supported,
                           'needs float64 or float32 and no hybrid PRD'),
            SCHEME_PALLAS: (gammaOps.gamma_scheme_supported,
                            'needs float64 or float32, no hybrid PRD and '
                            'same-atom '
                            f'line groups of at most {gammaOps.KMAX} '
                            'overlapping lines')}
        if base not in supported:
            raise ValueError(f'Unknown iteration scheme {name!r}; '
                             "available: 'mali_full_precond', "
                             "'mali_full_precond_fused', "
                             "'mali_full_precond_pallas'")
        check, needs = supported[base]
        if not check(self.cfg):
            raise ValueError(f'{base} does not support this configuration '
                             f'({needs})')
        self.cfg = dataclasses.replace(self.cfg, fsIterScheme=base)
        self._iter_fn = build_iteration_fn(self.cfg)
        self._params = None
        self._prd_fs_fn = None

    def get_fs_iter_scheme_properties(self, fsIterScheme=None) -> dict:
        """Properties of the selected iteration scheme, with the
        reference's key layout (ref: LwMiddleLayer.pyx:4186-4194)."""
        return {'name': self.cfg.fsIterScheme,
                'Ndim': self.atmos.Ndim,
                'dimensionSpecific': False,
                'respectsFormalSolver': True,
                'defaultPerAtomStorage': True,
                'defaultWlaGijStorage': True}

    # ------------------------------------------------------------------
    def formal_sol_gamma_matrices(self) -> IterationUpdate:
        """One full MALI step: formal solution over all wavelengths with
        Gamma-matrix and rate accumulation.
        ref: Source/LwMiddleLayer.pyx:3152"""
        crswVal = self.crswCallback() if self.crswCallback is not None else 1.0
        self.crswDone = crswVal == 1.0
        self.compute_collisions()
        if self._params is None:
            self._params = self.build_params(crswVal)
        p = self._params
        p['J'] = self.J
        p['pops'] = [st['n'] for st in self.popsState]
        p['C'] = self._deviceC()
        p['crsw'] = float(crswVal)
        p['rhoPrd'] = self.rhoPrd
        # a callable BC may change between steps (the PRD subset solve
        # reads these rows from self._params too)
        p['upperBcData'] = self._bc_data(self.atmos.upperBc)
        p['lowerBcData'] = self._bc_data(self.atmos.lowerBc)
        out = self._iter_fn(p)
        self._crswVal = crswVal
        self._Gamma = out['Gamma']
        self._Rij = out['Rij']
        self._Rji = out['Rji']
        self.J = out['J']
        self.I = out['I']
        if 'JRest' in out:
            self.JRest = out['JRest']
        return IterationUpdate(self, updatedJ=True, dJMax=out['dJ'],
                               crsw=crswVal)

    # ------------------------------------------------------------------
    def stat_equil(self) -> IterationUpdate:
        """Statistical equilibrium solve for each active atom.

        The max relative population change and the finite flags are
        formed on the device and fetched in ONE device-to-host copy.
        dPops follows Ng.max_change: 0.0 until two post-solve solutions
        exist, then max |(cur - old)/cur| over cur != 0.
        ref: Source/LwMiddleLayer.pyx:3461-3560"""
        if self._Gamma is None:
            raise ValueError('Call formal_sol_gamma_matrices first')
        flags = []
        for ai, a in enumerate(self.cfg.activeAtoms):
            st = self.popsState[ai]
            nTotal = self.cfg.state(
                self.eqPops.atomicPops[a.model.element].nTotal)
            nNew = _stat_eq_solve(self._Gamma[ai], st['n'], nTotal)
            nOld = st.get('nLastSE')
            if nOld is None:
                dp = torch.zeros((), dtype=torch.float64, device=self.device)
            else:
                mask = nNew != 0.0
                dp = torch.max(torch.where(
                    mask, torch.abs((nNew - nOld)
                                    / torch.where(mask, nNew, 1.0)), 0.0))
            flags.append(dp.to(torch.float64))
            flags.append(torch.all(torch.isfinite(nNew)).to(torch.float64))
            st['n'] = nNew
            st['nLastSE'] = nNew
        vals = torch.stack(flags).cpu().numpy()
        dPops = []
        for ai in range(len(self.popsState)):
            if vals[2 * ai + 1] == 0.0:
                name = self.cfg.activeAtoms[ai].model.element.name
                raise ExplodingMatrixError(
                    f'Non-finite populations for atom {name} after '
                    'the statistical-equilibrium solve (singular '
                    'Gamma matrix)')
            dPops.append(float(vals[2 * ai]))
        return IterationUpdate(self, updatedPops=True, dPops=dPops)

    # ------------------------------------------------------------------
    def _configure_hprd_coeffs(self):
        """Precompute the hybrid-PRD machinery: the PRD-active wavelength
        subset and, per PRD line, the (i0, frac) linear-interpolation
        coefficients locating each window wavelength's Doppler-shifted
        (comoving) position per (mu, +/-, depth), [W, Nmu, 2, Nk] as the
        JAX package computes them (_hprd_coeff_params moves them to the
        port's direction-major layout).
        ref: Source/Prd.cpp:697-945"""
        cfg = self.cfg
        cfg.hprd = True
        vlosMu = np.asarray(self.atmos.vlos_mu())       # [Nmu, Nk]
        cfg.vlosMu = vlosMu

        prdActive = np.zeros(cfg.Nlam, bool)
        for ai, ti, a, t in self._prd_lines():
            prdActive[t.Nblue:t.Nred] = True
        cfg.prdIdxs = np.nonzero(prdActive)[0]
        laToPrd = np.full(cfg.Nlam, -1, np.int64)
        laToPrd[cfg.prdIdxs] = np.arange(len(cfg.prdIdxs))
        cfg.laToPrdLa = laToPrd

        sgn = np.array([-1.0, 1.0])
        fac = 1.0 + (sgn[None, :, None] * vlosMu[:, None, :]
                     / Const.CLight)                    # [Nmu, 2, Nk]
        cfg.hprdCoeffs = {}
        for ai, ti, a, t in self._prd_lines():
            w = t.wavelength                            # [W]
            lamRest = w[:, None, None, None] * fac[None]   # [W, Nmu, 2, Nk]
            i0 = np.searchsorted(w, lamRest, side='right') - 1
            i0 = np.clip(i0, 0, t.W - 2)
            frac = (lamRest - w[i0]) / (w[i0 + 1] - w[i0])
            frac = np.clip(frac, 0.0, 1.0)
            cfg.hprdCoeffs[(ai, ti)] = (i0.astype(np.int32),
                                        frac.astype(np.float64))

    # ------------------------------------------------------------------
    def _prd_lines(self):
        return [(ai, ti, a, t)
                for ai, a in enumerate(self.cfg.activeAtoms)
                for ti, t in enumerate(a.trans) if t.isLine and t.isPrd]

    def _prd_subset_idxs(self) -> np.ndarray:
        """Static PRD-active wavelength subset for redistribution
        sub-iterations: the union of the PRD lines' windows, widened
        (for hPRD) to every wavelength whose Doppler-shifted neighbour
        range scatters into the PRD region
        (ref: Source/Prd.cpp:740-811)."""
        cfg = self.cfg
        prdActive = np.zeros(cfg.Nlam, bool)
        for ai, ti, a, t in self._prd_lines():
            prdActive[t.Nblue:t.Nred] = True
        if cfg.hprd and cfg.vlosMu is not None:
            w = np.asarray(cfg.wavelength, np.float64)
            facs = (1.0 + np.array([-1.0, 1.0])[None, :, None]
                    * np.asarray(cfg.vlosMu)[:, None, :]
                    / Const.CLight).ravel()               # [Nmu*2*Nk]
            prevLam = w[np.maximum(np.arange(cfg.Nlam) - 1, 0)]
            nextLam = w[np.minimum(np.arange(cfg.Nlam) + 1, cfg.Nlam - 1)]
            lo = prevLam[:, None] * facs[None, :]         # [Nlam, M]
            hi = nextLam[:, None] * facs[None, :]
            # the reference's scan (Prd.cpp:766-793) is inclusive one
            # grid point on EACH side: the rollback lands on the largest
            # w <= prevLambda and checks it, and the forward loop checks
            # prdActive BEFORE the lambdaI > nextLambda break -- both
            # points enter the criterion.  This puts the first grid
            # point outside each PRD window into the hPRD subset, which
            # matters: those scattering-dominated edge wavelengths then
            # get the same number of scattering relaxations per
            # redistribution as the reference gives them.
            iLo = np.maximum(np.searchsorted(w, lo, side='right') - 1, 0)
            iHi = np.minimum(np.searchsorted(w, hi, side='right') + 1,
                             cfg.Nlam)
            cum = np.concatenate([[0], np.cumsum(prdActive)])
            scatters = (cum[iHi] - cum[iLo]) > 0
            prdActive |= scatters.any(axis=1)
        return np.nonzero(prdActive)[0]

    def _prd_subset_fs(self):
        """Subset formal solution for PRD sub-iterations: refresh J (and
        JRest) and the PRD lines' radiative rates at the PRD-active
        wavelengths only, leaving Gamma and every other rate untouched
        (ref: FsMode::PrdOnly, PrdTemplates.hpp:19-113).  Returns dJ on
        the subset (0-d tensor)."""
        if self._prd_fs_fn is None:
            prdLines = [(ai, ti) for ai, ti, a, t in self._prd_lines()]
            self._prdSubIdxs = self._prd_subset_idxs()
            self._prdSubIdxsT = torch.as_tensor(self._prdSubIdxs,
                                                device=self.device)
            self._prd_fs_fn = build_prd_subset_fn(
                self.cfg, self._prdSubIdxs, prdLines)
        p = self._params
        p['J'] = self.J
        p['pops'] = [st['n'] for st in self.popsState]
        p['rhoPrd'] = self.rhoPrd
        out = self._prd_fs_fn(p)
        sub = self._prdSubIdxsT
        self.J = self.J.index_copy(0, sub, out['J'])
        self.I = self.I.index_copy(0, sub, out['I'])
        for li, (ai, ti, a, t) in enumerate(self._prd_lines()):
            self._Rij[ai][ti] = out['Rij'][li]
            self._Rji[ai][ti] = out['Rji'][li]
        if 'JRest' in out:
            self.JRest = out['JRest']
        return out['dJ']

    def _prd_line_statics(self):
        """Per PRD line the device-side constants of its scattering
        integral: qWave [W, Nk] (emission frequency in Doppler units),
        aDamp [Nk], Qelast [Nk], and under hybrid PRD the first row of its
        window in JRest."""
        if self._prdStatics is None:
            t_ = self.cfg.state
            self._prdStatics = []
            for ai, ti, a, t in self._prd_lines():
                vBroad = a.model.vBroad(self.atmos)
                qWave = ((t.wavelength[:, None] - t.lambda0) * Const.CLight
                         / (t.lambda0 * vBroad[None, :]))
                prd0 = (int(self.cfg.laToPrdLa[t.Nblue]) if self.cfg.hprd
                        else None)
                self._prdStatics.append(
                    (t_(qWave), t_(self.aDamp[ai][ti]),
                     t_(self.Qelast[ai][ti]), prd0))
        return self._prdStatics

    def _rho_on_host(self, ai, ti):
        """rho of line (ai, ti) as a flat numpy array, for Ng: the copy
        kept when prd_redistribute last set it, else one device pull."""
        rho = self.rhoPrd[ai][ti]
        kept = self._rhoHost.get((ai, ti))
        if kept is not None and kept[0] is rho:
            return kept[1]
        return rho.cpu().numpy().ravel()

    def _scatter_rho(self, li: int) -> torch.Tensor:
        """The new rho [W, Nk] of PRD line ``li`` of _prd_lines() from the
        current J (JRest under hybrid PRD), rates and populations, formed
        on the device (ref: Source/Prd.cpp:9-30, 468-645)."""
        ai, ti, a, t = self._prd_lines()[li]
        qWave, aDamp, Qelast, prd0 = self._prd_line_statics()[li]
        # Pj + Qj: total upper-level depopulation + elastic rate
        PjQj = Qelast + self._deviceC()[ai][:, t.j, :].sum(dim=0)
        for t2i, t2 in enumerate(a.trans):
            if t2.j == t.j:
                PjQj = PjQj + self._Rji[ai][t2i]
            if t2.i == t.j:
                PjQj = PjQj + self._Rij[ai][t2i]

        n = self.popsState[ai]['n']
        gammaPre = n[t.i] / n[t.j] * t.Bij / PjQj
        Jbar = self._Rij[ai][ti] / t.Bij
        if self.cfg.hprd and self.JRest is not None:
            Jw = self.JRest[prd0:prd0 + t.W]
        else:
            Jw = self.J[t.Nblue:t.Nred]
        return prd_scatter_rho(qWave, aDamp, Jw, gammaPre, Jbar)

    def prd_redistribute(self, maxIter: int = 3,
                         tol: float = 1e-2) -> IterationUpdate:
        """Iterate the PRD emission-profile ratios rho: per line compute
        the angle-averaged scattering integral against the current J and
        rates, then refresh J/rates with a formal solution, until
        drho < tol or maxIter.

        PjQj, gammaPre, Jbar and rho are formed on the device; the one
        host pull per line and sub-iteration is the flattened rho that
        the numpy Ng tracks (the reference's Ng semantics).
        ref: Source/PrdTemplates.hpp:176-351, Source/Prd.cpp:9-30, 468-645"""
        prdLines = self._prd_lines()
        if not prdLines:
            return IterationUpdate(self)
        if self._Rij is None:
            raise ValueError('Call formal_sol_gamma_matrices first')

        if self.prdNgOptions is None:
            # reference behaviour: fresh tracking-only Ng per call
            ngs = [Ng(0, 0, 0, self._rho_on_host(ai, ti))
                   for ai, ti, a, t in prdLines]
        else:
            # opt-in: persistent per-line accelerators whose history
            # spans sub-iterations AND outer MALI iterations
            o = self.prdNgOptions
            if (self._prdNgs is None or len(self._prdNgs) != len(prdLines)
                    or any(ng.init and ng.len != self.rhoPrd[ai][ti].numel()
                           for ng, (ai, ti, a, t)
                           in zip(self._prdNgs, prdLines))):
                self._prdNgs = [
                    Ng(o.Norder, o.Nperiod, o.Ndelay,
                       self._rho_on_host(ai, ti))
                    for ai, ti, a, t in prdLines]
            ngs = self._prdNgs

        dRho = [0.0] * len(prdLines)
        nIter = 0
        for it in range(maxIter):
            nIter += 1
            dRhoMax = 0.0
            for li, (ai, ti, a, t) in enumerate(prdLines):
                rho = self._scatter_rho(li)
                rhoHost = rho.cpu().numpy().ravel()
                accelerated, rhoFlat = ngs[li].accelerate(rhoHost,
                                                          trustFactor=2.0)
                dRho[li] = ngs[li].max_change()
                dRhoMax = max(dRhoMax, dRho[li])
                if accelerated:
                    rhoHost = rhoFlat
                    rho = self.cfg.state(rhoFlat.reshape(rho.shape))
                self.rhoPrd[ai][ti] = rho
                self._rhoHost[(ai, ti)] = (rho, rhoHost)

            # refresh J and the PRD lines' rates with the new rho on the
            # PRD-active wavelength subset only (ref FsMode::PrdOnly), or
            # with the full-grid MALI step under prdFsMode == 'full'
            if self.prdFsMode == 'subset' and self._params is not None:
                self._prd_subset_fs()
            else:
                # freeze the CRSW schedule across sub-iterations
                cur = self._crswVal
                cb = self.crswCallback
                self.crswCallback = (lambda: cur) if cb is not None else None
                try:
                    self.formal_sol_gamma_matrices()
                finally:
                    self.crswCallback = cb
            if dRhoMax < tol:
                break

        upd = IterationUpdate(self, updatedRho=True, dRho=dRho,
                              NprdSubIter=nIter)
        upd.updatedJ = True
        return upd
