"""The Context: device state + the MALI iteration, in PyTorch.

Port of the 1D path of lightweaver_tpu/context.py: the three 1D formal
solvers (formalSolver, set_formal_solver: piecewise linear, cubic Bezier,
BESSER), factored Gamma; complete redistribution, angle-averaged PRD and
hybrid PRD (prd_redistribute); the population-update options around
stat_equil: Ng acceleration of the populations (ngOptions),
Newton-Raphson charge conservation (conserveCharge, nr_post_update),
backward-Euler time-dependent updates (time_dep_update, with update_deps
after the atmosphere changes) and the escape-probability start (initSol);
the whole MALI loop on the device (iterate_on_device, with Ng and the PRD
sub-iterations: DeviceLoop); and spectrum synthesis from a converged
state: the Lambda step formal_sol,
state_dict / pickling / construct_from_state_dict_with, compute_rays, and
full-Stokes Zeeman synthesis (compute_polarised_profiles,
single_stokes_fs, ops/stokes.py).  2D (x, z) atmospheres take the same
iteration with the plane sweep of ops/formal_solver2d.py as stage 2
(formal_solve_2d) and ops/stokes2d.py for the Stokes synthesis.  The
Context options of the JAX package on one device are all taken: dense
Gamma (gammaMode='dense', the non-factored branch of gamma_rates), every
initSol, a backgroundProvider in place of basic_background, the
recurrenceMode names (each runs the port's sweep) and the full-resolution
depthData capture.  Over ranks (one process each, torch.distributed):
Context(mesh=) on a 2D atmosphere block-shards x (parallel/xshard2d.py:
each rank iterates its block of columns, the plane sweep exchanging
halos and closing the ring across the ranks) with every option of the
unsharded Context, and a wavelength group (IterConfig.lamLo/lamHi/
lamGroup, parallel/columns.py's 'wavelength' axis) runs the MALI step and
the PRD subset solve on a block of rows with one all_reduce of Gamma,
the rates and JRest (build_iteration_fn, build_prd_subset_fn).  What the
JAX package refuses (a 3D atmosphere, mesh= on 1D, on-device PRD on 2D)
raises ValueError rather than running something else.

Precision, as in the JAX package: a float64 state, or a float32 working
dtype (the f32 state, lightweaverrc ``Precision: mixed``) with the
accumulation dtype accumDtype = float64 by default.  In the f32 state the
ray tensors and the kernels run in float32; the Context's own state
(populations, background, thermodynamics, rho, collisional rates) stays
float64 and _working_params casts what the ray math reads; J, Gamma and
the rates are in accumDtype (the sweep and fused kernels sum J in float64
and the result is cast, the line Gamma kernel's float block partials are
summed in accumDtype, and the lambda contractions of gamma_rates run
through _sum_lmd_split or, with gammaAccum='blocked', _sum_lam_blocked).
accumDtype=float32 keeps J, Gamma and the rates in float32, as the JAX
Context does when it is given it.

All ray tensors are direction-major [2, Nlam, Nmu, Nk] (d = 0 the down
sweep, d = 1 the up sweep), the layout the depth-sweep kernel takes; on a
2D atmosphere k = z Nx + x.  The iteration is split into three stage
functions with one interface each:

    gather(cfg, params, scaJ)                  -> chiTot, srcNum
    formal_solve(cfg, params, chiTot, srcNum)  -> I, Psi, IeffBase, moments
    gamma_rates(cfg, params, I, Psi, IeffBase, srcNum, moments)
                                               -> Gamma, Rij, Rji

The formal solve goes through ops/sweep.py, which launches the CUDA kernel
on a CUDA device (on a 2D atmosphere the plane sweep, torch ops as the
JAX package leaves it to XLA: one loop over the planes per direction for
every wavelength and ray of the direction); the other stages are plain
torch ops on the chosen device, as the JAX package leaves them to XLA.
PRD lines carry their emission-profile ratio rho (params['rhoPrd']) into
every stage through _uv; between MALI steps prd_redistribute refreshes
rho (ops/prd.py) and re-solves the PRD-active wavelengths
(build_prd_subset_fn, again through ops/sweep.py; on a 2D atmosphere the
full-grid MALI step).

Two iteration schemes (Context.set_fs_iter_scheme) put a further kernel
behind a stage:

    'mali_full_precond_pallas': line_kernel_stage runs ops/gamma.py per
        same-atom line group; gamma_rates takes the lines from it.
    'mali_full_precond_fused': fused_stage runs ops/fused.py in place of
        gather and formal_solve (chiTot and srcNum are never formed).

Both take rho from the params of each call; neither covers hybrid PRD,
dense Gamma or a 2D atmosphere.
"""
import copy
import dataclasses
from dataclasses import dataclass, field
from functools import partial
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import constants as Const
from .atmosphere import Atmosphere, PeriodicRadiation, ThermalisedRadiation
from .atomic_model import (AtomicLine, AtomicModel, LineProfileState,
                           LineType)
from .atomic_set import lte_pops
from .atomic_table import PeriodicTable
from .background import basic_background
from .escape import set_pops_escape_probability
from .iteration_update import IterationUpdate
from .nr_update import build_nr_fn
from .ops import formal_solver2d as fs2d
from .ops import fused as fusedOps
from .ops import gamma as gammaOps
from .ops.faddeeva import voigt_H, voigt_HF
from .ops.formal_solver import SOLVER_NAMES_1D
from .ops.linalg import solve_KxK_over_depth
from .ops.ng import (Ng, NgOptions, device_ng_accelerate,
                     device_ng_init)
from .ops.planck import planck_nu
from .ops.prd import _DX_EPS, prd_scatter_rho
from .ops.stokes import delo_bezier_stokes
from .ops.stokes2d import sweep_stokes_rays_2d
from .ops.sweep import BEZIER3, angular_moments, formal_solve_sweep
from .utils import ExplodingMatrixError, InitialSolution

DEFAULT_DTYPE = torch.float64
# the dtype of the Context's state and of J, Gamma and the rates in both
# precisions (the JAX package's accumDtype for the f32 state)
STATE_DTYPE = torch.float64
GAMMA_ACCUM = ('exact', 'blocked')
GAMMA_MODES = ('factored', 'dense')
# the JAX package's depth-recurrence names (lightweaver_tpu/ops/
# formal_solver.py:_affine_solve): each runs the port's sweep
RECURRENCE_MODES = ('scan', 'parallel', 'blocked', 'pallas')

# the 2D formal solvers and upwind interpolations (ref:
# Source/FormalInterface.cpp:35-42; the JAX package's names)
SOLVER_NAMES_2D = ('piecewise_linear_2d', 'piecewise_besser_2d')
INTERP_NAMES_2D = ('interp_linear_2d', 'interp_besser_2d')

SCHEME_DEFAULT = 'mali_full_precond'
SCHEME_PALLAS = 'mali_full_precond_pallas'
SCHEME_FUSED = 'mali_full_precond_fused'
# what each scheme's kernel needs of the configuration (_check_scheme)
SCHEME_NEEDS = {
    SCHEME_DEFAULT: '',
    SCHEME_FUSED: ("needs 1D, factored Gamma, no hPRD, "
                   "formalSolver='piecewise_bezier3_1d': the Bezier-3 "
                   "kernel over float64 or float32 rays, without hybrid "
                   "PRD"),
    SCHEME_PALLAS: ('needs 1D, factored Gamma, float64 or float32, no '
                    'hybrid PRD and same-atom line groups of at most {KMAX} '
                    'overlapping lines'),
}


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
    polarisable: bool = False           # a line with Zeeman components
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
    # 'factored' contracts the continua against the sweep's angular
    # moments; 'dense' integrates every transition over the full ray
    # tensors (gamma_rates)
    gammaMode: str = 'factored'
    # the JAX Context's recurrenceMode, kept for state_dict: every name
    # runs the port's sweep (ops/sweep.py)
    recurrenceMode: str = 'scan'
    fsIterScheme: str = SCHEME_DEFAULT
    # the formal solver: one of SOLVER_NAMES_1D (ops/formal_solver.py, the
    # sweep kernel's instances), or of SOLVER_NAMES_2D on a 2D atmosphere
    formalSolver: str = BEZIER3
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
    # the local operator acceleration of the coherent background
    # scattering (_accelerate_scattering)
    accelerateScattering: bool = False
    # independent columns laid end to end along depth: Nk = Ncol NkCol,
    # column c the depths [c NkCol, (c + 1) NkCol), each with its own
    # height, boundaries and emergent point (parallel/columns.py's batch;
    # every pointwise stage runs over all Nk depths unchanged)
    Ncol: int = 1
    # 2D (x, z) atmospheres (Ndim == 2): the grid, each ray's x cosine,
    # whether x is periodic (else both x boundaries are callable), the
    # geometry per (mu, toObs) (ops/formal_solver2d.py:build_geometry_2d)
    # and the upwind interpolation (INTERP_NAMES_2D); formalSolver is then
    # one of SOLVER_NAMES_2D.  __post_init__ puts each direction's ray
    # group on the device (rays2d[d], ops/formal_solver2d.py:ray_group).
    Ndim: int = 1
    Nz: Optional[int] = None
    Nx: Optional[int] = None
    zGrid: Optional[np.ndarray] = None
    mux: Optional[np.ndarray] = None
    xPeriodic: bool = True
    geom2d: Optional[Dict] = None
    interpFn2d: str = 'interp_linear_2d'
    # the wavelength axis of a mesh (parallel/columns.py): this rank's
    # rows [lamLo, lamHi) of the grid and the process group over which
    # build_iteration_fn reduces Gamma, the rates and dJ (None: the whole
    # grid on this rank)
    lamLo: int = 0
    lamHi: Optional[int] = None
    lamGroup: Optional[object] = None
    # the x axis of a 2D atmosphere block-sharded over ranks (Context(mesh=),
    # parallel/xshard2d.py:XShard): Nx and Nk are then this rank's block;
    # __post_init__ puts each direction's ray group in the block's frame
    # (rays2dX[d], parallel/xshard2d.py:shard_ray_group)
    xShard: Optional[object] = None

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
        self.rays2d = None
        if self.Ndim == 2:
            # a vertical ray has no x coupling and is never fixed to the x
            # boundary (ref: FormalScalar2d.cpp:505-546)
            periodic = [self.xPeriodic or m == 0.0 for m in self.mux]
            self.rays2d = [
                fs2d.ray_group([self.geom2d[(mu, toObs)]
                                for mu in range(self.Nmu)], periodic,
                               self.device, self.dtype)
                for toObs in (False, True)]
        self.rays2dX = None
        if self.xShard is not None:
            from .parallel.xshard2d import shard_ray_group
            self.rays2dX = [shard_ray_group(g, self.xShard)
                            for g in self.rays2d]

    def tensor(self, x):
        """A copy of x in the working dtype on the device."""
        return torch.tensor(np.asarray(x), dtype=self.dtype,
                            device=self.device)

    def state(self, x):
        """A copy of x in the state dtype (float64) on the device: never a
        view of the host array, on the CPU either (the populations, nStar
        and ne arrays of eqPops and the atmosphere change in place)."""
        return torch.tensor(np.asarray(x), dtype=STATE_DTYPE,
                            device=self.device)

    @property
    def allAtoms(self):
        return self.activeAtoms + self.detailedAtoms

    @property
    def NkCol(self):
        """The depths of one column."""
        return self.Nk // self.Ncol


def _heights(cfg: IterConfig, params):
    """The height of the sweeps: [Nk], or [Ncol, NkCol] per column."""
    h = params['height']
    return h if cfg.Ncol == 1 else h.view(cfg.Ncol, cfg.NkCol)


def _emergent(cfg: IterConfig, I):
    """The emergent intensity, the up sweep at the top of each column:
    I [2, NL, Nmu, Nk] -> [NL, Nmu], or [Ncol, NL, Nmu] per column, or on
    a 2D atmosphere the top plane [NL, Nmu, Nx]."""
    if cfg.Ndim == 2:
        return I[1, :, :, :cfg.Nx]
    if cfg.Ncol == 1:
        return I[1, :, :, 0]
    return I[1, :, :, ::cfg.NkCol].permute(2, 0, 1)


def _dJ(cfg: IterConfig, Jdag, Jnew):
    """max |1 - Jdag/Jnew| over J's rows and depths (Jnew != 0): a 0-d
    tensor, or [Ncol] per column."""
    rel = torch.abs(1.0 - torch.where(Jnew != 0.0, Jdag / Jnew,
                                      torch.ones_like(Jnew)))
    if cfg.Ncol == 1:
        return torch.max(rel)
    return torch.amax(rel.view(rel.shape[0], cfg.Ncol, cfg.NkCol),
                      dim=(0, 2))


def _accelerate_scattering(Jnew, Jdag, PsiBar, sca, adt):
    """Local (diagonal) operator acceleration of the coherent background-
    scattering Lambda iteration (lightweaver_tpu/context.py:353-370): the
    formal solution's J_fs = Lambda[(eta + sca Jdag)/chi] depends on the
    lagged Jdag pointwise through c = sca PsiBar (PsiBar = sum_mu wmu/2
    Psi, the sweep's moment), so J = (J_fs - c Jdag) / (1 - c) solves the
    scalar fixed point J = J_fs + c (J - Jdag), with c clipped to
    [0, 1 - 1e-3].  Same fixed point; the scattering-dominated rows
    converge in a few steps instead of O(1/(1 - c))."""
    c = sca.to(adt) * PsiBar.to(adt)
    c = torch.clamp(c, 0.0, 1.0 - 1e-3)
    return (Jnew - c * Jdag) / (1.0 - c)


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
    populations, background, thermodynamics, profiles, rho and hybrid
    PRD's vlos mu and interpolation fractions are cast (no copy in
    float64); J stays in accumDtype, C in float64."""
    def cast(x):
        return None if x is None else x.to(cfg.dtype)
    params = dict(params)
    params['allPops'] = [cast(n) for n in
                         list(params['pops']) + list(params['detPops'])]
    params['allNStar'] = [cast(n) for n in
                          list(params['nStar']) + list(params['detNStar'])]
    for key in ('bgChi', 'bgEta', 'bgSca', 'temperature', 'height',
                'upperBcData', 'lowerBcData', 'xLowerBcData',
                'xUpperBcData', 'vlosMu'):
        params[key] = cast(params.get(key))
    for key in ('phi', 'wphi', 'rhoPrd', 'hprdFrac'):
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
    return (chiTot, srcNum, _heights(cfg, params), cfg.muzT, Iupw_d, Iupw_u,
            cfg.wmuT)


def formal_solve(cfg: IterConfig, params, chiTot, srcNum):
    """Boundary intensities, then the depth sweep of every ray with its
    angular moments (ops/sweep.py: the CUDA kernel on a CUDA device); on a
    2D atmosphere formal_solve_2d.  Returns (I, Psi, IeffBase, moments)."""
    if cfg.Ndim == 2:
        return formal_solve_2d(cfg, params, chiTot, srcNum)
    return formal_solve_sweep(*sweep_inputs(cfg, params, chiTot, srcNum),
                              solver=cfg.formalSolver)


def _schemes_2d(cfg: IterConfig):
    """(interp, alongRay) of ops/formal_solver2d.py for cfg's names: the
    upwind interpolation from interpFn2d, the along-ray integration from
    the 2D solver (ref: Source/FormalInterface.cpp:35-42)."""
    return ('besser' if cfg.interpFn2d == 'interp_besser_2d' else 'linear',
            'besser' if cfg.formalSolver == 'piecewise_besser_2d'
            else 'linear')


def _x_inflow(cfg: IterConfig, params, d: int):
    """The fixed x column's intensity [Nlam, Nmu, Nz] of direction d for
    every ray: a ray stepping towards +x (mux of its direction >= 0) enters
    through the lower x boundary, the others through the upper one (ref:
    FormalScalar2d.cpp:496-546); from the x BC data [Nlam, Nmu, 2, Nz]."""
    lower, upper = params.get('xLowerBcData'), params.get('xUpperBcData')
    if lower is None or upper is None:
        raise ValueError('a non-periodic 2D atmosphere needs callable x '
                         'boundaries whose compute_bc returns [Nlam, Nmu, '
                         '2, Nz] data')
    sgn = 1.0 if d == 1 else -1.0
    fromLower = torch.as_tensor(sgn * cfg.mux >= 0, device=cfg.device)
    return torch.where(fromLower[None, :, None], lower[:, :, d],
                       upper[:, :, d])


def formal_solve_2d(cfg: IterConfig, params, chiTot, srcNum):
    """Stage 2 on a 2D atmosphere: per direction, the start plane (the
    thermalised z boundary from each ray's downwind intersection,
    ops/formal_solver2d.py:thermalised_start_2d, or zero), the fixed x
    column's inflow of the non-periodic rays (also on the start plane),
    then ONE plane sweep of every wavelength and ray of the direction
    (sweep_rays_2d) written into the [2, Nlam, Nmu, Nk] layout (k = z Nx +
    x); then the angular moments (ops/sweep.py:angular_moments).  The JAX
    package's formal_solve_2d (lightweaver_tpu/context.py:791-882), which
    loops over (mu, direction).  With cfg.xShard (Context(mesh=)) the
    tensors hold this rank's block of x columns and both the start plane
    and the sweep are parallel/xshard2d.py's, their halos exchanged
    across the ranks.  Returns (I, Psi, IeffBase, moments)."""
    NL, Nmu, Nz, Nx = chiTot.shape[1], cfg.Nmu, cfg.Nz, cfg.Nx
    shape = (NL, Nmu, Nz, Nx)
    I, Psi, IeffBase = (torch.empty_like(chiTot) for _ in range(3))
    T2 = params['temperature'].view(Nz, Nx)
    interp, alongRay = _schemes_2d(cfg)
    xs = cfg.xShard
    start, sweep = fs2d.thermalised_start_2d, fs2d.sweep_rays_2d
    if xs is not None:
        from .parallel import xshard2d
        start = partial(xshard2d.thermalised_start_xsharded, shard=xs)
        sweep = partial(xshard2d.sweep_rays_2d_xsharded, shard=xs)
    for d in range(2):
        group = cfg.rays2d[d] if xs is None else cfg.rays2dX[d]
        chi = chiTot[d].view(shape)
        thermalised = cfg.lowerThermalised if d == 1 else cfg.upperThermalised
        i0, i1 = (Nz - 1, Nz - 2) if d == 1 else (0, 1)
        if thermalised:
            Iupw = start(chi[:, :, i0], chi[:, :, i1], T2[i0], T2[i1],
                         cfg.wavelengthT, group)
        else:
            Iupw = chiTot.new_zeros((NL, Nmu, Nx))
        Ibc = None
        if group['anyFixed']:
            # the boundary column keeps its x-BC value on the start plane
            # too (the reference pre-fills the whole column before the
            # z-BC plane loop, which skips it)
            Ibc = _x_inflow(cfg, params, d)
            Iupw = torch.where(group['fixedNat'], Ibc[:, :, i0, None], Iupw)
        sweep(chi, group, Iupw, srcNum=srcNum[d].view(shape), Ibc=Ibc,
              interp=interp, alongRay=alongRay,
              out=(I[d].view(shape), Psi[d].view(shape),
                   IeffBase[d].view(shape)))
    return I, Psi, IeffBase, angular_moments(I, Psi, IeffBase, srcNum,
                                             cfg.wmuT)


def _upwind_intensities(cfg: IterConfig, params, chiTot, lam, rows=None):
    """Boundary intensities [NL, Nmu] of the down (upper BC) and up (lower
    BC) sweeps over the rows of chiTot [2, NL, Nmu, Nk], whose wavelengths
    are lam [NL] and, when ``rows`` is given, global grid rows ``rows``;
    [NL, Nmu, Ncol] at each column's ends over columns."""
    if cfg.Ncol > 1:
        return _upwind_columns(cfg, params, chiTot, lam, rows)
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


def _upwind_columns(cfg: IterConfig, params, chiTot, lam, rows=None):
    """_upwind_intensities over Ncol columns: each column's boundary
    values [NL, Nmu, Ncol] from its own two outermost depths; a boundary's
    data rows [NL, Nmu] (a callable BC) go to every column."""
    C, Nc = cfg.Ncol, cfg.NkCol
    T = params['temperature'].view(C, Nc)
    h = params['height'].view(C, Nc)
    chi = chiTot.unflatten(-1, (C, Nc))         # [2, NL, Nmu, C, Nc]
    shape = (*chiTot.shape[1:3], C)
    lamC = lam[:, None]

    def data(key):
        x = params[key] if rows is None else params[key][rows]
        return x if x.dim() == 3 else x[..., None].expand(shape)

    def therm(d, k0, k1):
        B0 = planck_nu(T[None, :, k0], lamC)[:, None, :]   # [NL, 1, C]
        B1 = planck_nu(T[None, :, k1], lamC)[:, None, :]
        dtau = (0.5 * (chi[d, :, :, :, k0] + chi[d, :, :, :, k1])
                * torch.abs(h[:, k0] - h[:, k1]) / cfg.muzT[None, :, None])
        return B0 - (B1 - B0) / dtau

    out = []
    for d, key, thermalised, k0, k1 in (
            (0, 'upperBcData', cfg.upperThermalised, 0, 1),
            (1, 'lowerBcData', cfg.lowerThermalised, Nc - 1, Nc - 2)):
        if params.get(key) is not None:
            out.append(data(key))
        elif thermalised:
            out.append(therm(d, k0, k1))
        else:
            out.append(torch.zeros(shape, dtype=cfg.dtype,
                                   device=cfg.device))
    return tuple(out)


# ---- scheme 'mali_full_precond_fused': stages 1 and 2 in one kernel ----
def _boundary(cfg, params, key, thermalised, k0, k1):
    """One end's boundary for ops/fused.py: caller data, the Planck rows at
    depths (k0, k1) of a thermalised end, or zero.  Over columns k0, k1
    index each column's depths: the data rows go to every column
    ([Nlam, Nmu, Ncol]) and the Planck rows are [Nlam, Ncol, 2]."""
    C = cfg.Ncol
    if params.get(key) is not None:
        x = params[key]
        if C > 1 and x.dim() == 2:
            x = x[..., None].expand(*x.shape, C)
        return 'data', x.contiguous()
    if thermalised:
        T, lam = params['temperature'], cfg.wavelengthT
        if C == 1:
            return 'therm', torch.stack([planck_nu(T[k0], lam),
                                         planck_nu(T[k1], lam)], dim=1)
        T = T.view(C, cfg.NkCol)
        return 'therm', torch.stack([planck_nu(T[None, :, k0], lam[:, None]),
                                     planck_nu(T[None, :, k1], lam[:, None])],
                                    dim=2)
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

    Nc = cfg.NkCol
    upper = _boundary(cfg, params, 'upperBcData', cfg.upperThermalised, 0, 1)
    lower = _boundary(cfg, params, 'lowerBcData', cfg.lowerThermalised,
                      Nc - 1, Nc - 2)
    args = (pack['phiP'], chiCo, etaCo, params['bgChi'] + contChi,
            params['bgEta'] + contEta, scaJ, _heights(cfg, params), cfg.muzT,
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
            # a wavelength block (wavelength_block) leaves the lines
            # outside its rows without any
            members = [ti for ti in members if a.trans[ti].W > 0]
            if not members:
                continue
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
    if not groups:
        return None
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
    Dense (cfg.gammaMode == 'dense', the default scheme only) integrates
    the continua as the lines, over the full ray tensors, with the
    compensated Ieff = IeffBase + Psi (srcNum - etaAtom) assembled from
    non-cancelling terms in the working dtype before any cast (the JAX
    package's non-factored branch, lightweaver_tpu/context.py:1299-1310).

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
    factored = cfg.gammaMode == 'factored'
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
        for ti, t in enumerate(a.trans if factored else ()):
            sl = slice(t.Nblue, t.Nred)
            if t.isLine and lt is not None and ti in lt['line']:
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
            if t.isLine and lt is not None and ti in lt['line']:
                # the kernel's lambda-block partials, summed here in adt
                G4 = lt['line'][ti]['G4'].to(adt)
                Gamma[t.i, t.j] += torch.sum(G4[0], dim=0)
                Gamma[t.j, t.i] += torch.sum(G4[1], dim=0)
                Rij.append(torch.sum(G4[2], dim=0))
                Rji.append(torch.sum(G4[3], dim=0))
                continue
            Uji, Vij, Vji = _uv(cfg, params, ai, ti, t)
            wlaA = _wla(cfg, params, ai, ti, t).to(adt)  # [W, Nk]

            if factored and not t.isLine:
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

            # compensated MALI effective intensity on the window (a
            # line's, or under dense Gamma any transition's): I -
            # Psi*etaAtom assembled from non-cancelling terms
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


# ---- the wavelength axis of a mesh ---------------------------------------
def lambda_block(Nlam: int, index: int, size: int) -> Tuple[int, int]:
    """Rank ``index``'s contiguous block [lo, hi) of ``size`` blocks of
    the Nlam rows of the grid."""
    return index * Nlam // size, (index + 1) * Nlam // size


def _window_rows(t: TransStatic, lo: int, hi: int) -> Tuple[int, int]:
    """(first, count): the rows of transition t's window that lie in the
    grid rows [lo, hi), as an offset into the window ((0, 0) for none)."""
    a = min(max(lo - t.Nblue, 0), t.W)
    b = min(max(hi - t.Nblue, 0), t.W)
    return (a, b - a) if b > a else (0, 0)


def wavelength_block(cfg: IterConfig) -> IterConfig:
    """cfg on the rows [lamLo, lamHi) alone, with no wavelength group: the
    grid cut to the block and every transition's window clipped to it and
    counted from its first row (zero rows for a transition outside it;
    the clipped windows keep their global integration weights)."""
    lo, hi = cfg.lamLo, cfg.lamHi

    def clip(t: TransStatic):
        a, n = _window_rows(t, lo, hi)
        rows = slice(a, a + n)
        nb = t.Nblue + a - lo if n else 0
        return dataclasses.replace(
            t, Nblue=nb, Nred=nb + n, wavelength=t.wavelength[rows],
            wlambda=t.wlambda[rows],
            alpha=None if t.alpha is None else t.alpha[rows])

    def atoms(lst):
        return [dataclasses.replace(a, trans=[clip(t) for t in a.trans])
                for a in lst]

    return dataclasses.replace(
        cfg, activeAtoms=atoms(cfg.activeAtoms),
        detailedAtoms=atoms(cfg.detailedAtoms), Nlam=hi - lo,
        wavelength=cfg.wavelength[lo:hi], lamLo=0, lamHi=None, lamGroup=None)


def _block_params(cfg: IterConfig, params):
    """params of the full grid cut to the rows [lamLo, lamHi): J (unless
    it holds the block already), the background, the z boundaries' data
    rows and each transition's window of phi and rho; under hybrid PRD
    rho stays whole (the comoving-frame interpolation of _uv reads it
    across the window, by whole-window indices) and the window rows of
    its coefficients hprdI0/hprdFrac are cut instead."""
    lo, hi = cfg.lamLo, cfg.lamHi
    p = dict(params)
    if p['J'].shape[0] == cfg.Nlam:
        p['J'] = p['J'][lo:hi]
    for key in ('bgChi', 'bgEta', 'bgSca', 'upperBcData', 'lowerBcData'):
        if p.get(key) is not None:
            p[key] = p[key][lo:hi]
    windows = ((('phi', 1), ('hprdI0', 1), ('hprdFrac', 1)) if cfg.hprd
               else (('phi', 1), ('rhoPrd', 0)))
    for key, dim in windows:
        if p.get(key) is None:
            continue
        p[key] = [[None if x is None else
                   x.narrow(dim, *_window_rows(t, lo, hi))
                   for x, t in zip(row, a.trans)]
                  for row, a in zip(p[key], cfg.allAtoms)]
    return p


def _sum_over_group(group, parts):
    """Every tensor of ``parts`` (a list) summed over the ranks of
    ``group`` in ONE all_reduce of their concatenation; returns the list
    of sums in their shapes."""
    from .ops.collectives import all_reduce
    flat = all_reduce(torch.cat([x.reshape(-1) for x in parts]), group)
    return [y.view(x.shape) for x, y in zip(
        parts, torch.split(flat, [x.numel() for x in parts]))]


def _wavelength_block_fn(cfg: IterConfig):
    """build_iteration_fn on a rank of a wavelength group: the MALI step of
    wavelength_block(cfg) over its rows, then ONE all_reduce(SUM) of every
    Gamma and rate of every active atom (and under hybrid PRD of JRest)
    over cfg.lamGroup (their lambda sums are over the block alone; the
    collisional term enters on the rank of the first block only; JRest is
    the block rows' share of each rest-frame interpolation, rest_frame_J
    with lo = lamLo) and an all_reduce(MAX) of dJ.  J and the emergent I
    stay the block's rows."""
    from .ops.collectives import all_reduce
    bcfg = wavelength_block(cfg)
    inner = build_iteration_fn(
        bcfg, restFrame=lambda params, I: rest_frame_J(
            cfg, params, cfg.wavelengthT, I, cfg.lamLo))
    group = cfg.lamGroup

    def pack(params):
        return inner.pack(_block_params(cfg, params))

    def iteration(params, lambdaIterate=False, storeDepthData=False):
        bp = _block_params(cfg, params)
        if cfg.lamLo > 0:
            bp['C'] = [c.new_zeros(()).expand_as(c) for c in bp['C']]
        out = inner(bp, lambdaIterate=lambdaIterate,
                    storeDepthData=storeDepthData)
        nA = len(out['Gamma'])
        sums = iter(_sum_over_group(group, list(out['Gamma'])
                                    + [r for rs in out['Rij'] for r in rs]
                                    + [r for rs in out['Rji'] for r in rs]
                                    + ([out['JRest']] if 'JRest' in out
                                       else [])))
        out['Gamma'] = [next(sums) for _ in range(nA)]
        out['Rij'] = [[next(sums) for _ in rs] for rs in out['Rij']]
        out['Rji'] = [[next(sums) for _ in rs] for rs in out['Rji']]
        if 'JRest' in out:
            out['JRest'] = next(sums)
        out['dJ'] = all_reduce(out['dJ'], group, 'max')
        return out

    iteration.pack = pack
    iteration.blockCfg = bcfg
    return iteration


def build_iteration_fn(cfg: IterConfig, restFrame=None):
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
    'dJ' (0-d tensor)}, and under cfg.hprd 'JRest' [Nprd, Nk]; with
    storeDepthData=True also 'depthChi', 'depthEta' and 'depthI', chi, eta
    and I at full resolution in the JAX package's layout [Nlam, Nmu, 2,
    Nk] (depth_data); over
    cfg.Ncol > 1 columns 'I' is [Ncol, Nlam, Nmu] and 'dJ' [Ncol].  With
    cfg.accelerateScattering, J is the accelerated one
    (_accelerate_scattering) and dJ measures it.  ``restFrame(params, I)``
    forms JRest in place of rest_frame_J over cfg's grid (a wavelength
    block's share: _wavelength_block_fn).  The stages are exposed as
    attributes.

    With cfg.lamGroup (a rank of a mesh's wavelength axis) the step is
    _wavelength_block_fn's: the same stages on the rows [lamLo, lamHi) and
    one all_reduce of Gamma and the rates across the group.

    cfg.fsIterScheme selects the stages: 'mali_full_precond' runs gather,
    formal_solve and gamma_rates; 'mali_full_precond_pallas' adds the line
    kernel stage before gamma_rates; 'mali_full_precond_fused' replaces
    gather and formal_solve with fused_stage.  With lambdaIterate=True
    the step runs without the approximate operator (lambda_operator),
    the JAX package's lambdaIterate.
    """
    if cfg.lamGroup is not None:
        return _wavelength_block_fn(cfg)
    scheme = cfg.fsIterScheme

    def pack(params):
        if scheme == SCHEME_PALLAS:
            return line_pack(cfg, params)
        if scheme == SCHEME_FUSED:
            return fused_pack(cfg, params)
        return None

    def iteration(params, lambdaIterate=False, storeDepthData=False):
        packed = params.get('pack')
        if packed is None:
            packed = pack(params)
        params = _working_params(cfg, params)
        Jdag = params['J'].to(cfg.accumDtype)
        scaJ = _sca_j(cfg, params)
        chiTot = srcNum = srcRowsA = lineTerms = None
        if scheme == SCHEME_FUSED:
            I, Psi, IeffBase, moments, srcRowsA = fused_stage(
                cfg, params, scaJ, packed)
        else:
            chiTot, srcNum = gather(cfg, params, scaJ)
            I, Psi, IeffBase, moments = formal_solve(cfg, params, chiTot,
                                                     srcNum)
        if lambdaIterate:
            I, Psi, IeffBase, moments = lambda_operator(I, Psi, moments)
        if scheme == SCHEME_PALLAS and packed is not None:
            lineTerms = line_kernel_stage(cfg, params, I, Psi, IeffBase,
                                          srcNum, packed)
        # the kernels sum J in float64; accumDtype=float32 keeps it so
        Jnew = moments['J'].to(cfg.accumDtype)
        if cfg.accelerateScattering:
            # c from the sweep's (or fused kernel's) PsiBar moment, zero
            # under lambdaIterate (lambda_operator), as in the JAX package
            Jnew = _accelerate_scattering(Jnew, Jdag, moments['PsiBar'],
                                          params['bgSca'], cfg.accumDtype)
        dJ = _dJ(cfg, Jdag, Jnew)
        Gamma, Rij, Rji = gamma_rates(cfg, params, I, Psi, IeffBase, srcNum,
                                      moments, lineTerms, srcRowsA)
        out = {'Gamma': Gamma, 'Rij': Rij, 'Rji': Rji, 'J': Jnew,
               'I': _emergent(cfg, I), 'dJ': dJ}
        if cfg.hprd:
            out['JRest'] = (restFrame(params, I) if restFrame is not None
                            else rest_frame_J(cfg, params, cfg.wavelengthT,
                                              I))
        if storeDepthData:
            out.update(depth_data(cfg, params, scaJ, chiTot, srcNum, I))
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


def lambda_operator(I, Psi, moments):
    """The rays and moments of a Lambda iteration step (formal_sol): Psi
    = 0 and IeffBase = I, so on the moments path PsiBar = 0 and
    IeffSrcBar = IBar, under every scheme; the line Gamma kernel reads
    them so too (lightweaver_tpu/context.py:992-996, 1034-1036,
    1121-1129)."""
    moments = dict(moments, PsiBar=torch.zeros_like(moments['PsiBar']),
                   IeffSrcBar=moments['IBar'])
    return I, torch.zeros_like(Psi), I, moments


def depth_data(cfg: IterConfig, params, scaJ, chiTot, srcNum, I):
    """The full-resolution capture of a MALI step (Context.depthData;
    ref: Source/LwContext.hpp:12-18): 'depthChi', 'depthEta' and 'depthI'
    [Nlam, Nmu, 2, Nk] in the working dtype, on the device.  The sweep
    path recovers eta from srcNum = eta + sca J, as the JAX package's
    sweep-kernel path does (lightweaver_tpu/context.py:1537-1544); the
    fused scheme never forms chi or eta, so they are rebuilt by gather
    (with a zero scattering term), in this call only."""
    if chiTot is None:
        chiTot, eta = gather(cfg, params, torch.zeros_like(scaJ))
    else:
        eta = srcNum - scaJ[None, :, None, :]

    def layout(x):
        return torch.movedim(x, 0, 2)
    return {'depthChi': layout(chiTot), 'depthEta': layout(eta),
            'depthI': layout(I)}


def rest_frame_J(cfg: IterConfig, params, lam, I, lo: int = 0):
    """Hybrid PRD's rest-frame mean intensity JRest [Nprd, Nk] on the
    PRD-active rows cfg.prdIdxs: each ray's spectrum on the wavelengths
    lam [n], Doppler-shifted by its vlos mu, resampled linearly at the
    rest wavelengths (ops/prd.py:interp's formula, rows and clamps), then
    the mu moment -- the adjoint-tent accumulation of the reference
    expressed as resampling (ref: Source/Prd.cpp:816-897,
    SimdFullIterationTemplates.hpp:397-408).  I [2, NL, Nmu, Nk] holds
    the rays of the rows [lo, lo + NL) of lam (all of them by default; NL
    may be 0).  The resampling is linear in I, so the result is those
    rows' share of JRest: on the ranks of a wavelength group one
    all_reduce of the shares completes it (_wavelength_block_fn,
    build_prd_subset_fn).  The shift, the resampling and the products
    with the weights run in the working dtype; the mu sum in the wider of
    the working dtype and accumDtype (in the f32 state JRest is summed
    from float32 products into float64, where the JAX float32 Context
    sums in float32)."""
    rows, sgn = _hprd_rows(cfg)
    acc = torch.promote_types(cfg.dtype, cfg.accumDtype)
    NL = I.shape[1]
    if NL == 0:
        return torch.zeros((len(rows), I.shape[-1]), dtype=acc,
                           device=I.device)
    fac = 1.0 + (sgn[:, None, None] * params['vlosMu'][None]
                 / Const.CLight)                         # [2, Nmu, Nk]
    xp = (lam * fac[..., None]).contiguous()             # [2, Nmu, Nk, n]
    x = cfg.wavelengthT[rows].expand(*xp.shape[:-1], -1).contiguous()
    n = xp.shape[-1]
    i = torch.searchsorted(xp, x, right=True).clamp(1, n - 1)
    xl = xp.gather(-1, i - 1)
    dx = xp.gather(-1, i) - xl
    dx0 = torch.abs(dx) <= _DX_EPS
    left, right = x < xp[..., :1], x > xp[..., -1:]
    # I at a PRD row, ray and depth is fl + t (fr - fl) of the rows il
    # and i: t = 0 outside the shifted grid and where its step is ~0
    t = torch.where(dx0 | left | right, 0.0,
                    (x - xl) / torch.where(dx0, 1.0, dx))
    il = torch.where(right, n - 1, torch.where(left, 0, i - 1))
    Ip = I.permute(0, 2, 3, 1)                           # [2, Nmu, Nk, NL]

    def take(idx):
        # rows outside [lo, lo + NL) are another rank's share
        loc = idx - lo
        inside = (loc >= 0) & (loc < NL)
        return torch.where(inside, Ip.gather(-1, loc.clamp(0, NL - 1)), 0.0)
    fl = take(il)
    # one fused multiply-add, as interp (and XLA) forms it
    IRest = torch.addcmul(fl, t, take(i) - fl)           # [2, Nmu, Nk, Nprd]
    return torch.sum((IRest * (0.5 * cfg.wmuT)[None, :, None, None])
                     .to(acc), dim=(0, 1)).T


def _hprd_rows(cfg: IterConfig):
    """cfg.prdIdxs on the device and the (down, up) signs of the Doppler
    shift, made at the first call for each prdIdxs array and kept on cfg,
    so that a MALI step copies nothing from the host after its first."""
    kept = cfg.__dict__.get('_hprdRows')
    if kept is None or kept[0] is not cfg.prdIdxs:
        kept = (cfg.prdIdxs, torch.as_tensor(cfg.prdIdxs, device=cfg.device),
                cfg.tensor([-1.0, 1.0]))
        cfg._hprdRows = kept
    return kept[1], kept[2]


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
    line, [Nk])}, plus 'JRest' [Nprd, Nk] under cfg.hprd; over cfg.Ncol >
    1 columns each column has its own boundaries, 'I' is [Ncol, Nsub,
    Nmu] and 'dJ' [Ncol].  cfg.accelerateScattering accelerates J as the
    MALI step does, with the subset's PsiBar.

    On a rank of a wavelength group (cfg.lamGroup; params['J'] then holds
    the rows [lamLo, lamHi)) the stage solves the subset rows of its block
    alone (Nsub of them, maybe none: no sweep is launched then) and
    returns J, I and dJ there; each PRD line's rates sum the rows of its
    window in the block, and JRest the block's share of each rest-frame
    interpolation over the subset (rest_frame_J from its first row), and ONE
    all_reduce(SUM) over the group completes both on every rank.
    """
    subIdxs = np.asarray(subIdxs, np.int64)
    Nmu, Nk = cfg.Nmu, cfg.Nk
    group = cfg.lamGroup
    lo, hi = (cfg.lamLo, cfg.lamHi) if group is not None else (0, cfg.Nlam)
    for (ai, ti) in prdLines:
        t = cfg.activeAtoms[ai].trans[ti]
        s0 = int(np.searchsorted(subIdxs, t.Nblue))
        if not np.array_equal(subIdxs[s0:s0 + t.W],
                              np.arange(t.Nblue, t.Nred)):
            raise ValueError('PRD line window not contained in subset')
    # this rank's rows of the subset; their first position in the subset
    rows = subIdxs[(subIdxs >= lo) & (subIdxs < hi)]
    pos0 = int(np.searchsorted(subIdxs, lo))
    Nsub = len(rows)
    subT = torch.as_tensor(rows, device=cfg.device)
    # J's rows of the subset rows (J holds the block on a wavelength rank)
    jRows = torch.as_tensor(rows - (lo if group is not None else 0),
                            device=cfg.device)
    lamSub = cfg.wavelengthT[subT]
    lamSubAll = cfg.wavelengthT[torch.as_tensor(subIdxs, device=cfg.device)]

    # per transition that meets the rows: the positions [p0, p1) among
    # them inside its window, the global rows [a, b) they span, and the
    # window rows relative to a (a slice where they are contiguous)
    spans = []
    for ai, a in enumerate(cfg.allAtoms):
        for ti, t in enumerate(a.trans):
            p0, p1 = np.searchsorted(rows, [t.Nblue, t.Nred])
            if p1 <= p0:
                continue
            r0, r1 = int(rows[p0]), int(rows[p1 - 1]) + 1
            sel = (slice(None) if r1 - r0 == p1 - p0 else torch.as_tensor(
                rows[p0:p1] - r0, device=cfg.device))
            spans.append((ai, ti, int(p0), int(p1), r0, r1, sel))

    # per PRD line the rows [a, b) of its window among this rank's, from
    # position s0 of them (b == a: none)
    lineRows = []
    for (ai, ti) in prdLines:
        t = cfg.activeAtoms[ai].trans[ti]
        a, b = max(t.Nblue, lo), min(t.Nred, hi)
        b = max(a, b)
        lineRows.append((int(np.searchsorted(rows, a)), a, b))

    def sweep_inputs(params):
        """The arguments of formal_solve_sweep on the subset rows."""
        shape = (2, Nsub, Nmu, Nk)
        chiSub = params['bgChi'][subT][None, :, None, :].expand(shape).clone()
        etaSub = params['bgEta'][subT][None, :, None, :].expand(shape).clone()
        for ai, ti, p0, p1, r0, r1, sel in spans:
            c, e = chi_eta_w(cfg, params, ai, ti, r0, r1)
            chiSub[:, p0:p1] += c[:, sel]
            etaSub[:, p0:p1] += e[:, sel]

        scaJ = params['bgSca'][subT] * params['J'][jRows].to(cfg.dtype)
        srcSub = etaSub + scaJ[None, :, None, :]
        Iupw_d, Iupw_u = _upwind_intensities(cfg, params, chiSub, lamSub,
                                             rows=subT)
        return (chiSub, srcSub, _heights(cfg, params), cfg.muzT, Iupw_d,
                Iupw_u, cfg.wmuT)

    def prd_subset_stage(params):
        params = _working_params(cfg, params)
        adt = cfg.accumDtype
        Jdag = params['J'][jRows].to(adt)
        if Nsub:
            I, Psi, IeffBase, moments = formal_solve_sweep(
                *sweep_inputs(params), solver=cfg.formalSolver)
            Jnew = moments['J'].to(adt)
            if cfg.accelerateScattering:
                Jnew = _accelerate_scattering(Jnew, Jdag, moments['PsiBar'],
                                              params['bgSca'][subT], adt)
        else:
            I = params['bgChi'].new_zeros((2, 0, Nmu, Nk))
            Jnew = Jdag
        dJ = (_dJ(cfg, Jdag, Jnew) if Nsub else
              Jdag.new_zeros(() if cfg.Ncol == 1 else (cfg.Ncol,)))

        wmu2w = 0.5 * cfg.wmuT
        wmu2 = wmu2w.to(adt)
        RijOut, RjiOut = [], []
        for (ai, ti), (s0, a, b) in zip(prdLines, lineRows):
            t = cfg.activeAtoms[ai].trans[ti]
            if b == a:
                RijOut.append(Jdag.new_zeros(Nk))
                RjiOut.append(Jdag.new_zeros(Nk))
                continue
            I_w = I[:, s0:s0 + b - a]
            Uji, Vij, Vji = _uv(cfg, params, ai, ti, t, a, b)
            wlaA = _wla(cfg, params, ai, ti, t)[a - t.Nblue:b - t.Nblue] \
                .to(adt)
            RijOut.append(_sum_lmd_split(I_w * Vij, wlaA, wmu2, wmu2w, adt))
            RjiOut.append(_sum_lmd_split(Uji + I_w * Vji, wlaA, wmu2, wmu2w,
                                         adt))

        out = {'J': Jnew, 'I': _emergent(cfg, I), 'dJ': dJ}
        JRest = []
        if cfg.hprd:
            JRest = [rest_frame_J(cfg, params, lamSubAll, I, pos0)]
        if group is not None:
            sums = _sum_over_group(group, RijOut + RjiOut + JRest)
            n = len(RijOut)
            RijOut, RjiOut, JRest = sums[:n], sums[n:2 * n], sums[2 * n:]
        out.update(Rij=RijOut, Rji=RjiOut)
        if JRest:
            out['JRest'] = JRest[0]
        return out

    prd_subset_stage.sweep_inputs = lambda params: sweep_inputs(
        _working_params(cfg, params))
    prd_subset_stage.rows = rows
    return prd_subset_stage


def prd_window_J(cfg: IterConfig, t: TransStatic, prd0, J, JRest):
    """The mean intensity [W, Nk] that PRD line t's scattering integral
    reads: its rows of JRest (prd0 its first row there) under hybrid PRD
    once JRest exists, else its window of J."""
    if cfg.hprd and JRest is not None:
        return JRest[prd0:prd0 + t.W]
    return J[t.Nblue:t.Nred]


def scatter_rho(a: AtomStatic, ti: int, statics, C, Rij, Rji, n, Jw):
    """The new rho [W, Nk] of PRD line ti of active atom a from explicit
    tensors: its constants ``statics`` (qWave, aDamp, Qelast, ...:
    Context._prd_line_statics), the atom's collisional matrix C, rates
    Rij/Rji (per transition) and populations n, and Jw (prd_window_J).
    Pj + Qj is the upper level's total depopulation plus the elastic rate
    (ref: Source/Prd.cpp:9-30, 468-645)."""
    t = a.trans[ti]
    qWave, aDamp, Qelast = statics[:3]
    PjQj = Qelast + C[:, t.j, :].sum(dim=0)
    for t2i, t2 in enumerate(a.trans):
        if t2.j == t.j:
            PjQj = PjQj + Rji[t2i]
        if t2.i == t.j:
            PjQj = PjQj + Rij[t2i]
    gammaPre = n[t.i] / n[t.j] * t.Bij / PjQj
    Jbar = Rij[ti] / t.Bij
    return prd_scatter_rho(qWave, aDamp, Jw, gammaPre, Jbar)


def _stat_eq_solve(Gamma, n, nTotal):
    """Batched-over-depth statistical equilibrium: replace the row of the
    largest population with particle conservation and solve.
    ref: Source/UpdatePopulations.cpp:7-47"""
    Gamma = Gamma.to(STATE_DTYPE)   # a float32 accumDtype's Gamma
    Nl = Gamma.shape[0]
    iElim = torch.argmax(n, dim=0)                              # [Nk]
    rowMask = (torch.arange(Nl, device=n.device)[:, None]
               == iElim[None, :])                               # [Nl, Nk]
    G = torch.where(rowMask[:, None, :], 1.0, Gamma)            # [Nl, Nl, Nk]
    rhs = torch.where(rowMask, nTotal[None, :], 0.0)            # [Nl, Nk]
    return solve_KxK_over_depth(G, rhs)


def _time_dep_solve(Gamma, nOld, dt, theta=1.0):
    """Fully-implicit (backward-Euler) time-dependent population update:
    solve (I - theta dt Gamma) n_new = n_old.
    ref: Source/UpdatePopulations.cpp:120-151"""
    Gamma = Gamma.to(STATE_DTYPE)
    Nl = Gamma.shape[0]
    eye = torch.eye(Nl, dtype=Gamma.dtype, device=Gamma.device)[:, :, None]
    M = eye - theta * dt * Gamma
    return solve_KxK_over_depth(M, nOld)


def _check_scheme(scheme: str, cfg: IterConfig):
    """Raise ValueError where ``scheme``'s kernel does not cover ``cfg``."""
    check = {SCHEME_DEFAULT: lambda c: True,
             SCHEME_FUSED: fusedOps.fused_scheme_supported,
             SCHEME_PALLAS: gammaOps.gamma_scheme_supported}[scheme]
    if not check(cfg):
        raise ValueError(f'{scheme} does not support this configuration ('
                         + SCHEME_NEEDS[scheme].format(KMAX=gammaOps.KMAX)
                         + ')')


def profile_weights(phi, wlambda, wmu, Ncol: int = 1):
    """A line's normalisation wphi [Nk] = 1 / sum_{lambda, mu, +/-} phi
    wlambda wmu/2 of its profile phi [W, Nmu, 2, Nk].  Over Ncol columns
    each column's sum is formed on its own depths, in the order a Context
    of that column alone forms it, so that a column of a batch starts
    from its single Context's wphi to the bit."""
    if Ncol == 1:
        return 1.0 / torch.einsum('lmdk,l,m->k', phi, wlambda, 0.5 * wmu)
    Nc = phi.shape[-1] // Ncol
    return torch.cat([profile_weights(phi[..., c * Nc:(c + 1) * Nc]
                                      .contiguous(), wlambda, wmu)
                      for c in range(Ncol)])


def phi_direction_major(phi):
    """[W, Nmu, 2, Nk] profile (the JAX package's layout) -> contiguous
    [2, W, Nmu, Nk], the iteration's layout."""
    return torch.movedim(phi, 2, 0).contiguous()


class DeviceLoop:
    """The prepared state of Context.iterate_on_device for one option set,
    the counterpart of the JAX package's compiled while_loop
    (lightweaver_tpu/context.py:2451-2682).

    Made once and cached on the Context (_odRunnerCache, dropped with the
    cached params): the params of the MALI step, built once (the scheme's
    packed kernel input, the profiles, the boundary rows: a callable BC
    is read here, as the JAX package bakes it), the active atoms' nTotal,
    and with PRD each PRD line's scattering constants and the subset
    solve (build_prd_subset_fn) with its rows.  step() is one MALI
    iteration with its statistical-equilibrium solve, Ng and PRD
    sub-iterations on tensors that stay on the device: it copies nothing
    from the host and reads nothing back.  Where a loop needs a decision
    (more PRD sub-iterations?) it hands a 0-d bool tensor to ``more``,
    read_flag by default, the loops' one read back each, counted in
    ``reads``.  The iteration counter and Ng's count are host ints, so
    the Lambda warm-up and Ng's schedule are decided on the host."""

    def __init__(self, ctx, Nscatter: int, ngOptions, prd: bool,
                 maxPrdSubIter: int, prdTol: float):
        cfg = ctx.cfg
        self.ctx, self.cfg = ctx, cfg
        self.Nscatter = Nscatter
        ng = ngOptions if ngOptions is not None else NgOptions(0, 0, 0)
        self.ng = (ng.Norder, ng.Nperiod, ng.Ndelay)
        self.maxPrdSubIter, self.prdTol = maxPrdSubIter, prdTol
        self.iterFn = ctx._iter_fn
        self.base = ctx.build_params()
        self.nTotals = [cfg.state(ctx._x_local(
            ctx.eqPops.atomicPops[a.model.element].nTotal))
            for a in cfg.activeAtoms]
        self.prdLines = ctx._prd_lines() if prd else []
        if self.prdLines:
            if cfg.Ndim != 1:
                raise ValueError('on-device PRD needs a 1D atmosphere')
            self.subsetFn = ctx._prd_subset_fn()
            self.subT = ctx._prdSubIdxsT
            self.statics = ctx._prd_line_statics()
        if cfg.hprd:
            # rest_frame_J's constants, before the first step
            _hprd_rows(cfg)
        self.zero = torch.zeros((), dtype=STATE_DTYPE, device=ctx.device)
        self.one = torch.ones((), dtype=STATE_DTYPE, device=ctx.device)
        self.reads = 0

    def read_flag(self, flag) -> bool:
        """A 0-d bool tensor as a Python bool: the one read back to the
        host of a loop's stopping test, counted in ``reads``; on an
        x-sharded Context True where it is on any rank of the x group (one
        all_reduce before the read), so that every rank goes on or stops
        together."""
        self.reads += 1
        return bool(self.ctx._x_reduce_tensor(flag.to(STATE_DTYPE)[None],
                                              'max')[0] > 0)

    def start(self) -> Dict:
        """The loop state from the Context's J, populations, rho and
        JRest: Ng's ring buffers hold the populations (device_ng_init),
        dJ = dPops = 1."""
        ctx = self.ctx
        # what a charge-conservation step moves between calls
        self.base['nStar'] = [st['nStar'] for st in ctx.popsState]
        self.base['detNStar'] = [st['nStar'] for st in ctx.detailedPops]
        self.base['C'] = ctx._deviceC()
        JRest = ctx.JRest
        if self.prdLines and self.cfg.hprd and JRest is None:
            JRest = torch.zeros((len(self.cfg.prdIdxs), self.cfg.Nk),
                                dtype=ctx.J.dtype, device=ctx.device)
        return {'it': 0, 'J': ctx.J, 'pops': [st['n'] for st in ctx.popsState],
                'dJ': self.one, 'dPops': self.one,
                'hists': [device_ng_init(ctx.gather_x(st['n']),
                                         self.ng[0])[0]
                          for st in ctx.popsState],
                'cnt': 1, 'rho': ctx.rhoPrd, 'JRest': JRest}

    def step(self, s: Dict, more=None) -> Dict:
        """One MALI iteration from state ``s``: the formal solution with
        Gamma (the scheme's kernels), then, past the Lambda warm-up of
        Nscatter iterations, the statistical-equilibrium solve per atom,
        Ng (device_ng_accelerate) and with PRD the sub-iterations
        (prd_subloop).  dPops is Ng's max change (against the starting
        populations at the first solve), 1 during the warm-up."""
        p = dict(self.base, J=s['J'], pops=s['pops'], rhoPrd=s['rho'])
        out = self.iterFn(p)
        it = s['it']
        s = dict(s, it=it + 1, J=out['J'], dJ=out['dJ'],
                 JRest=out.get('JRest', s['JRest']))
        if it < self.Nscatter:
            # the Lambda warm-up keeps the initial populations
            s['dPops'] = self.one
            return s
        No, Np, Nd = self.ng
        pops, hists, dPops = [], [], self.zero
        for ai, (n, hist) in enumerate(zip(s['pops'], s['hists'])):
            nNew = _stat_eq_solve(out['Gamma'][ai], n, self.nTotals[ai])
            # Ng on the whole grid's populations (an x-sharded Context's
            # gathered; each rank keeps its block)
            hist, _, sol, dMax = device_ng_accelerate(
                hist, s['cnt'], self.ctx.gather_x(nNew).reshape(-1), No, Np,
                Nd)
            pops.append(self.ctx._x_local(sol.view(nNew.shape[0], -1)))
            hists.append(hist)
            dPops = torch.maximum(dPops, dMax)
        s.update(pops=pops, hists=hists, cnt=s['cnt'] + 1, dPops=dPops)
        if self.prdLines:
            s['rho'], s['J'], s['JRest'] = self.prd_subloop(
                s['rho'], s['J'], s['JRest'], out['Rij'], out['Rji'], pops,
                self.read_flag if more is None else more)
        return s

    def prd_subloop(self, rho, J, JRest, Rij, Rji, pops, more):
        """Up to maxPrdSubIter PRD sub-iterations while drho >= prdTol
        (the first always runs), on the step's own rates and the
        post-solve populations; returns (rho, J, JRest)."""
        for si in range(self.maxPrdSubIter):
            rho, J, JRest, Rij, Rji, drho = self.prd_substep(
                rho, J, JRest, Rij, Rji, pops)
            if si + 1 < self.maxPrdSubIter and not more(drho >= self.prdTol):
                break
        return rho, J, JRest

    def prd_substep(self, rho, J, JRest, Rij, Rji, pops):
        """rho of every PRD line (scatter_rho), then the subset solve with
        it: J's subset rows (not I) and the PRD lines' rates are replaced,
        and JRest under hybrid PRD.  drho is the largest |(rNew - rOld) /
        rNew| over rNew != 0, the tracking-only Ng's max change of the
        host prd_redistribute."""
        cfg = self.cfg
        drho = self.zero
        rhoNew = [list(r) for r in rho]
        for (ai, ti, a, t), statics in zip(self.prdLines, self.statics):
            rNew = scatter_rho(a, ti, statics, self.base['C'][ai], Rij[ai],
                               Rji[ai], pops[ai],
                               prd_window_J(cfg, t, statics[3], J, JRest))
            nz = rNew != 0.0
            rel = torch.where(nz, (rNew - rho[ai][ti]) / rNew, 0.0)
            drho = torch.maximum(drho, torch.max(torch.abs(rel)))
            rhoNew[ai][ti] = rNew
        out = self.subsetFn(dict(self.base, J=J, pops=pops, rhoPrd=rhoNew))
        J = J.index_copy(0, self.subT, out['J'].to(J.dtype))
        Rij, Rji = [list(r) for r in Rij], [list(r) for r in Rji]
        for li, (ai, ti, a, t) in enumerate(self.prdLines):
            Rij[ai][ti] = out['Rij'][li]
            Rji[ai][ti] = out['Rji'][li]
        return rhoNew, J, out.get('JRest', JRest), Rij, Rji, drho

    def finish(self, s: Dict):
        """Write the loop's state back to the Context, after one read of
        the populations' finite flags: a non-finite population raises
        ExplodingMatrixError and writes nothing."""
        ctx = self.ctx
        if s['pops']:
            finite = ctx._x_reduce_tensor(torch.stack(
                [torch.isfinite(n).all() for n in s['pops']])
                .to(STATE_DTYPE), 'min').cpu()
            for ai, ok in enumerate(finite.tolist()):
                if not ok:
                    name = self.cfg.activeAtoms[ai].model.element.name
                    raise ExplodingMatrixError(
                        f'Non-finite populations for atom {name} in '
                        f'iterate_on_device after {s["it"]} iterations '
                        '(singular Gamma matrix or diverging Ng '
                        'extrapolation)')
        ctx.J = s['J']
        for st, n in zip(ctx.popsState, s['pops']):
            st['n'] = n
        if self.prdLines:
            ctx.rhoPrd = s['rho']
            if self.cfg.hprd:
                ctx.JRest = s['JRest']


class Context:
    """NLTE radiative transfer context over a 1D or a 2D (x, z) atmosphere.

    Mirrors the user-facing API of lightweaver_tpu.Context on the ported
    slice: construct from (atmos, spect, eqPops), then iterate
    formal_sol_gamma_matrices / stat_equil (and prd_redistribute for PRD
    lines) to convergence (e.g. with iterate_ctx_se(ctx, prd=True)), and
    read I / J / populations / rhoPrd.  All state lives on ``device``, the
    card unless the caller passes device='cpu'; on a CUDA device every
    stage with a kernel launches it.  ``hprd=True`` selects hybrid PRD
    (comoving-frame rho, default scheme only, in either precision).
    ``formalSolver`` (or set_formal_solver) picks the 1D solver of every
    sweep: piecewise linear, Bezier-3 (the default) or BESSER.

    From a converged state, formal_sol is the Lambda step, compute_rays
    the emergent spectrum on any wavelength and mu grid, and
    single_stokes_fs the Zeeman-polarised one (with a field on the
    atmosphere); state_dict, pickle and construct_from_state_dict_with
    carry the state across.

    ``ngOptions`` (an NgOptions) runs Ng acceleration on the populations
    in stat_equil; ``conserveCharge`` follows each statistical-equilibrium
    solve with a Newton-Raphson step on (populations, ne), over hydrogen
    alone with ``nrHOnly``; ``initSol=InitialSolution.EscapeProbability``
    starts from the escape-probability populations (LTE where that
    iteration fails); any other initSol starts from eqPops' populations,
    as in the JAX package.  time_dep_update takes backward-Euler steps in
    place of stat_equil, and update_deps refreshes what depends on an
    atmosphere changed in place.  ``backgroundProvider`` (a callable
    (spect, atmos, eqPops, radSet) returning what
    background.basic_background returns, the default) gives the background
    opacities, here and in update_deps; state_dict does not carry it.

    ``dtype`` is the working dtype: float64, or float32 for the f32 state
    (the default under lightweaverrc ``Precision: mixed``), whose J, Gamma
    and rates are in ``accumDtype`` (float64 unless given float32, which
    keeps them in float32 in either precision).  ``gammaAccum`` ('exact'
    or 'blocked'; default config.params' ``GammaAccum``, else 'exact', as
    in the JAX package) picks the lambda reduction of Gamma/rates under
    the f32 state.  ``gammaMode`` is 'factored' (the default) or 'dense'
    (every transition over the full ray tensors; the default scheme
    only).  ``recurrenceMode`` takes the JAX package's names ('scan', the
    default or lightweaverrc's ``RecurrenceMode``, 'parallel', 'blocked',
    'pallas'; 'pallas' needs a 1D atmosphere and the Bezier-3 solver):
    each runs the port's sweep, and state_dict carries the name.
    ``depthData.fill = True`` makes each MALI step store chi, eta and I at
    full resolution, [Nlam, Nmu, 2, Nk] on the device (depth_data;
    utils.postprocess reads them), and prd_redistribute then re-solves on
    the full grid.  ``accelerateScattering`` solves the coherent background
    scattering's local fixed point in every J update
    (_accelerate_scattering; the JAX Context's option).

    On a 2D atmosphere (Atmosphere.make_2d) stage 2 is the plane sweep
    (formal_solve_2d): ``formalSolver`` is one of SOLVER_NAMES_2D (default
    lightweaverrc ``FormalSolver2d``, 'piecewise_linear_2d', the solver
    the JAX Context runs by default there), ``interpFn2d`` one of
    INTERP_NAMES_2D; the x boundaries are both periodic or both callable
    (compute_bc returning [Nlam, Nmu, 2, Nz]); I is the emergent top plane
    [Nlam, Nmu, Nx].  A 1D solver name on a 2D atmosphere raises (the JAX
    Context runs it as the linear 2D solver), as do the kernel schemes, a
    3D atmosphere and ``mesh=`` on a 1D atmosphere.

    ``mesh`` (a torch DeviceMesh with a dimension named ``meshXAxis``,
    e.g. parallel/xshard2d.py:make_x_mesh) shards a 2D atmosphere's x
    axis over that dimension's ranks, each of which constructs the
    Context with the same arguments and makes every call together: every
    rank keeps its block of Nx / p columns (_take_x_block) on its card
    (multihost.rank_device) and the plane sweeps (the scalar one and the
    Stokes one) exchange halos with its neighbours (parallel/
    xshard2d.py); what the host keeps whole (atmos, eqPops, the
    collisional rates) is cut by _x_local wherever it is read or
    recomputed (charge conservation, update_deps, hybrid PRD's
    coefficients, the PRD and Stokes constants).  The reductions (dJ,
    dPops, drho, Ng's least-squares sums, the finite checks, the
    on-device loop's stopping tests) run over the ranks, so every rank
    takes the same decisions; gather_x (activePops, state_dict and so
    pickling and compute_rays) gives the whole grid's arrays, and ne after
    a charge-conservation step is whole on every rank.  The whole API
    runs there; state_dict's kwargs carry no mesh, so a pickled sharded
    Context comes back unsharded, as in the JAX package.

    iterate_on_device runs the whole MALI loop with its state on the
    device (DeviceLoop: Ng and the PRD sub-iterations too), reading back
    only its stopping tests.  Without ``fsIterScheme`` the Context takes
    lightweaverrc's ``IterationScheme`` (what benchmark(writeConfig=True)
    writes) where that scheme's kernel covers the configuration, else the
    default scheme, as the JAX Context does; an ``fsIterScheme`` it does
    not cover raises.

    Accessors as in the JAX package: Nthreads (1; setting it does
    nothing), hprd, activePops ({element name: numpy populations}) and
    sync_pops_to_eqPops.
    """

    def __init__(self, atmos: Atmosphere, spect, eqPops,
                 ngOptions=None, initSol=None, conserveCharge: bool = False,
                 nrHOnly: bool = False, hprd: bool = False,
                 formalSolver: Optional[str] = None,
                 interpFn2d: str = 'interp_linear_2d',
                 recurrenceMode: Optional[str] = None,
                 backgroundProvider=None,
                 crswCallback=None,
                 dtype: Optional[torch.dtype] = None,
                 accumDtype: Optional[torch.dtype] = None, device='cuda',
                 gammaMode: str = 'factored',
                 fsIterScheme: Optional[str] = None,
                 gammaAccum: Optional[str] = None,
                 accelerateScattering: bool = False, mesh=None,
                 meshXAxis: str = 'x'):
        from .config import params as cfgParams
        twoD = atmos.Ndim == 2
        if formalSolver is None:
            formalSolver = (cfgParams.get('FormalSolver2d',
                                          'piecewise_linear_2d') if twoD
                            else 'piecewise_bezier3_1d')
        if dtype is None:
            dtype = (torch.float32 if cfgParams.get('Precision') == 'mixed'
                     else DEFAULT_DTYPE)
        if accumDtype is None:
            accumDtype = STATE_DTYPE
        if gammaAccum is None:
            gammaAccum = cfgParams.get('GammaAccum', 'exact')
        if recurrenceMode is None:
            recurrenceMode = cfgParams.get('RecurrenceMode', 'scan')
        unsupported = {
            f'a {atmos.Ndim}D atmosphere': atmos.Ndim not in (1, 2),
            f'formalSolver={formalSolver!r} on a {atmos.Ndim}D atmosphere':
                formalSolver not in (SOLVER_NAMES_2D if twoD
                                     else SOLVER_NAMES_1D),
            f'interpFn2d={interpFn2d!r}': interpFn2d not in INTERP_NAMES_2D,
            f'gammaMode={gammaMode!r}': gammaMode not in GAMMA_MODES,
            f'dtype={dtype}': dtype not in (torch.float64, torch.float32),
            f'accumDtype={accumDtype}':
                accumDtype not in (torch.float64, torch.float32),
            f'gammaAccum={gammaAccum!r}': gammaAccum not in GAMMA_ACCUM,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError('lightweaver_tpu_torch does not support '
                             + ', '.join(bad) + ' yet')
        if recurrenceMode not in RECURRENCE_MODES:
            raise ValueError(f'Unknown recurrence mode {recurrenceMode}')
        if recurrenceMode == 'pallas' and (twoD or formalSolver != BEZIER3):
            # the JAX Context's check; its TPU-only float64 refusal has no
            # counterpart on the card
            raise ValueError(
                "recurrenceMode='pallas' (fused Mosaic depth sweep) "
                "requires a 1D atmosphere with the "
                "'piecewise_bezier3_1d' formal solver")
        if atmos.muz is None:
            raise ValueError('Atmosphere angular quadrature not set')
        xShard = None
        if mesh is not None:
            if not twoD:
                raise ValueError('mesh= is only supported for 2D atmospheres '
                                 '(1.5D column batches shard via '
                                 'parallel.columns.ColumnBatch)')
            from .parallel.multihost import rank_device
            from .parallel.xshard2d import XShard
            xShard = XShard.from_mesh(mesh, meshXAxis, atmos.Nx)
            device = rank_device(device)
        device = torch.device(device)
        if device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the Context (the default "
                               "device is 'cuda'; pass device='cpu' to run "
                               "on the CPU)")

        self.atmos = atmos
        self.spect = spect
        self.eqPops = eqPops
        self.conserveCharge = conserveCharge
        self.nrHOnly = nrHOnly
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
            gammaAccum=gammaAccum, gammaMode=gammaMode,
            recurrenceMode=recurrenceMode, formalSolver=formalSolver,
            accelerateScattering=accelerateScattering,
            interpFn2d=interpFn2d, **self._grid_2d(atmos))

        if backgroundProvider is None:
            backgroundProvider = basic_background
        self.backgroundProvider = backgroundProvider
        bg = backgroundProvider(spect, atmos, eqPops, radSet)
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
        self.I = torch.zeros((spect.Nspect, atmos.Nrays)
                             + ((atmos.Nx,) if twoD else ()), dtype=dtype,
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

        # the start solution over the whole grid (on an x-sharded Context
        # too: it reads the host's whole-grid rates and atmosphere)
        if initSol == InitialSolution.EscapeProbability:
            set_pops_escape_probability(self)

        # Ng on the populations, one accelerator per active atom over its
        # flattened [Nlevel, Nk] populations of the whole grid (after the
        # start solution; an x-sharded Context gathers its iterates)
        if ngOptions is None:
            ngOptions = NgOptions(0, 0, 0)
        self.ngs = [Ng(ngOptions.Norder, ngOptions.Nperiod,
                       ngOptions.Ndelay, n.ravel())
                    for n in self._pops_on_host()]
        if xShard is not None:
            self._take_x_block(xShard)
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

        # full-Stokes synthesis (single_stokes_fs)
        self.phi7 = None
        self.Quv = None
        self.J20 = None
        # opt-in full-resolution chi/eta/I capture of each MALI step
        # (ref: Source/LwMiddleLayer.pyx:469-553)
        self.depthData = SimpleNamespace(fill=False, chi=None, eta=None,
                                         I=None)

        self._iter_fn = build_iteration_fn(self.cfg)
        self._drop_params()
        self._nrFn = None
        self._nrFnKey = None
        self._Gamma = None
        self._Rij = None
        self._Rji = None
        if fsIterScheme is not None:
            self.set_fs_iter_scheme(fsIterScheme)
        else:
            # lightweaverrc's scheme, best-effort as in the JAX package: a
            # scheme whose kernel does not cover this configuration leaves
            # the default scheme (a choice between the port's schemes,
            # each on the card)
            rcScheme = cfgParams.get('IterationScheme', SCHEME_DEFAULT)
            if rcScheme != SCHEME_DEFAULT:
                try:
                    self.set_fs_iter_scheme(rcScheme)
                except ValueError:
                    pass

    @property
    def activeAtoms(self):
        return self.cfg.activeAtoms

    @property
    def detailedAtoms(self):
        return self.cfg.detailedAtoms

    @property
    def Nthreads(self) -> int:
        """Thread-count compatibility shim: the card schedules the work,
        so there is one 'thread' and assigning to this does nothing (ref:
        Source/LwMiddleLayer.pyx:3100-3123)."""
        return 1

    @Nthreads.setter
    def Nthreads(self, value):
        pass

    @property
    def hprd(self) -> bool:
        return self.cfg.hprd

    @property
    def activePops(self) -> Dict[str, np.ndarray]:
        """The active atoms' populations [Nlevel, Nk] on the host, keyed
        by element name (of the whole grid on an x-sharded Context)."""
        return {a.model.element.name: pops for a, pops in
                zip(self.cfg.activeAtoms, self._pops_on_host())}

    def sync_pops_to_eqPops(self):
        """Copy the active atoms' populations into eqPops' arrays."""
        for a, pops in zip(self.cfg.activeAtoms, self._pops_on_host()):
            state = self.eqPops.atomicPops[a.model.element]
            if state.pops is not None:
                state.pops[:] = pops

    @staticmethod
    def _grid_2d(atmos: Atmosphere) -> Dict:
        """The IterConfig fields of a 2D atmosphere (none for 1D): the
        grid, the rays' x cosines, the x periodicity and the geometry of
        every (mu, toObs) ray (ops/formal_solver2d.py:build_geometry_2d,
        mux and muz signed by the direction, as the JAX Context builds
        them).  Mixed periodic and callable x boundaries raise."""
        if atmos.Ndim != 2:
            return {}
        xlP = isinstance(atmos.xLowerBc, PeriodicRadiation)
        xuP = isinstance(atmos.xUpperBc, PeriodicRadiation)
        if xlP != xuP:
            raise ValueError('Mixed x boundary types not supported: '
                             'both periodic or both callable')
        x, zGrid = np.asarray(atmos.x), np.asarray(atmos.zGrid)
        mux = np.asarray(atmos.mux)
        geom = {}
        for mu in range(atmos.Nrays):
            for toObs in (False, True):
                sgn = 1.0 if toObs else -1.0
                geom[(mu, toObs)] = fs2d.build_geometry_2d(
                    x, zGrid, sgn * mux[mu], sgn * atmos.muz[mu], toObs,
                    periodic=xlP)
        return {'Ndim': 2, 'Nz': atmos.Nz, 'Nx': atmos.Nx, 'zGrid': zGrid,
                'mux': mux, 'xPeriodic': xlP, 'geom2d': geom}

    # ---- the x-sharded Context (mesh=) ---------------------------------
    def _take_x_block(self, xs):
        """Make the iteration config this rank's block's (Nk = Nz Nx / p,
        Nx = Nx / p) and keep the block's columns of everything that
        holds the grid on the device (background, thermodynamics, J, I,
        the populations and nStar, the profiles and their weights, rho).
        Every stage but the plane sweep is pointwise in (z, x), so each
        rank iterates its block; the host-side state (atmos, eqPops, the
        collisional rates, the damping) stays whole, and whatever is
        recomputed from it later (update_deps, charge conservation, the
        PRD and Stokes constants) is cut by the same _x_local."""
        cfg = self.cfg
        Nz, Nx, Nxl = cfg.Nz, cfg.Nx, xs.Nxl
        self._xCols = (np.arange(Nz)[:, None] * Nx + xs.x0
                       + np.arange(Nxl)[None, :]).ravel()
        self._xIdx = torch.as_tensor(self._xCols, device=self.device)
        self.cfg = dataclasses.replace(cfg, Nk=Nz * Nxl, Nx=Nxl, xShard=xs)
        take = self._x_local
        self.bgChi, self.bgEta, self.bgSca = (take(self.bgChi),
                                              take(self.bgEta),
                                              take(self.bgSca))
        self.temperature, self.height = (take(self.temperature),
                                         take(self.height))
        self.J = take(self.J)
        self.I = self.I[..., xs.x0:xs.x0 + Nxl].contiguous()
        for st in self.popsState + self.detailedPops:
            st['n'], st['nStar'] = take(st['n']), take(st['nStar'])
        self.phi = [[take(x) for x in row] for row in self.phi]
        self.wphi = [[take(x) for x in row] for row in self.wphi]
        self.rhoPrd = [[take(x) for x in row] for row in self.rhoPrd]
        self._CDev = None

    def _x_local(self, x):
        """An array over the whole grid with depth [..., Nz Nx] on its last
        axis (a host array, or a tensor on the Context's device) cut to
        this rank's block [..., Nz Nx / p]; x itself (None too) on an
        unsharded Context."""
        if self.cfg.xShard is None or x is None:
            return x
        if torch.is_tensor(x):
            return x[..., self._xIdx]
        return np.asarray(x)[..., self._xCols]

    def gather_x(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor of this rank's block of x columns, with depth
        [..., Nz Nx / p] or x [..., Nx / p] on its last axis, as the whole
        grid's [..., Nz Nx] or [..., Nx] on every rank of the x group (an
        all_gather); on an unsharded Context x itself."""
        xs = self.cfg.xShard
        if xs is None:
            return x
        from .ops.collectives import all_gather
        blocks = all_gather(x, xs.group)                    # [p, ..., n]
        n = x.shape[-1]
        if n == xs.Nxl:
            return torch.cat(list(blocks), dim=-1)
        blocks = blocks.unflatten(-1, (self.cfg.Nz, xs.Nxl))
        return torch.cat(list(blocks), dim=-1).flatten(-2)

    def _x_reduce_tensor(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """A tensor reduced elementwise over the x group ('sum', 'max' or
        'min'), on the device; x itself on an unsharded Context."""
        if self.cfg.xShard is None:
            return x
        from .ops.collectives import all_reduce
        return all_reduce(x.clone(), self.cfg.xShard.group, op)

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
                    polarisable=t.polarisable,
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
        inputs).  On an x-sharded Context the profiles are formed over the
        whole grid (the line profile protocol's inputs) and cut to the
        block; aDamp and Qelast stay whole.
        ref: Source/FormalScalar.cpp:28-134"""
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
                phi = self._x_local(torch.as_tensor(
                    res.phi, dtype=self.dtype, device=self.device))
                phiA.append(phi)
                wphiA.append(profile_weights(phi, t.wlambdaT, wmu,
                                             self.cfg.Ncol))
            self.phi.append(phiA)
            self.wphi.append(wphiA)
            self.aDamp.append(aDampA)
            self.Qelast.append(QelastA)
        # the params (and the schemes' packed profiles) hold the profiles,
        # the PRD statics the damping
        self._drop_params()
        self._prdStatics = None

    def _normalise_profiles(self):
        """Recompute every line's wphi from its phi for cfg.Ncol columns
        (profile_weights; parallel/columns.py calls it after splitting
        the depth axis into columns)."""
        for ai, a in enumerate(self.cfg.allAtoms):
            for ti, t in enumerate(a.trans):
                if self.phi[ai][ti] is not None:
                    self.wphi[ai][ti] = profile_weights(
                        self.phi[ai][ti], t.wlambdaT, self.cfg.wmuT,
                        self.cfg.Ncol)
        self._drop_params()

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
            self._CDev = [self.cfg.state(self._x_local(C)) for C in self.C]
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

    def _x_bc_data(self, bc):
        """A callable x boundary condition of a non-periodic 2D atmosphere
        as I_incident[Nlam, Nmu, 2, Nz] ((down, up) like the intensity
        layout), or None for periodic, absent or 1D; any other shape
        raises ValueError.
        ref: Source/FormalScalar2d.cpp:496-546"""
        cfg = self.cfg
        if cfg.Ndim != 2 or cfg.xPeriodic or bc is None:
            return None
        data = bc.compute_bc(self.atmos, self.spect)
        if data is None:
            return None
        data = np.asarray(data, np.float64)
        if data.shape != (cfg.Nlam, cfg.Nmu, 2, cfg.Nz):
            raise ValueError(
                'Callable x BC must return [Nlam, Nmu, 2(down,up), Nz], '
                f'got {data.shape}')
        return cfg.tensor(data)

    def _boundary_data(self):
        """Every boundary's data rows, re-read on each call (a callable BC
        may change between MALI steps): the z boundaries' [Nlam, Nmu] and
        the x boundaries' [Nlam, Nmu, 2, Nz] (None where analytic)."""
        atmos = self.atmos
        return {'upperBcData': self._bc_data(atmos.upperBc),
                'lowerBcData': self._bc_data(atmos.lowerBc),
                'xLowerBcData': self._x_bc_data(
                    getattr(atmos, 'xLowerBc', None)),
                'xUpperBcData': self._x_bc_data(
                    getattr(atmos, 'xUpperBc', None))}

    # ------------------------------------------------------------------
    def build_params(self, crswVal: float = 1.0, pack: bool = True) -> Dict:
        """The params dict of one MALI step (build_iteration_fn), with the
        scheme's packed kernel input unless ``pack`` is False."""
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
            **self._boundary_data(),
            'vlosMu': (self.cfg.tensor(self.cfg.vlosMu) if self.cfg.hprd
                       else None),
            'hprdI0': self._hprd_coeff_params(0),
            'hprdFrac': self._hprd_coeff_params(1),
        }
        params['pack'] = self._iter_fn.pack(params) if pack else None
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

    def _drop_params(self):
        """Drop the cached params of the MALI step and the on-device
        loop's prepared state built from them (lightweaver_tpu/
        context.py:3237, 3373)."""
        self._params = None
        self._odRunnerCache = None

    # ------------------------------------------------------------------
    def set_fs_iter_scheme(self, name: str):
        """Select the iteration scheme (the reference's per-SIMD plugin
        registry, LwMiddleLayer.pyx:3077-3098; the JAX package's names):
        'mali_full_precond' (the stages in torch ops around the sweep
        kernel), 'mali_full_precond_fused' (the fused lambda-step kernel,
        ops/fused.py; Bezier-3 only, as in the JAX package) or
        'mali_full_precond_pallas' (the line Gamma kernel, ops/gamma.py).
        The reference's per-SIMD suffixes (_scalar/_SSE2/_AVX*) alias the
        base name.  A configuration that the scheme's kernel does not
        cover raises ValueError."""
        base = name.partition('_scalar')[0].partition('_SSE2')[0] \
                   .partition('_AVX')[0]
        if base not in SCHEME_NEEDS:
            raise ValueError(f'Unknown iteration scheme {name!r}; '
                             "available: 'mali_full_precond', "
                             "'mali_full_precond_fused', "
                             "'mali_full_precond_pallas'")
        _check_scheme(base, self.cfg)
        self._swap_cfg(fsIterScheme=base)

    def _swap_cfg(self, **replacements):
        """Replace fields of the iteration config and drop everything
        built from it: the iteration function, the cached params with the
        scheme's packed input (the line table, the fused pack) and the PRD
        subset function (lightweaver_tpu/context.py:3364-3373)."""
        self.cfg = dataclasses.replace(self.cfg, **replacements)
        self._iter_fn = build_iteration_fn(self.cfg)
        self._drop_params()
        self._prd_fs_fn = None

    def set_formal_solver(self, name: str):
        """Select the formal solver by name (ref: LwMiddleLayer.pyx:3039):
        on a 1D atmosphere one of SOLVER_NAMES_1D (ops/formal_solver.py),
        every later sweep then running the kernel's instance of that
        solver; on a 2D atmosphere one of SOLVER_NAMES_2D, the along-ray
        integration of the plane sweep.  A name of the other dimension or
        an unknown one raises ValueError, and so does a solver the current
        scheme's kernel does not cover (the fused kernel is Bezier-3
        only)."""
        valid = SOLVER_NAMES_2D if self.cfg.Ndim == 2 else SOLVER_NAMES_1D
        if name not in valid:
            raise ValueError(f'Unknown formal solver {name!r} for a '
                             f'{self.cfg.Ndim}D atmosphere; '
                             f'available: {valid}')
        _check_scheme(self.cfg.fsIterScheme,
                      dataclasses.replace(self.cfg, formalSolver=name))
        self._swap_cfg(formalSolver=name)

    def set_interp_fn(self, name: str):
        """Select the upwind interpolation of the 2D plane sweep by name,
        one of INTERP_NAMES_2D (ref: LwMiddleLayer.pyx:3057); an unknown
        name raises ValueError.  A 1D atmosphere keeps the name, as in the
        JAX package, and its sweep does not read it."""
        if name not in INTERP_NAMES_2D:
            raise ValueError(f'Unknown interpolation function {name!r}; '
                             f'available: {INTERP_NAMES_2D}')
        self._swap_cfg(interpFn2d=name)

    def get_fs_iter_scheme_properties(self, fsIterScheme=None) -> dict:
        """Properties of the selected iteration scheme, with the
        reference's key layout (ref: LwMiddleLayer.pyx:4186-4194)."""
        return {'name': self.cfg.fsIterScheme,
                'Ndim': self.cfg.Ndim,
                'dimensionSpecific': False,
                'respectsFormalSolver': True,
                'defaultPerAtomStorage': True,
                'defaultWlaGijStorage': True}

    # ------------------------------------------------------------------
    def formal_sol_gamma_matrices(self, lambdaIterate: bool = False) \
            -> IterationUpdate:
        """One full MALI step: formal solution over all wavelengths with
        Gamma-matrix and rate accumulation; with ``lambdaIterate`` without
        the approximate operator (Psi = 0, the Lambda iteration).
        ref: Source/LwMiddleLayer.pyx:3152"""
        crswVal = self.crswCallback() if self.crswCallback is not None else 1.0
        self.crswDone = crswVal == 1.0
        self.compute_collisions()
        if self._params is None:
            self._params = self.build_params(crswVal)
        p = self._params
        p['J'] = self.J
        p['pops'] = [st['n'] for st in self.popsState]
        # charge conservation and update_deps move nStar (the continua's
        # gij read it)
        p['nStar'] = [st['nStar'] for st in self.popsState]
        p['detNStar'] = [st['nStar'] for st in self.detailedPops]
        p['C'] = self._deviceC()
        p['crsw'] = float(crswVal)
        p['rhoPrd'] = self.rhoPrd
        # a callable BC may change between steps (the PRD subset solve
        # reads these rows from self._params too)
        p.update(self._boundary_data())
        out = self._iter_fn(p, lambdaIterate=lambdaIterate,
                            storeDepthData=self.depthData.fill)
        if self.cfg.xShard is not None:
            from .ops.collectives import all_reduce
            out['dJ'] = all_reduce(out['dJ'], self.cfg.xShard.group, 'max')
        self._crswVal = crswVal
        self._Gamma = out['Gamma']
        self._Rij = out['Rij']
        self._Rji = out['Rji']
        self.J = out['J']
        self.I = out['I']
        if 'JRest' in out:
            self.JRest = out['JRest']
        if self.depthData.fill:
            self.depthData.chi = out['depthChi']
            self.depthData.eta = out['depthEta']
            self.depthData.I = out['depthI']
        return IterationUpdate(self, updatedJ=True, dJMax=out['dJ'],
                               crsw=crswVal)

    def formal_sol(self, upOnly: bool = True) -> IterationUpdate:
        """Plain formal solution updating I and J: the MALI step without
        the operator (lambdaIterate), as in the JAX package (which also
        ignores upOnly)."""
        return self.formal_sol_gamma_matrices(lambdaIterate=True)

    # ------------------------------------------------------------------
    def iterate_on_device(self, NmaxIter: int = 500, Nscatter: int = 3,
                          JTol: float = 5e-3, popsTol: float = 1e-3,
                          ngOptions=None, prd: bool = False,
                          maxPrdSubIter: int = 3, prdTol: float = 1e-2):
        """Run the full MALI loop (formal solution + Gamma + statistical
        equilibrium + convergence test) with its state on the device, as
        the JAX package's iterate_on_device does in one lax.while_loop:
        the MALI step under the Context's scheme (its kernels), the
        statistical-equilibrium solve, Ng on the populations when
        ``ngOptions`` (an NgOptions) is given (ops/ng.py:
        device_ng_accelerate: the ring buffer and the least-squares
        extrapolation on the device) and with ``prd=True`` the PRD (and
        hybrid PRD) sub-iterations: per PRD line the scattering integral,
        then the PRD-subset formal solution, up to ``maxPrdSubIter`` per
        MALI iteration or until drho < ``prdTol`` (the host
        prd_redistribute's schedule with the reference's tracking-only
        Ng).  The first ``Nscatter`` iterations are a Lambda warm-up that
        keeps the initial populations; dPops is 1 until the first
        statistical-equilibrium solve, then Ng's max change (against the
        starting populations at the first).  The loop stops when it
        reaches ``NmaxIter`` or, past the warm-up, when dJ < JTol and
        dPops < popsTol (a NaN stops it).

        Nothing in an iteration copies from the host or reads back but
        the stopping tests: one 0-d flag per MALI iteration (none during
        the warm-up) and one per PRD sub-iteration but the last
        (DeviceLoop).  The prepared state (the params of the MALI step,
        with a callable BC's rows read once, and the PRD constants) is
        cached per option set and dropped with the cached params
        (update_deps, set_fs_iter_scheme, set_formal_solver, ...).
        Collisions and CRSW are fixed (crsw = 1, as in the JAX package).
        The populations stay float64 in either precision (the port's
        state).  Updates J, the populations, rho and JRest in place,
        after checking the populations are finite (else
        ExplodingMatrixError, nothing written), then runs one
        formal_sol_gamma_matrices for I, Gamma and the rates; returns
        (nIter, dJ, dPops).  PRD on a 2D atmosphere raises ValueError, as
        in the JAX package.  On an x-sharded Context every rank of the x
        group calls it: its stopping tests and the finite check are
        reduced over the group (every rank stops in the same step), Ng
        runs on the whole grid's populations (gathered; each rank keeps
        its block), and dJ and dPops are the whole grid's.
        ref: SURVEY.md par. 7.3; PRD schedule: Source/PrdTemplates.hpp:
        176-351"""
        self.compute_collisions()
        ng = ngOptions if ngOptions is not None else NgOptions(0, 0, 0)
        key = (Nscatter, ng.Norder, ng.Nperiod, ng.Ndelay,
               bool(prd and self._prd_lines()), maxPrdSubIter, prdTol)
        if self._odRunnerCache is None or self._odRunnerCache[0] != key:
            self._odRunnerCache = (key, DeviceLoop(
                self, Nscatter, ngOptions, prd, maxPrdSubIter, prdTol))
        loop = self._odRunnerCache[1]

        def go_on(s):
            if s['it'] >= NmaxIter:
                return False
            if s['it'] <= Nscatter:
                return True
            return loop.read_flag((s['dJ'] >= JTol) | (s['dPops'] >= popsTol))

        s = loop.start()
        while go_on(s):
            s = loop.step(s)
        loop.finish(s)
        # refresh I (and Gamma/rates) consistently with the final state
        self.formal_sol_gamma_matrices()
        dJ, dPops = self._x_reduce_tensor(torch.stack([s['dJ'], s['dPops']]),
                                          'max').tolist()
        return s['it'], dJ, dPops

    # ------------------------------------------------------------------
    def _pops_on_host(self) -> List[np.ndarray]:
        """The active atoms' populations [Nlevel, Nk] of the whole grid as
        numpy arrays, in one device-to-host copy of their concatenation
        (on an x-sharded Context gathered over the x group first, in one
        all_gather)."""
        if not self.popsState:
            return []
        flat = self.gather_x(torch.cat([st['n'] for st in self.popsState]))
        Nk = flat.shape[-1]
        flat = flat.reshape(-1).cpu().numpy()
        out, off = [], 0
        for st in self.popsState:
            size = st['n'].shape[0] * Nk
            out.append(flat[off:off + size].reshape(-1, Nk))
            off += size
        return out

    def stat_equil(self) -> IterationUpdate:
        """Statistical equilibrium solve for each active atom; with
        conserveCharge, followed by a Newton-Raphson charge-conservation
        step coupling the populations and ne (nr_post_update).

        With Ng (any Norder > 0) or charge conservation the populations
        go to the host every iteration, all atoms in one device-to-host
        copy (the whole grid's: an x-sharded Context gathers them, so Ng
        runs on the whole grid on every rank and each keeps its block):
        a non-finite value raises ExplodingMatrixError, Ng
        extrapolates and dPops is Ng.max_change.  Otherwise the max
        relative population change and the finite flags are formed on the
        device and fetched in ONE device-to-host copy, with
        Ng.max_change's semantics: 0.0 until two post-solve solutions
        exist, then max |(cur - old)/cur| over cur != 0.
        ref: Source/LwMiddleLayer.pyx:3461-3560"""
        if self._Gamma is None:
            raise ValueError('Call formal_sol_gamma_matrices first')
        for ai, a in enumerate(self.cfg.activeAtoms):
            st = self.popsState[ai]
            nTotal = self.cfg.state(self._x_local(
                self.eqPops.atomicPops[a.model.element].nTotal))
            st['n'] = _stat_eq_solve(self._Gamma[ai], st['n'], nTotal)

        dNeMax = None
        if self.conserveCharge:
            dNeMax = self.nr_post_update(hOnly=self.nrHOnly)

        dPops = []
        accelerated = False
        if any(ng.Norder > 0 for ng in self.ngs) or self.conserveCharge:
            # the whole grid's: every rank of an x group takes the same Ng
            # step and raises together
            for ai, nHost in enumerate(self._pops_on_host()):
                if not np.all(np.isfinite(nHost)):
                    self._raise_non_finite(ai)
                st = self.popsState[ai]
                accel, sol = self.ngs[ai].accelerate(nHost)
                if accel:
                    st['n'] = self.cfg.state(self._x_local(
                        sol.reshape(nHost.shape)))
                    accelerated = True
                dPops.append(self.ngs[ai].max_change())
        else:
            flags = []
            for st in self.popsState:
                nNew = st['n']
                nOld = st.get('nLastSE')
                if nOld is None:
                    dp = torch.zeros((), dtype=torch.float64,
                                     device=self.device)
                else:
                    mask = nNew != 0.0
                    dp = torch.max(torch.where(
                        mask, torch.abs((nNew - nOld)
                                        / torch.where(mask, nNew, 1.0)),
                        0.0))
                flags.append(dp.to(torch.float64))
                flags.append(torch.all(torch.isfinite(nNew))
                             .to(torch.float64))
                st['nLastSE'] = nNew
            vals = torch.stack(flags)
            if self.cfg.xShard is not None:
                # the largest change and the least finite flag of the grid
                from .ops.collectives import all_reduce
                sgn = torch.tensor([1.0, -1.0], dtype=torch.float64,
                                   device=self.device).repeat(len(flags) // 2)
                vals = sgn * all_reduce(sgn * vals, self.cfg.xShard.group,
                                        'max')
            vals = vals.cpu().numpy()
            for ai in range(len(self.popsState)):
                if vals[2 * ai + 1] == 0.0:
                    self._raise_non_finite(ai)
                dPops.append(float(vals[2 * ai]))
        upd = IterationUpdate(self, updatedPops=True, dPops=dPops,
                              ngAccelerated=accelerated)
        if dNeMax is not None:
            upd.updatedNe = True
            upd.dNeMax = dNeMax
        return upd

    def _raise_non_finite(self, ai: int):
        name = self.cfg.activeAtoms[ai].model.element.name
        raise ExplodingMatrixError(
            f'Non-finite populations for atom {name} after the '
            'statistical-equilibrium solve (singular Gamma matrix)')

    # ------------------------------------------------------------------
    def _fd_dC(self, atoms, atomIdx, crswVal: float,
               pertSize: float = 1e-4) -> List[torch.Tensor]:
        """Finite-difference dC/dne per atom of ``atoms`` (active atoms
        ``atomIdx``): perturb ne by ``pertSize`` relative, refresh the
        atom's LTE populations and recompute its collisional rates (on the
        host, as compute_collisions does, over the whole grid); returned
        in float64 on the device (the rank's block on an x-sharded
        Context).
        ref: lightweaver/nr_update.py:75-92"""
        atmos = self.atmos
        neStart = np.asarray(atmos.ne).copy()
        pert = neStart * pertSize
        dCs = []
        for a, ai in zip(atoms, atomIdx):
            state = self.eqPops.atomicPops[a.model.element]
            Cprev = self.C[ai]
            atmos.ne[:] = neStart + pert
            nStarPrev = state.nStar.copy()
            state.nStar[:] = lte_pops(a.model, atmos.temperature, atmos.ne,
                                      state.nTotal, debye=True)
            Cpert = np.zeros_like(Cprev)
            for col in a.model.collisions:
                col.compute_rates(atmos, self.eqPops, Cpert)
            np.clip(Cpert, 0.0, None, out=Cpert)
            atmos.ne[:] = neStart
            state.nStar[:] = nStarPrev
            dCs.append(self.cfg.state(self._x_local(
                crswVal * (Cpert - Cprev) / pert)))
        return dCs

    def nr_post_update(self, fdCollisionRates: bool = True,
                       hOnly: bool = False, timeDependentData=None,
                       stepLimit: bool = True) -> float:
        """Newton-Raphson charge-conservation update of (populations, ne)
        from the last MALI step's Gamma (nr_update.build_nr_fn, in float64
        on the device under either working dtype); then the LTE
        populations, H-, nStar and the collisional rates are refreshed for
        the new ne.  ``hOnly`` couples hydrogen alone (the other species
        then count as background electrons); ``timeDependentData`` =
        {'dt', 'nPrev'} couples the backward-Euler residual instead of
        statistical equilibrium; stepLimit=False takes the reference's raw
        Newton step.  Returns the max relative change in ne.  On an
        x-sharded Context each rank steps its block (ne, the background
        electrons, nTotal and the rates cut by _x_local) and the new ne is
        gathered into the whole atmos.ne on every rank, from which every
        rank refreshes the whole LTE state and cuts it again: all ranks
        return the same change.
        ref: lightweaver/nr_update.py:7-106"""
        if self._Gamma is None:
            raise ValueError('Call formal_sol_gamma_matrices first')
        if (not self.cfg.activeAtoms or self.cfg.activeAtoms[0].model.element
                != PeriodicTable.element(1)):
            raise ValueError(
                'Calling nr_post_update without Hydrogen active.')
        atoms = (self.cfg.activeAtoms[:1] if hOnly
                 else self.cfg.activeAtoms)
        atomIdx = list(range(len(atoms)))
        crswVal = self._crswVal
        timeDep = timeDependentData is not None

        # background electron contribution from the species outside NR
        if hOnly:
            bgModels = [m for m in self.spect.radSet
                        if m.element != PeriodicTable.element(1)]
        else:
            bgModels = (self.spect.radSet.detailedAtoms
                        + self.spect.radSet.passiveAtoms)
        backgroundNe = np.zeros_like(np.asarray(self.atmos.ne))
        for m in bgModels:
            stages = np.array([l.stage for l in m.levels], dtype=np.float64)
            n = self.eqPops.atomicPops[m.element].n
            backgroundNe += np.sum(stages[:, None] * n, axis=0)

        dCs = (self._fd_dC(atoms, atomIdx, crswVal)
               if fdCollisionRates else None)

        key = (len(atoms), timeDep, fdCollisionRates, stepLimit)
        if self._nrFnKey != key:
            Nlevels = [a.Nlevel for a in atoms]
            stagesList = [np.array([l.stage for l in a.model.levels],
                                   dtype=np.float64) for a in atoms]
            contPairs = [[(t.i, t.j) for t in a.trans if not t.isLine]
                         for a in atoms]
            self._nrFn = build_nr_fn(Nlevels, stagesList, contPairs,
                                     timeDep, STATE_DTYPE,
                                     stepLimit=stepLimit)
            self._nrFnKey = key

        t_ = self.cfg.state
        Gammas = [self._Gamma[ai].to(STATE_DTYPE) for ai in atomIdx]
        ns = [self.popsState[ai]['n'] for ai in atomIdx]
        nTotals = [t_(self._x_local(
            self.eqPops.atomicPops[a.model.element].nTotal)) for a in atoms]
        Cs = [self._deviceC()[ai] for ai in atomIdx]
        ne = t_(self._x_local(self.atmos.ne))
        bgNe = t_(self._x_local(backgroundNe))
        if timeDep:
            newNs, newNe = self._nrFn(
                Gammas, ns, nTotals, Cs, dCs, ne, bgNe, crswVal,
                float(timeDependentData['dt']),
                [torch.as_tensor(p, dtype=STATE_DTYPE, device=self.device)
                 for p in timeDependentData['nPrev'][:len(atoms)]])
        else:
            newNs, newNe = self._nrFn(Gammas, ns, nTotals, Cs, dCs, ne,
                                      bgNe, crswVal)

        for ai, nNew in zip(atomIdx, newNs):
            self.popsState[ai]['n'] = nNew
        neStart = np.asarray(self.atmos.ne).copy()
        neNew = self.gather_x(newNe).cpu().numpy()
        self.atmos.ne[:] = neNew

        # refresh the LTE populations and H- for the new ne, and nStar on
        # the device (the continua's gij read it); C depends on ne
        self.eqPops.update_lte_atoms_Hmin_pops(self.atmos,
                                               conserveCharge=False)
        self._refresh_nstar()
        self.compute_collisions(force=True)
        return float(np.max(np.abs(neNew - neStart) / neNew))

    def _refresh_nstar(self):
        """nStar of the active and detailed atoms from eqPops, on the
        device (formal_sol_gamma_matrices hands them to each MALI step)."""
        for a, st in zip(self.cfg.allAtoms,
                         self.popsState + self.detailedPops):
            st['nStar'] = self.cfg.state(self._x_local(
                self.eqPops.atomicPops[a.model.element].nStar))

    # ------------------------------------------------------------------
    def time_dep_update(self, dt: float, prevTimePops=None) \
            -> Tuple[IterationUpdate, List]:
        """Backward-Euler time-dependent population update from the last
        MALI step's Gamma: (I - dt Gamma) n = prevTimePops per active atom
        (default: the current populations).  Returns the update (dPops =
        max |1 - n_old/n_new| per atom) and prevTimePops, for the next
        sub-iteration of the same time step.
        ref: Source/UpdatePopulations.cpp:120-151"""
        if self._Gamma is None:
            raise ValueError('Call formal_sol_gamma_matrices first')
        if prevTimePops is None:
            prevTimePops = [st['n'] for st in self.popsState]
        changes = []
        for ai, st in enumerate(self.popsState):
            nNew = _time_dep_solve(self._Gamma[ai],
                                   prevTimePops[ai], dt)
            changes.append(torch.max(torch.abs(1.0 - st['n'] / nNew)))
            st['n'] = nNew
        if changes and self.cfg.xShard is not None:
            from .ops.collectives import all_reduce
            changes = list(all_reduce(torch.stack(changes),
                                      self.cfg.xShard.group, 'max'))
        dPops = ([float(x) for x in torch.stack(changes).cpu().numpy()]
                 if changes else [])
        upd = IterationUpdate(self, updatedPops=True, dPops=dPops)
        return upd, prevTimePops

    def time_dep_restore_prev_pops(self, prevTimePops):
        """Put the populations of the start of a time step back."""
        for ai, nOld in enumerate(prevTimePops):
            self.popsState[ai]['n'] = nOld

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
        # the whole grid's projections, cut to an x-sharded rank's block
        vlosMu = np.asarray(self._x_local(self.atmos.vlos_mu()))  # [Nmu, Nk]
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

    def _prd_subset_fn(self):
        """The PRD subset solve (build_prd_subset_fn over
        _prd_subset_idxs), built once per configuration, with its global
        rows on the device in _prdSubIdxsT."""
        if self._prd_fs_fn is None:
            prdLines = [(ai, ti) for ai, ti, a, t in self._prd_lines()]
            self._prdSubIdxs = self._prd_subset_idxs()
            self._prdSubIdxsT = torch.as_tensor(self._prdSubIdxs,
                                                device=self.device)
            self._prd_fs_fn = build_prd_subset_fn(
                self.cfg, self._prdSubIdxs, prdLines)
        return self._prd_fs_fn

    def _prd_subset_fs(self):
        """Subset formal solution for PRD sub-iterations: refresh J (and
        JRest) and the PRD lines' radiative rates at the PRD-active
        wavelengths only, leaving Gamma and every other rate untouched
        (ref: FsMode::PrdOnly, PrdTemplates.hpp:19-113).  Returns dJ on
        the subset (0-d tensor)."""
        p = self._params
        p['J'] = self.J
        p['pops'] = [st['n'] for st in self.popsState]
        p['rhoPrd'] = self.rhoPrd
        out = self._prd_subset_fn()(p)
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
        aDamp [Nk], Qelast [Nk] (the block's on an x-sharded Context), and
        under hybrid PRD the first row of its window in JRest."""
        if self._prdStatics is None:
            t_ = self.cfg.state
            self._prdStatics = []
            for ai, ti, a, t in self._prd_lines():
                vBroad = a.model.vBroad(self.atmos)
                qWave = ((t.wavelength[:, None] - t.lambda0) * Const.CLight
                         / (t.lambda0 * vBroad[None, :]))
                prd0 = (int(self.cfg.laToPrdLa[t.Nblue]) if self.cfg.hprd
                        else None)
                self._prdStatics.append(tuple(
                    t_(self._x_local(x)) for x in
                    (qWave, self.aDamp[ai][ti], self.Qelast[ai][ti]))
                    + (prd0,))
        return self._prdStatics

    def _rho_on_host(self, ai, ti, rho=None):
        """rho of line (ai, ti) (or ``rho``, its new value) of the whole
        grid as a flat numpy array, for Ng: the copy kept when
        prd_redistribute last set it, else one device pull (gathered over
        the x group of an x-sharded Context)."""
        if rho is None:
            rho = self.rhoPrd[ai][ti]
            kept = self._rhoHost.get((ai, ti))
            if kept is not None and kept[0] is rho:
                return kept[1]
        return self.gather_x(rho).cpu().numpy().ravel()

    def _scatter_rho(self, li: int, Jw=None) -> torch.Tensor:
        """The new rho [W, Nk] of PRD line ``li`` of _prd_lines() from the
        mean intensity of its window ``Jw`` (default: the current J, or
        JRest under hybrid PRD: prd_window_J), rates and populations,
        formed on the device (scatter_rho)."""
        ai, ti, a, t = self._prd_lines()[li]
        statics = self._prd_line_statics()[li]
        if Jw is None:
            Jw = prd_window_J(self.cfg, t, statics[3], self.J, self.JRest)
        return scatter_rho(a, ti, statics, self._deviceC()[ai], self._Rij[ai],
                           self._Rji[ai], self.popsState[ai]['n'], Jw)

    def prd_redistribute(self, maxIter: int = 3,
                         tol: float = 1e-2) -> IterationUpdate:
        """Iterate the PRD emission-profile ratios rho: per line compute
        the angle-averaged scattering integral against the current J and
        rates, then refresh J/rates with a formal solution, until
        drho < tol or maxIter.

        PjQj, gammaPre, Jbar and rho are formed on the device; the one
        host pull per line and sub-iteration is the flattened rho that
        the numpy Ng tracks (the reference's Ng semantics).  On an
        x-sharded Context each rank forms rho on its block (pointwise in
        depth) and the Ng runs on the whole grid's rho (gathered), so
        every rank takes the same sub-iterations; the refresh is the
        full-grid MALI step, as on every 2D atmosphere.
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
                    or any(ng.init and ng.len != t.W * self.atmos.Nspace
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
                rhoHost = self._rho_on_host(ai, ti, rho)
                accelerated, rhoFlat = ngs[li].accelerate(rhoHost,
                                                          trustFactor=2.0)
                dRho[li] = ngs[li].max_change()
                dRhoMax = max(dRhoMax, dRho[li])
                if accelerated:
                    rhoHost = rhoFlat
                    rho = self.cfg.state(self._x_local(
                        rhoFlat.reshape(t.W, -1)))
                self.rhoPrd[ai][ti] = rho
                self._rhoHost[(ai, ti)] = (rho, rhoHost)

            # refresh J and the PRD lines' rates with the new rho on the
            # PRD-active wavelength subset only (ref FsMode::PrdOnly), or
            # with the full-grid MALI step under prdFsMode == 'full', on a
            # 2D atmosphere and while depthData is filled (as the JAX
            # package does)
            if (self.prdFsMode == 'subset' and self.cfg.Ndim == 1
                    and not self.depthData.fill
                    and self._params is not None):
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

    # ------------------------------------------------------------------
    def update_deps(self, temperature: bool = True, background: bool = True,
                    profiles: bool = True, collisions: bool = True):
        """Recompute what depends on the atmosphere after it was changed
        in place (T, ne, vlos, vturb, ...): the LTE populations, H- and
        nStar, T and height (``temperature``); the background opacities
        (``background``); the line profiles (``profiles``); the
        collisional rates (``collisions``); and under hybrid PRD the
        comoving-frame coefficients.  The cached params, with the schemes'
        packed profiles, are rebuilt on the next MALI step.  On an
        x-sharded Context every rank recomputes from the whole host grid
        and keeps its block (_x_local, the cut of _take_x_block).
        ref: Source/LwMiddleLayer.pyx:3244-3288"""
        atmos = self.atmos

        def t_(x):
            return self.cfg.state(self._x_local(x))
        if temperature:
            self.eqPops.update_lte_atoms_Hmin_pops(
                atmos, conserveCharge=self.conserveCharge)
            self._refresh_nstar()
            self.temperature = t_(atmos.temperature)
            self.height = t_(atmos.height)
        if background:
            bg = self.backgroundProvider(self.spect, atmos, self.eqPops,
                                         self.spect.radSet)
            self.background = bg
            self.bgChi = t_(bg.chi)
            self.bgEta = t_(bg.eta)
            self.bgSca = t_(bg.sca)
        if profiles:
            self.compute_profiles()
        if collisions:
            self.compute_collisions(force=True)
        if self.cfg.hprd and self._prd_lines():
            # velocity changes move the comoving-frame coefficients and
            # the PRD subset
            self._configure_hprd_coeffs()
            self._prd_fs_fn = None
        self._drop_params()

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict:
        """Serialisable snapshot of the simulation state (checkpoint,
        clone, warm restart): the atmosphere, spectrum and eqPops objects,
        and J, I, the active populations and nStar and each PRD line's rho
        (with its window) copied to host numpy.  ``kwargs`` rebuild the
        Context: conserveCharge, hprd, formalSolver, interpFn2d,
        recurrenceMode, accelerateScattering and the device.  As in the
        JAX package the working dtype, gammaMode and the
        backgroundProvider are not kept, so a float32 Context comes back
        float64.  On an x-sharded Context the arrays are the whole grid's
        (gather_x: every rank of the x group calls it, and every rank's
        dict equals the unsharded Context's), and the kwargs carry no
        mesh, so that the state rebuilds an unsharded Context, as in the
        JAX package.
        ref: Source/LwMiddleLayer.pyx:2977-3037"""
        def host(x):
            return _host(self.gather_x(x))
        return {
            'atmos': self.atmos,
            'spect': self.spect,
            'eqPops': self.eqPops,
            'J': host(self.J),
            'I': host(self.I),
            'pops': [host(st['n']) for st in self.popsState],
            'nStar': [host(st['nStar']) for st in self.popsState],
            'rhoPrd': {
                (a.model.element, t.i, t.j):
                    (t.wavelength.copy(), host(self.rhoPrd[ai][ti]))
                for ai, ti, a, t in self._prd_lines()},
            'kwargs': {
                'conserveCharge': self.conserveCharge,
                'hprd': self.cfg.hprd,
                'formalSolver': self.cfg.formalSolver,
                'interpFn2d': self.cfg.interpFn2d,
                'recurrenceMode': self.cfg.recurrenceMode,
                'accelerateScattering': self.cfg.accelerateScattering,
                'device': str(self.device),
            },
        }

    def __getstate__(self):
        """Pickle protocol: the Context pickles through its state dict
        (checkpoint and resume with plain pickle.dump / pickle.load), as
        the reference's Cython classes do.
        ref: Source/LwMiddleLayer.pyx:2977-3037"""
        return self.state_dict()

    def __setstate__(self, state: Dict):
        """Rebuild from a state dict on its kwargs' device."""
        ctx = Context.construct_from_state_dict_with(state)
        self.__dict__.update(ctx.__dict__)

    @classmethod
    def construct_from_state_dict_with(cls, state: Dict, atmos=None,
                                       spect=None, eqPops=None) -> 'Context':
        """Rebuild a Context from a state dict, optionally with another
        atmosphere, spectral configuration or eqPops: J is interpolated
        onto the new wavelength grid (linear in wavelength, per depth),
        the populations and nStar are copied, and each PRD line's rho is
        interpolated onto its new window.
        ref: Source/LwMiddleLayer.pyx:3758-3896"""
        atmos = atmos if atmos is not None else state['atmos']
        spect = spect if spect is not None else state['spect']
        eqPops = eqPops if eqPops is not None else state['eqPops']
        ctx = cls(atmos, spect, eqPops, **state['kwargs'])

        oldLam = np.asarray(state['spect'].wavelength)
        newLam = np.asarray(spect.wavelength)
        Jold = state['J']
        if len(newLam) == len(oldLam) and np.allclose(newLam, oldLam):
            Jnew = Jold
            if state.get('I') is not None \
                    and state['I'].shape == tuple(ctx.I.shape):
                ctx.I = ctx.cfg.tensor(state['I'])
        else:
            Jnew = np.empty((len(newLam), Jold.shape[1]))
            for k in range(Jold.shape[1]):
                Jnew[:, k] = np.interp(newLam, oldLam, Jold[:, k])
        ctx.J = torch.tensor(Jnew, dtype=ctx.accumDtype, device=ctx.device)
        for st, n, nStar in zip(ctx.popsState, state['pops'], state['nStar']):
            st['n'] = ctx.cfg.state(n)
            st['nStar'] = ctx.cfg.state(nStar)

        # rho onto the new per-line windows
        # (ref: Source/LwMiddleLayer.pyx:1960-1963)
        oldRho = state.get('rhoPrd', {})
        for ai, ti, a, t in ctx._prd_lines():
            key = (a.model.element, t.i, t.j)
            if key not in oldRho:
                continue
            oldLamW, rho = oldRho[key]
            rhoNew = np.empty((t.W, rho.shape[1]))
            for k in range(rho.shape[1]):
                rhoNew[:, k] = np.interp(t.wavelength, oldLamW, rho[:, k])
            ctx.rhoPrd[ai][ti] = ctx.cfg.state(rhoNew)
        return ctx

    # ------------------------------------------------------------------
    def compute_rays(self, wavelengths=None, mus=None, stokes: bool = False,
                     refinePrd: bool = False) -> np.ndarray:
        """Emergent intensities on any (wavelength, mu) grid from the
        current state: a Context on this one's device over a subset
        spectral configuration in which every transition covers the whole
        grid (spect.subset_configuration) and with one ray per mu
        (Atmosphere.rays), built from state_dict, runs formal_sol (the
        sweep kernel on the card) or, with ``stokes``, single_stokes_fs.
        ``refinePrd`` first runs a MALI step and prd_redistribute
        (maxIter=100).  Returns I [Nlam, Nmu], or with ``stokes`` [4, Nlam,
        Nmu] (I, Q, U, V), as numpy.  On an x-sharded Context every rank
        of the x group calls it and builds the unsharded ray Context from
        the gathered state on its own card.
        ref: Source/LwMiddleLayer.pyx:3898-4003"""
        state = self.state_dict()
        spect2 = self.spect.subset_configuration(
            self.spect.wavelength if wavelengths is None else wavelengths)
        atmos2 = copy.copy(self.atmos)
        if mus is not None:
            atmos2.rays(mus)
        rayCtx = Context.construct_from_state_dict_with(
            state, atmos=atmos2, spect=spect2)
        if refinePrd and rayCtx._prd_lines():
            rayCtx.formal_sol_gamma_matrices()
            rayCtx.prd_redistribute(maxIter=100)
        if stokes:
            rayCtx.single_stokes_fs()
            return np.concatenate([_host(rayCtx.I)[None],
                                   _host(rayCtx.Quv)], axis=0)
        rayCtx.formal_sol()
        return _host(rayCtx.I)

    # ------------------------------------------------------------------
    def compute_polarised_profiles(self):
        """Zeeman-split profiles of every polarisable line with Zeeman
        components: phi (Stokes I), phi_{Q,U,V} and the anomalous
        dispersion psi_{Q,U,V}, each [W, Nmu, 2, Nk] (the JAX package's
        layout), and wphi, as self.phi7[atom][trans] (None elsewhere), from
        the anomalous-splitting components (zeeman.py), the field's
        projections on each ray (Atmosphere.B_projections) and the real
        pair (H, F) of the Faddeeva function (ops/faddeeva.py:voigt_HF).
        Without a field every entry is None.  On an x-sharded Context every
        per-depth input is cut to the rank's block first (_x_local), so the
        profiles are the block's.
        ref: Source/FormalStokes.cpp:9-117"""
        atmos = self.atmos
        allAtoms = self.cfg.allAtoms
        if atmos.B is None:
            self.phi7 = [[None] * len(a.trans) for a in allAtoms]
            return

        def t_(x):
            """A per-depth host array on the device, the rank's block."""
            return self.cfg.tensor(self._x_local(x))
        vlosMu = t_(atmos.vlos_mu())
        wmu = self.cfg.tensor(atmos.wmu)
        cosGamma, cos2chi, sin2chi = atmos.B_projections()
        cosG = t_(cosGamma)[None, :, None, :]
        sin2G = 1.0 - cosG * cosG
        c2chi = t_(cos2chi)[None, :, None, :]
        s2chi = t_(sin2chi)[None, :, None, :]
        s = self.cfg.tensor([-1.0, 1.0])[None, None, :, None]
        vBFac = (Const.QElectron / (4.0 * np.pi * Const.MElectron)
                 * Const.NM_TO_M)
        names = {-1: 'sb', 0: 'pi', 1: 'sr'}

        self.phi7 = []
        for ai, a in enumerate(allAtoms):
            vBroad = np.asarray(a.model.vBroad(atmos))
            lineByIdx = {(l.i, l.j): l for l in a.model.lines}
            phiA = []
            for ti, t in enumerate(a.trans):
                z = (lineByIdx[(t.i, t.j)].zeeman_components()
                     if t.isLine and t.polarisable else None)
                if z is None:
                    phiA.append(None)
                    continue
                aDamp = t_(self.aDamp[ai][ti])[None, None, None, :]
                vB = t_(vBFac * t.lambda0 * np.asarray(atmos.B) / vBroad)
                sv = t_(1.0 / (Const.SqrtPi * vBroad))
                vBase = (t.wavelengthT - t.lambda0) * Const.CLight / t.lambda0
                vk = ((vBase[:, None, None, None]
                       + s * vlosMu[None, :, None, :])
                      / t_(vBroad)[None, None, None, :])
                acc = dict.fromkeys(('phi_sb', 'phi_pi', 'phi_sr', 'psi_sb',
                                     'psi_pi', 'psi_sr'), 0.0)
                for nz in range(len(z.alpha)):
                    H, Fd = voigt_HF(aDamp, vk - float(z.shift[nz])
                                     * vB[None, None, None, :])
                    key = names[int(z.alpha[nz])]
                    acc['phi_' + key] += float(z.strength[nz]) * H
                    acc['psi_' + key] += float(z.strength[nz]) * Fd
                phiSigma = acc['phi_sr'] + acc['phi_sb']
                phiDelta = 0.5 * acc['phi_pi'] - 0.25 * phiSigma
                psiSigma = acc['psi_sr'] + acc['psi_sb']
                psiDelta = 0.5 * acc['psi_pi'] - 0.25 * psiSigma
                svB = sv[None, None, None, :]
                phi = (phiDelta * sin2G + 0.5 * phiSigma) * svB
                out = {
                    'phi': phi,
                    'phiQ': s * phiDelta * sin2G * c2chi * svB,
                    'phiU': phiDelta * sin2G * s2chi * svB,
                    'phiV': s * 0.5 * (acc['phi_sr'] - acc['phi_sb'])
                            * cosG * svB,
                    'psiQ': s * psiDelta * sin2G * c2chi * svB,
                    'psiU': psiDelta * sin2G * s2chi * svB,
                    'psiV': s * 0.5 * (acc['psi_sr'] - acc['psi_sb'])
                            * cosG * svB,
                }
                out['wphi'] = 1.0 / torch.einsum('lmdk,l,m->k', phi,
                                                 t.wlambdaT, 0.5 * wmu)
                phiA.append(out)
            self.phi7.append(phiA)

    def single_stokes_fs(self, recompute: bool = False, updateJ: bool = False,
                         upOnly: bool = True, J20: bool = False) \
            -> IterationUpdate:
        """Polarised (Zeeman) formal solution of the upgoing rays: the
        emergent Stokes I as self.I [Nlam, Nmu] and Q, U, V as self.Quv
        [3, Nlam, Nmu] (no Gamma or rates).  ``updateJ`` replaces J by the
        mu moment of the Stokes I of the upgoing rays (0.5 wmu, as the JAX
        package does); ``J20`` adds the anisotropic-scattering tensor J^2_0
        of the last call to the background scattering emissivity (wI(mu)
        sca J20 in I, wQ(mu) sca J20 in Q) and, with updateJ, re-forms
        self.J20 [Nlam, Nk] from the new I and Q.  The depth sweep is
        ops/stokes.py:delo_bezier_stokes (torch ops; the JAX package
        leaves it to XLA).  On a 2D atmosphere it is synthesis only (self.I
        [Nlam, Nmu, Nx], self.Quv [3, Nlam, Nmu, Nx] of the top plane;
        ops/stokes2d.py) and ``updateJ`` or ``J20`` raise ValueError, as in
        the JAX package; on an x-sharded Context self.I and self.Quv are
        the rank's block of x, the plane sweep sharded as the scalar one is
        (parallel/xshard2d.py:sweep_stokes_rays_2d_xsharded), and
        gather_x gives every rank the whole grid's.
        ref: Source/LwMiddleLayer.pyx:3605,
             Source/FormalStokes.cpp:418-728"""
        if self.cfg.Ndim == 2 and (updateJ or J20):
            raise ValueError('2D Stokes synthesis does not support '
                             'updateJ/J20 (synthesis only)')
        if self.phi7 is None or recompute:
            self.compute_polarised_profiles()
        chi7, S4 = self._assemble_stokes_chi_S()
        return self._stokes_solve(chi7, S4, chi7[:, :, 0, :],
                                  updateJ=updateJ, J20=J20)

    def _assemble_stokes_chi_S(self):
        """chi7 [Nlam, Nmu, 7, Nk] and S4 [Nlam, Nmu, 4, Nk] of the
        upgoing rays in the working dtype: the background and every
        transition in chi7[:, :, 0] and eta4[:, :, 0]; each polarised
        line's seven profiles in chi7's seven components and its first
        four in eta4's; S4 = eta4 / chiI, plus (bgEta + bgSca J) / chiI in
        Stokes I."""
        cfg = self.cfg
        Nlam, Nmu, Nk = cfg.Nlam, cfg.Nmu, cfg.Nk
        d = 1          # upgoing only
        params = _working_params(cfg, self.build_params(pack=False))

        chi7 = torch.zeros((Nlam, Nmu, 7, Nk), dtype=cfg.dtype,
                           device=cfg.device)
        eta4 = torch.zeros((Nlam, Nmu, 4, Nk), dtype=cfg.dtype,
                           device=cfg.device)
        chi7[:, :, 0, :] += params['bgChi'][:, None, :]
        comps = (('phi', 0), ('phiQ', 1), ('phiU', 2), ('phiV', 3),
                 ('psiQ', 4), ('psiU', 5), ('psiV', 6))
        for ai, a in enumerate(cfg.allAtoms):
            n = params['allPops'][ai]
            for ti, t in enumerate(a.trans):
                sl = slice(t.Nblue, t.Nred)
                p7 = self.phi7[ai][ti] if t.isLine else None
                if p7 is None:
                    Uji, Vij, Vji = _uv(cfg, params, ai, ti, t)
                    # continua carry one direction
                    dd = min(d, Vij.shape[0] - 1)
                    chi7[sl, :, 0, :] += (n[t.i] * Vij - n[t.j] * Vji)[dd]
                    eta4[sl, :, 0, :] += (n[t.j] * Uji)[dd]
                    continue
                hnu_4pi = Const.HC_FOURPI * (t.lambda0 / t.wavelengthT)
                rho = line_rho(params, ai, ti, t)
                for name, ci in comps:
                    Vij = hnu_4pi[:, None, None] * t.Bij * p7[name][:, :, d, :]
                    Vji = (t.Bji / t.Bij) * Vij
                    if rho is not None:
                        Vji = Vji * rho[:, None, :]
                    Uji = (t.Aji / t.Bji) * Vji
                    chi7[sl, :, ci, :] += n[t.i] * Vij - n[t.j] * Vji
                    if ci < 4:
                        eta4[sl, :, ci, :] += n[t.j] * Uji

        chiI = chi7[:, :, 0, :]
        S4 = eta4 / chiI[:, :, None, :]
        S4[:, :, 0, :] += ((params['bgEta'] + params['bgSca']
                            * self.J.to(cfg.dtype))[:, None, :] / chiI)
        return chi7, S4

    def _stokes_solve(self, chi7, S4, chiI, updateJ=False, J20=False):
        """The Stokes solve of single_stokes_fs from chi7 and S4: the
        DELO-Bezier3 depth sweep on a 1D atmosphere, on a 2D one
        _stokes_solve_2d (single_stokes_fs has refused updateJ and J20
        there)."""
        if self.cfg.Ndim == 2:
            return self._stokes_solve_2d(chi7, S4, chiI)
        cfg = self.cfg
        Nlam, Nmu, Nk = cfg.Nlam, cfg.Nmu, cfg.Nk
        dt, adt = cfg.dtype, cfg.accumDtype
        muz = cfg.muzT
        if J20:
            # anisotropic scattering source terms from the previous J20
            # (ref FormalStokes.cpp:483-486, 575-582): the mu-dependent
            # irreducible-tensor weights feed I and Q emissivity
            inv2root2 = 1.0 / (2.0 * np.sqrt(2.0))
            mu2 = muz ** 2
            wJ20_I = inv2root2 * (3.0 * mu2 - 1.0)
            wJ20_Q = inv2root2 * 3.0 * (mu2 - 1.0)
            if self.J20 is None:
                self.J20 = torch.zeros((Nlam, Nk), dtype=adt,
                                       device=self.device)
            etaJ20 = ((self.bgSca.to(dt) * self.J20.to(dt))[:, None, :]
                      / chiI)
            S4[:, :, 0, :] += wJ20_I[None, :, None] * etaJ20
            S4[:, :, 1, :] += wJ20_Q[None, :, None] * etaJ20

        # thermalised lower boundary for Stokes I; Q = U = V = 0
        if cfg.lowerThermalised:
            T = self.temperature.to(dt)
            height = self.height.to(dt)
            BnuN = planck_nu(T[Nk - 1], cfg.wavelengthT)
            BnuN1 = planck_nu(T[Nk - 2], cfg.wavelengthT)
            dtau = (0.5 * (chiI[:, :, Nk - 1] + chiI[:, :, Nk - 2])
                    * torch.abs(height[Nk - 1] - height[Nk - 2])
                    / muz[None, :])
            I0 = BnuN[:, None] - (BnuN1[:, None] - BnuN[:, None]) / dtau
        else:
            I0 = torch.zeros((Nlam, Nmu), dtype=dt, device=self.device)
        Iupw = torch.cat([I0.reshape(-1, 1),
                          torch.zeros((Nlam * Nmu, 3), dtype=dt,
                                      device=self.device)], dim=1)
        muzB = muz[None, :].expand(Nlam, Nmu).reshape(-1)
        Ifull = delo_bezier_stokes(chi7.reshape(Nlam * Nmu, 7, Nk),
                                   S4.reshape(Nlam * Nmu, 4, Nk),
                                   self.height.to(dt), muzB, Iupw,
                                   to_obs=True).reshape(Nlam, Nmu, 4, Nk)
        self.I = Ifull[:, :, 0, 0]
        self.Quv = torch.movedim(Ifull[:, :, 1:, 0], 2, 0)  # [3, Nlam, Nmu]
        if updateJ:
            wmu = cfg.wmuT.to(adt)
            self.J = torch.einsum('lmk,m->lk', Ifull[:, :, 0, :].to(adt),
                                  0.5 * wmu)
            if J20:
                # J20(la, k) = sum_mu wmu [wI I + wQ Q]
                # (ref FormalStokes.cpp:642-648)
                self.J20 = (
                    torch.einsum('lmk,m->lk', Ifull[:, :, 0, :].to(adt),
                                 wmu * wJ20_I.to(adt))
                    + torch.einsum('lmk,m->lk', Ifull[:, :, 1, :].to(adt),
                                   wmu * wJ20_Q.to(adt)))
        return IterationUpdate(self, updatedJ=updateJ)

    def _stokes_solve_2d(self, chi7, S4, chiI):
        """2D Stokes synthesis (the JAX package's 2D branch of
        _stokes_solve, lightweaver_tpu/context.py:2888-2951): the upgoing
        rays in one plane sweep (ops/stokes2d.py:sweep_stokes_rays_2d) from
        the thermalised bottom plane of the scalar 2D path for Stokes I
        (Q = U = V = 0), the non-periodic rays' fixed x column taking the
        x BC's Stokes-I inflow; self.I [Nlam, Nmu, Nx] and self.Quv [3,
        Nlam, Nmu, Nx] of the top plane.  With cfg.xShard the start plane
        and the sweep are parallel/xshard2d.py's, on the rank's block (Nx
        its columns)."""
        cfg = self.cfg
        Nlam, Nmu, Nz, Nx = cfg.Nlam, cfg.Nmu, cfg.Nz, cfg.Nx
        dt = cfg.dtype
        xs = cfg.xShard
        group = cfg.rays2d[1] if xs is None else cfg.rays2dX[1]
        start, sweep = fs2d.thermalised_start_2d, sweep_stokes_rays_2d
        if xs is not None:
            from .parallel import xshard2d
            start = partial(xshard2d.thermalised_start_xsharded, shard=xs)
            sweep = partial(xshard2d.sweep_stokes_rays_2d_xsharded, shard=xs)
        chi7m = chi7.view(Nlam, Nmu, 7, Nz, Nx).permute(0, 1, 3, 4, 2)
        S4m = S4.view(Nlam, Nmu, 4, Nz, Nx).permute(0, 1, 3, 4, 2)
        chiIm = chiI.view(Nlam, Nmu, Nz, Nx)
        if cfg.lowerThermalised:
            T2 = self.temperature.to(dt).view(Nz, Nx)
            I0 = start(chiIm[:, :, Nz - 1], chiIm[:, :, Nz - 2], T2[Nz - 1],
                       T2[Nz - 2], cfg.wavelengthT, group)
        else:
            I0 = chi7.new_zeros((Nlam, Nmu, Nx))
        Ibc = None
        if group['anyFixed']:
            Ibc = _x_inflow(cfg, self._boundary_data(), 1)
            I0 = torch.where(group['fixedNat'], Ibc[:, :, Nz - 1, None], I0)
        Iupw = torch.cat([I0[..., None], I0.new_zeros((Nlam, Nmu, Nx, 3))],
                         dim=-1)
        Ifull = sweep(chi7m, S4m, group, Iupw, Ibc=Ibc)
        self.I = Ifull[:, :, 0, :, 0]
        self.Quv = Ifull[:, :, 0, :, 1:].permute(3, 0, 1, 2)
        return IterationUpdate(self, updatedJ=False)


def _host(x: torch.Tensor) -> np.ndarray:
    """A numpy copy of tensor x on the host."""
    return x.detach().cpu().numpy().copy()
