"""The inputs of the reference's MALI step for one compared unit (one
column of a batch, or a whole slab), worked out from the run's
atmosphere arrays.

The model layer (the atmosphere, the atomic models and their LTE
populations, the background opacities, the broadening and the
collisional rates) is ``lwref``'s, the frozen copy of the port's model
modules; everything this module assembles from it, the transitions'
windows and weights, the line profiles and their normalisation, the
continua's cross-sections and the rate coefficients, is its own:

- a line's profile phi [2, W, Nmu, Nk] is the Voigt function
  H(a, v) / (sqrt(pi) vB) at v = (dlambda c / lambda0 + s vlos_mu) / vB,
  s = -1 for the down rays and +1 for the up ones; its normalisation
  1 / sum over the window, the rays and both directions of
  phi wlambda wmu / 2;
- wlambda is the trapezoid rule on the window's grid, in Doppler units
  (c / lambda0) for a line;
- Uji, Vij, Vji are the radiative rate coefficients of Lightweaver's
  Transition::uv (Osborne & Milic 2021, ApJ 917, 14): for a line
  Vij = hc / (4 pi) (lambda0 / lambda) Bij phi, Vji = gi / gj Vij (that
  is Bji / Bij Vij), Uji = Aji / Bji Vji; for a continuum Vij = alpha,
  Vji = nStar_i / nStar_j exp(-hc / (lambda k T)) alpha,
  Uji = 2 hc / lambda^3 Vji;
- the integration weight of the rates is wlambda wphi 4 pi / (hc) for a
  line, wlambda / lambda 4 pi / h for a continuum.

Every line is in complete redistribution here (crd.py drives it): a
line the atom marks PRD keeps the emission profile phi.  A kind whose
step runs PRD iterations brings its own reference beside this one.
"""
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from .lwref import atmosphere as lwAtmosphere
from .lwref import atomic_set as lwAtomicSet
from .lwref import background as lwBackground
from .lwref import constants as Const
from .lwref import rh_atoms as lwRhAtoms
from .lwref.atomic_model import AtomicLine, LineProfileState
from .lwref.ops.faddeeva import voigt_H

F64 = torch.float64


@dataclass
class Transition:
    line: bool
    i: int
    j: int
    lo: int                 # the window's rows [lo, hi) of the grid
    hi: int
    Uji: torch.Tensor       # line [2, W, Nmu, Nk]; continuum [W, Nk]
    Vij: torch.Tensor
    Vji: torch.Tensor
    wla: torch.Tensor       # [W, Nk]


@dataclass
class Atom:
    element: str
    active: bool
    Nlevel: int
    n0: torch.Tensor        # the starting (LTE) populations [Nl, Nk]
    nTotal: torch.Tensor    # [Nk]
    C: Optional[torch.Tensor]   # collisional rates [Nl, Nl, Nk] (active)
    trans: List[Transition] = field(default_factory=list)


@dataclass
class Problem:
    """One unit's grid and inputs on ``device``, float64."""
    dim: int
    Nlam: int
    Nk: int
    wavelength: torch.Tensor    # [Nlam] nm
    muz: torch.Tensor           # [Nmu], > 0
    mux: torch.Tensor           # [Nmu] (2D)
    wmu: torch.Tensor           # [Nmu]
    height: np.ndarray          # [Nk] (1D) or the z grid [Nz] (2D)
    x: Optional[np.ndarray]     # [Nx] (2D)
    temperature: torch.Tensor   # [Nk]
    bgChi: torch.Tensor         # [Nlam, Nk]
    bgEta: torch.Tensor
    bgSca: torch.Tensor
    atoms: List[Atom]
    formalSolver: str
    interp2d: Optional[str] = None

    @property
    def Nmu(self) -> int:
        return self.muz.shape[0]

    @property
    def active(self) -> List[Atom]:
        return [a for a in self.atoms if a.active]


def radiative_set(config: dict):
    """The configuration's atoms with its active species set active."""
    rs = lwAtomicSet.RadiativeSet([getattr(lwRhAtoms, f'{n}_atom')()
                                   for n in config['atoms']])
    rs.set_active(*config['active'])
    return rs


def column_atmosphere(config: dict, inputs: dict, c: int):
    atmos = lwAtmosphere.Atmosphere(
        height=np.array(inputs['height']),
        **{k: np.array(inputs[k][c]) for k in ('temperature', 'vlos',
                                               'vturb', 'ne', 'nHTot')})
    atmos.quadrature(config['rays'])
    return atmos


def slab_atmosphere(config: dict, inputs: dict):
    atmos = lwAtmosphere.Atmosphere.make_2d(
        **{k: np.array(inputs[k]) for k in ('height', 'x', 'temperature',
                                            'vx', 'vz', 'vturb', 'ne',
                                            'nHTot')})
    atmos.quadrature(config['quadrature'])
    return atmos


def trapezoid(grid: np.ndarray) -> np.ndarray:
    """Trapezoid-rule weights of the points of ``grid``."""
    edges = np.concatenate([[grid[0]], 0.5 * (grid[1:] + grid[:-1]),
                            [grid[-1]]])
    return np.diff(edges)


def _profile(line, atmos, eqPops, lam, dev):
    """phi [2, W, Nmu, Nk] of ``line`` on its window ``lam``."""
    vlosMu = torch.as_tensor(atmos.vlos_mu(), dtype=F64, device=dev)
    dv = torch.as_tensor((lam - line.lambda0) * Const.CLight / line.lambda0,
                         dtype=F64, device=dev)
    sign = torch.tensor([-1.0, 1.0], dtype=F64, device=dev)

    def voigt(aDamp, vB):
        a = torch.as_tensor(np.asarray(aDamp), dtype=F64, device=dev)
        vB = torch.as_tensor(np.asarray(vB), dtype=F64, device=dev)
        v = (dv[None, :, None, None]
             + sign[:, None, None, None] * vlosMu[None, None]) / vB
        return voigt_H(a.expand_as(v), v) / (Const.SqrtPi * vB)

    res = line.compute_phi(LineProfileState(
        wavelength=lam, vlosMu=atmos.vlos_mu(), atmos=atmos, eqPops=eqPops,
        default_voigt_callback=voigt,
        vBroad=np.asarray(line.atom.vBroad(atmos))))
    return torch.as_tensor(res.phi, dtype=F64, device=dev)


def _transition(t, spect, atmos, eqPops, st, wmu, T, dev):
    ident = t.transId
    lo, hi = spect.blueIdx[ident], spect.redIdx[ident]
    lam = np.asarray(spect.wavelength[lo:hi])
    lamT = torch.as_tensor(lam, dtype=F64, device=dev)
    if isinstance(t, AtomicLine):
        phi = _profile(t, atmos, eqPops, lam, dev)
        wl = torch.as_tensor(trapezoid(lam) * Const.CLight / t.lambda0,
                             dtype=F64, device=dev)
        norm = (phi * wl[None, :, None, None]
                * (0.5 * wmu)[None, None, :, None]).sum(dim=(0, 1, 2))
        Vij = (Const.HC_FOURPI * t.lambda0 / lamT)[None, :, None, None] \
            * t.Bij * phi
        Vji = (t.Bji / t.Bij) * Vij
        Uji = (t.Aji / t.Bji) * Vji
        wla = wl[:, None] * (Const.FOURPI_HC / norm)[None, :]
    else:
        alpha = torch.as_tensor(t.alpha(lam), dtype=F64, device=dev)
        nStar = torch.as_tensor(st.nStar, dtype=F64, device=dev)
        gij = (nStar[t.i] / nStar[t.j])[None, :] * torch.exp(
            -Const.HC_K / lamT[:, None] / T[None, :])
        Vij = alpha[:, None].expand(len(lam), T.shape[0])
        Vji = gij * alpha[:, None]
        Uji = (Const.TwoHC / lamT ** 3)[:, None] * Vji
        wl = torch.as_tensor(trapezoid(lam), dtype=F64, device=dev)
        wla = (wl / lamT * Const.FOURPI_H)[:, None].expand(len(lam),
                                                           T.shape[0])
    return Transition(line=isinstance(t, AtomicLine), i=t.i, j=t.j, lo=lo,
                      hi=hi, Uji=Uji, Vij=Vij, Vji=Vji, wla=wla)


def build(config: dict, atmos, device) -> Problem:
    """The Problem of ``atmos`` under ``config``."""
    dev = torch.device(device)
    rs = radiative_set(config)
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    bg = lwBackground.basic_background(spect, atmos, eqPops, rs)

    def t_(x):
        return torch.as_tensor(np.asarray(x), dtype=F64, device=dev)
    T = t_(atmos.temperature)
    wmu = t_(atmos.wmu)
    atoms = []
    models = ([(m, True) for m in rs.activeAtoms]
              + [(m, False) for m in rs.detailedAtoms])
    for model, active in sorted(models, key=lambda ma: (not ma[1],
                                                        ma[0].element)):
        st = eqPops.atomicPops[model.element]
        Nl = len(model.levels)
        C = None
        if active:
            Cnp = np.zeros((Nl, Nl, atmos.Nspace))
            for col in model.collisions:
                col.compute_rates(atmos, eqPops, Cnp)
            C = t_(np.clip(Cnp, 0.0, None))
        trans = [_transition(t, spect, atmos, eqPops, st, wmu, T, dev)
                 for t in model.transitions if t.transId in spect.blueIdx]
        atoms.append(Atom(element=str(model.element), active=active,
                          Nlevel=Nl, n0=t_(st.n), nTotal=t_(st.nTotal),
                          C=C, trans=trans))
    twoD = atmos.Ndim == 2
    return Problem(
        dim=atmos.Ndim, Nlam=spect.Nspect, Nk=atmos.Nspace,
        wavelength=t_(spect.wavelength), muz=t_(atmos.muz),
        mux=t_(atmos.mux), wmu=wmu,
        height=np.asarray(atmos.zGrid if twoD else atmos.height,
                          np.float64),
        x=np.asarray(atmos.x, np.float64) if twoD else None,
        temperature=T, bgChi=t_(bg.chi), bgEta=t_(bg.eta),
        bgSca=t_(bg.sca), atoms=atoms,
        formalSolver=config['formal_solver'],
        interp2d=config.get('interp_2d'))


def wavelength_count(config: dict) -> int:
    """The length of the configuration's wavelength grid."""
    return len(radiative_set(config).compute_wavelength_grid().wavelength)
