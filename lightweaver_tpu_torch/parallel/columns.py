"""1.5D synthesis: a batch of independent 1D columns iterated in lockstep,
on one device or over a ('columns', 'wavelength') mesh of ranks.

Port of lightweaver_tpu/parallel/columns.py.  The JAX package flattens
the C stacked [C, Nk] atmospheres into one C*Nk-point Context for the
pointwise set-up and the host-side updates, then vmaps the single-column
MALI step over the batched params.  Here the batch iterates that flat
Context itself, with the columns laid end to end along depth
(IterConfig.Ncol = C, NkCol depths each):

- every pointwise stage (the gather, the line Gamma kernel, gamma_rates,
  the statistical-equilibrium solve, Newton-Raphson charge conservation,
  rest_frame_J, prd_scatter_rho) runs unchanged over the C*NkCol depths;
- the parts that follow depth order are column-aware (context.py:
  _upwind_columns, _boundary, _emergent, _dJ): each column has its own
  height, boundaries and emergent point, and the sweep and fused kernels
  take every column in one launch (grid rows x columns).

So one MALI step of the batch launches each kernel once, whatever C is,
and pays the host cost of a step once for C columns.  Per-column Ng
(BatchedNg) and per-column convergence freezing ride on top, as in the
JAX package.

Over a mesh (make_mesh, one process per rank): each rank takes its
contiguous block of C / pColumns columns (its coordinate on 'columns')
and builds its flat Context on those alone; with pWavelength > 1 ranks on
'wavelength' each iterates its block of wavelength rows (IterConfig.
lamLo/lamHi: context.py:wavelength_block), and one all_reduce over the
'wavelength' group per MALI step completes Gamma and the rates (and
hybrid PRD's JRest); prd_redistribute gathers J's rows of the PRD line
windows over the group (rho of a row reads its line's whole window),
solves the PRD subset rows of the rank's block and sums their rates in
one all_reduce (context.py:build_prd_subset_fn).  The
collectives on 'columns' are the reductions that keep every rank in
lockstep: MAX of dJ, of the masked dPops and of drho, MIN of the
convergence flag (every rank leaves iterate in the same step), and the
all_gathers that the properties read.

Layouts: the flat tensors put column c at depths [c NkCol, (c+1) NkCol);
the properties (pops, ne, J, I, nIterCol) return per-column numpy arrays
[C, ...] of all C columns, on every rank.
"""
import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..atmosphere import Atmosphere
from ..atomic_set import RadiativeSet
from ..context import (Context, _stat_eq_solve, build_iteration_fn,
                       lambda_block)
from ..iteration_update import IterationUpdate
from ..ops.collectives import all_gather_cat, all_reduce
from ..ops.ng import BatchedNg, NgOptions
from .multihost import rank_device

MESH_DIMS = ('columns', 'wavelength')


def make_mesh(nColumns: Optional[int] = None, nWavelength: int = 1,
              devices=None, device='cuda'):
    """A ('columns', 'wavelength') torch DeviceMesh over the ranks
    ``devices`` (default: every rank of the default process group, which
    initialize_multihost starts), on each rank's card unless
    device='cpu'.  nColumns defaults to every rank the wavelength axis
    does not take; nColumns x nWavelength != the rank count raises
    ValueError, as in the JAX package."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise ValueError('make_mesh needs a torch.distributed process group '
                         '(parallel.multihost.initialize_multihost)')
    ranks = (list(range(dist.get_world_size())) if devices is None
             else list(devices))
    n = len(ranks)
    if nColumns is None:
        nColumns = n // nWavelength
    if nColumns * nWavelength != n:
        raise ValueError(f'{nColumns} x {nWavelength} != {n} ranks')
    device = rank_device(device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    return DeviceMesh(device.type,
                      torch.tensor(ranks).reshape(nColumns, nWavelength),
                      mesh_dim_names=MESH_DIMS)


class _MeshPlace:
    """This rank's place on a ('columns', 'wavelength') mesh: its
    coordinate, the axis size and the group of each axis."""

    def __init__(self, mesh):
        names = tuple(getattr(mesh, 'mesh_dim_names', None) or ())
        if names != MESH_DIMS:
            raise ValueError(f'mesh= takes a DeviceMesh with dimensions '
                             f'{MESH_DIMS} (make_mesh), got {mesh!r}')
        self.col, self.lam = (mesh.get_local_rank(d) for d in MESH_DIMS)
        self.nCol, self.nLam = mesh.size(0), mesh.size(1)
        self.colGroup, self.lamGroup = (mesh.get_group(d) for d in MESH_DIMS)

    def columns(self, C: int) -> slice:
        """This rank's block of C columns."""
        if C % self.nCol:
            raise ValueError(f'{C} columns do not split evenly over the '
                             f'{self.nCol} ranks of the columns axis')
        per = C // self.nCol
        return slice(self.col * per, (self.col + 1) * per)

    def lam_fields(self, Nlam: int):
        """The IterConfig fields of this rank's wavelength block (none
        with a single rank on the axis)."""
        if self.nLam == 1:
            return {}
        lo, hi = lambda_block(Nlam, self.lam, self.nLam)
        return {'lamLo': lo, 'lamHi': hi, 'lamGroup': self.lamGroup}

    def lam_sizes(self, Nlam: int):
        """Every rank's count of wavelength rows on the axis."""
        return [hi - lo for lo, hi in (lambda_block(Nlam, r, self.nLam)
                                       for r in range(self.nLam))]


# params leaves that carry depth on their last axis (nested lists too)
_DEPTH_KEYS = ('J', 'bgChi', 'bgEta', 'bgSca', 'temperature', 'height',
               'pops', 'nStar', 'detPops', 'detNStar', 'C', 'phi', 'wphi',
               'rhoPrd', 'vlosMu', 'hprdI0', 'hprdFrac')


def _cat_depth(xs):
    """Concatenate one params leaf of several Contexts along depth
    (tensors on their last axis, nested lists element by element)."""
    if xs[0] is None:
        return None
    if isinstance(xs[0], list):
        return [_cat_depth(list(ys)) for ys in zip(*xs)]
    return torch.cat(xs, dim=-1)


class ColumnBatch:
    """A batch of independent 1D problems sharing the same models and
    wavelength grid, iterated in lockstep on one device, or over the
    ranks of ``mesh`` (a ('columns', 'wavelength') DeviceMesh, make_mesh).

    Construct from stacked atmosphere arrays (:meth:`from_stacked`,
    array-native; Ng acceleration, charge conservation, PRD and hybrid
    PRD, and per-column convergence freezing) or from a list of prebuilt
    Contexts (``contexts=``; lockstep only).  Over a mesh each rank keeps
    its block of the columns (of the stacked arrays, or of the contexts
    list), and each rank of the 'wavelength' axis its block of the rows:
    every option runs there too (prd_redistribute: rho from J's window
    rows gathered over the axis, the subset solve on the block's PRD rows
    with its rates and JRest summed over the axis; hybrid PRD: JRest
    summed over the axis).  ``converged``, ``dJCol`` and ``dPopsCol`` are
    the rank's columns'.
    """

    def __init__(self, contexts: Optional[List[Context]] = None,
                 mesh=None, *, flatCtx: Optional[Context] = None,
                 Ncol: int = 0, ngOptions: Optional[NgOptions] = None):
        self.mesh = mesh
        self._place = None if mesh is None else _MeshPlace(mesh)
        self.flatCtx = None
        if flatCtx is not None:
            fc = flatCtx
            if Ncol < 1 or fc.atmos.Nspace % Ncol:
                raise ValueError(f'{fc.atmos.Nspace} depths do not split '
                                 f'into {Ncol} columns')
            self.flatCtx = fc
            self.Ncol = Ncol
            self.NkCol = fc.atmos.Nspace // Ncol
            fc._swap_cfg(Ncol=Ncol, **self._lam_fields(fc.cfg))
            fc._normalise_profiles()
            self.cfg = fc.cfg
            self._iter_fn = fc._iter_fn
            self.params = fc.build_params()
            ngOptions = ngOptions or NgOptions(0, 0, 0)
            self.ngs = [BatchedNg(ngOptions.Norder, ngOptions.Nperiod,
                                  ngOptions.Ndelay, self._by_column(n))
                        for n in fc._pops_on_host()]
            self.converged = np.zeros(Ncol, bool)
            self._nIterCol = np.zeros(Ncol, np.int64)
        elif contexts:
            if self._place is not None:
                contexts = contexts[self._place.columns(len(contexts))]
            self.contexts = contexts
            c0 = contexts[0].cfg
            for c in contexts[1:]:
                if (c.cfg.Nk, c.cfg.Nlam, c.cfg.Nmu) != (c0.Nk, c0.Nlam,
                                                         c0.Nmu):
                    raise ValueError('the contexts of a batch need the same '
                                     'depths, wavelengths and rays')
            self.Ncol = len(contexts)
            self.NkCol = c0.Nk
            self.cfg = dataclasses.replace(c0, Nk=self.Ncol * c0.Nk,
                                           Ncol=self.Ncol,
                                           **self._lam_fields(c0))
            self._iter_fn = build_iteration_fn(self.cfg)
            paramsList = [c.build_params(pack=False) for c in contexts]
            self.params = dict(paramsList[0])
            for key in _DEPTH_KEYS:
                self.params[key] = _cat_depth([p.get(key)
                                               for p in paramsList])
            for key in ('upperBcData', 'lowerBcData'):
                if self.params.get(key) is not None:
                    self.params[key] = torch.stack(
                        [p[key] for p in paramsList], dim=-1)
            self.params['pack'] = self._iter_fn.pack(self.params)
            self._nTotal = [torch.cat([
                self.cfg.state(c.eqPops.atomicPops[a.model.element].nTotal)
                for c in contexts]) for a in self.cfg.activeAtoms]
        else:
            raise ValueError('Need contexts or a flat context')
        if self.cfg.lamGroup is not None:
            # J is carried on this rank's wavelength rows
            self.params['J'] = self.params['J'][self.cfg.lamLo:
                                                self.cfg.lamHi]
        self._Gamma = None
        self._Rij = None
        self._Rji = None
        self._I = None
        self._prd_fs = None
        self._prdWindows = None
        self.JRest = None

    def _lam_fields(self, cfg):
        """The IterConfig fields of this rank's wavelength block."""
        if self._place is None:
            return {}
        return self._place.lam_fields(cfg.Nlam)

    # ------------------------------------------------------------------
    @classmethod
    def from_stacked(cls, height, temperature, vlos, vturb, ne, nHTot,
                     models, activeSpecies, Nrays: int = 5, mesh=None,
                     ngOptions: Optional[NgOptions] = None,
                     conserveCharge: bool = False,
                     **ctxKwargs) -> 'ColumnBatch':
        """Array-native batch construction from stacked [C, Nk] arrays
        (height may be shared [Nk]).  ``models`` is a zero-argument
        factory returning the list of AtomicModels (fresh per call);
        ``activeSpecies`` the names to set active.  ``ctxKwargs`` go to
        the flat Context (``device``, the card unless 'cpu'; ``dtype``,
        ``fsIterScheme``, ``hprd``, ``accelerateScattering``, ...).  With
        ``mesh`` the arrays are the global ones: each rank builds its
        flat Context on its block of the columns alone, on its card
        (multihost.rank_device) unless device='cpu'."""
        temperature = np.asarray(temperature, np.float64)
        C, Nk = temperature.shape
        height = np.asarray(height, np.float64)
        if height.ndim == 1:
            height = np.broadcast_to(height[None, :], (C, Nk))
        cols = slice(0, C)
        if mesh is not None:
            cols = _MeshPlace(mesh).columns(C)
            ctxKwargs['device'] = rank_device(ctxKwargs.get('device', 'cuda'))
        C = cols.stop - cols.start

        def flat(a):
            a = np.broadcast_to(np.asarray(a, np.float64), temperature.shape)
            return a[cols].reshape(C * Nk).copy()

        atmos = Atmosphere(height=flat(height), temperature=flat(temperature),
                           vlos=flat(vlos), vturb=flat(vturb),
                           ne=flat(ne), nHTot=flat(nHTot))
        atmos.quadrature(Nrays)
        rs = RadiativeSet(models())
        rs.set_active(*activeSpecies)
        spect = rs.compute_wavelength_grid()
        eqPops = rs.compute_eq_pops(atmos)
        # Ng runs per column in the batch, not in the flat context
        flatCtx = Context(atmos, spect, eqPops,
                          conserveCharge=conserveCharge, **ctxKwargs)
        return cls(mesh=mesh, flatCtx=flatCtx, Ncol=C, ngOptions=ngOptions)

    # ------------------------------------------------------------------
    def _by_column(self, x):
        """A flat [..., Ncol NkCol] array -> [Ncol, prod(...) NkCol], each
        column's values in the order of the JAX batch's leaves."""
        x = np.asarray(x)
        y = x.reshape(x.shape[:-1] + (self.Ncol, self.NkCol))
        return np.moveaxis(y, -2, 0).reshape(self.Ncol, -1)

    def _from_columns(self, y, lead):
        """Inverse of _by_column: [Ncol, prod(lead) NkCol] -> lead +
        [Ncol NkCol]."""
        y = np.asarray(y).reshape((self.Ncol,) + tuple(lead) + (self.NkCol,))
        return np.moveaxis(y, 0, -2).reshape(tuple(lead)
                                             + (self.Ncol * self.NkCol,))

    def _per_column(self, x):
        """A flat tensor [..., Ncol NkCol] as [Ncol, ..., NkCol]."""
        y = x.reshape(x.shape[:-1] + (self.Ncol, self.NkCol))
        return torch.movedim(y, -2, 0)

    def _frozen_depths(self):
        """[Ncol NkCol] bool tensor, True on the converged columns."""
        return torch.as_tensor(np.repeat(self.converged, self.NkCol),
                               device=self.cfg.device)

    # ------------------------------------------------------------------
    def formal_sol_gamma_matrices(self, lambdaIterate: bool = False) \
            -> IterationUpdate:
        """One MALI step of every column (one launch of each kernel of the
        scheme); converged columns keep their J (and JRest).  dJMax is the
        largest of the unconverged columns' dJCol [C]."""
        out = self._iter_fn(self.params, lambdaIterate=lambdaIterate)
        if self.flatCtx is not None and self.converged.any():
            frozen = self._frozen_depths()[None, :]
            self.params['J'] = torch.where(frozen, self.params['J'],
                                           out['J'])
            if 'JRest' in out:
                self.JRest = (out['JRest'] if self.JRest is None else
                              torch.where(frozen, self.JRest, out['JRest']))
        else:
            self.params['J'] = out['J']
            if 'JRest' in out:
                self.JRest = out['JRest']
        self._Gamma = out['Gamma']
        self._Rij = out['Rij']
        self._Rji = out['Rji']
        self._I = out['I']
        self.dJCol = out['dJ'].cpu().numpy()               # [C]
        if self.flatCtx is not None:
            dJ = float(np.max(np.where(self.converged, 0.0, self.dJCol)))
        else:
            dJ = float(self.dJCol.max())
        return IterationUpdate(self, updatedJ=True,
                               dJMax=self._col_reduce(dJ, 'max'))

    def stat_equil(self) -> IterationUpdate:
        """Statistical equilibrium of every column (the flat Context's,
        with its charge conservation, for from_stacked batches)."""
        if self._Gamma is None:
            raise ValueError('Call formal_sol_gamma_matrices first')
        if self.flatCtx is not None:
            return self._stat_equil_flat()
        dPops = []
        for ai in range(len(self.cfg.activeAtoms)):
            n = self.params['pops'][ai]
            nNew = _stat_eq_solve(self._Gamma[ai], n, self._nTotal[ai])
            dPops.append(self._col_reduce(
                float(torch.max(torch.abs(1.0 - n / nNew))), 'max'))
            self.params['pops'][ai] = nNew
        return IterationUpdate(self, updatedPops=True, dPops=dPops)

    def _push_state(self):
        """Hand the batch's J, JRest, Gamma, rates and populations to the
        flat Context, whose pointwise updates then cover every column."""
        fc = self.flatCtx
        fc.J = self.params['J']
        fc.JRest = self.JRest
        fc._Gamma, fc._Rij, fc._Rji = self._Gamma, self._Rij, self._Rji
        for ai, st in enumerate(fc.popsState):
            st['n'] = self.params['pops'][ai]

    def _stat_equil_flat(self) -> IterationUpdate:
        """Statistical equilibrium (and, with conserveCharge, the
        Newton-Raphson step) through the flat Context, every update being
        pointwise in depth; then per-column Ng with the converged columns
        frozen, and their ne restored."""
        fc = self.flatCtx
        C = self.Ncol
        self._push_state()
        if fc.conserveCharge:
            neOld = np.asarray(fc.atmos.ne).copy()
            fc.stat_equil()
            if self.converged.any():
                # restore converged columns' ne and what depends on it
                neNew = np.asarray(fc.atmos.ne).reshape(C, -1).copy()
                neNew[self.converged] = neOld.reshape(C, -1)[self.converged]
                fc.atmos.ne[:] = neNew.reshape(-1)
                fc.eqPops.update_lte_atoms_Hmin_pops(fc.atmos,
                                                     conserveCharge=False)
                fc._refresh_nstar()
                fc.compute_collisions(force=True)
        else:
            fc.stat_equil()

        dPops = []
        frozen = self.converged
        for ai, nHost in enumerate(fc._pops_on_host()):
            _, sol = self.ngs[ai].accelerate(self._by_column(nHost),
                                             freeze=frozen)
            dPops.append(self.ngs[ai].max_change())          # [C]
            n = self.cfg.state(self._from_columns(sol, nHost.shape[:-1]))
            self.params['pops'][ai] = n
            fc.popsState[ai]['n'] = n

        if fc.conserveCharge:
            # NR moved nStar and the collisional rates
            self.params['nStar'] = [st['nStar'] for st in fc.popsState]
            self.params['detNStar'] = [st['nStar'] for st in fc.detailedPops]
            self.params['C'] = fc._deviceC()

        self.dPopsCol = np.max(np.stack(dPops, axis=0), axis=0)     # [C]
        dPopsMasked = np.where(frozen, 0.0, self.dPopsCol)
        return IterationUpdate(self, updatedPops=True, dPops=[
            self._col_reduce(float(dPopsMasked.max()), 'max')])

    @property
    def crswDone(self):
        return True

    # ------------------------------------------------------------------
    def prd_redistribute(self, maxIter: int = 3,
                         tol: float = 1e-2) -> IterationUpdate:
        """Batched PRD redistribution (angle-averaged PRD and, with the
        flat Context's hprd, hybrid PRD): each PRD line's rho from the
        flat Context's scattering integral (ops/prd.py, pointwise in
        depth), then the PRD-subset formal solution of every column in one
        sweep launch, until the unconverged columns' drho < tol or
        maxIter.  Converged columns keep their rho, J, JRest, I and PRD
        rates.
        ref schedule: Source/PrdTemplates.hpp:176-351"""
        from ..context import build_prd_subset_fn

        fc = self.flatCtx
        if fc is None:
            raise ValueError('PRD needs from_stacked batches')
        prdLines = fc._prd_lines()
        if not prdLines:
            return IterationUpdate(self)
        if self._Rij is None:
            raise ValueError('Call formal_sol_gamma_matrices first')
        C, Nc = self.Ncol, self.NkCol
        dev = self.cfg.device

        if self._prd_fs is None:
            prdPairs = [(ai, ti) for ai, ti, a, t in prdLines]
            self._prdSubIdxs = fc._prd_subset_idxs()
            self._prd_fs = build_prd_subset_fn(self.cfg, self._prdSubIdxs,
                                               prdPairs)
            # the rows of J and I that the subset solve refreshes (its rows
            # of this rank's wavelength block)
            self._prdSubT = torch.as_tensor(
                self._prd_fs.rows - self.cfg.lamLo, device=dev)
            self._prdWindows = self._prd_window_plan(prdLines)

        frozenK = self._frozen_depths()
        frozenC = torch.as_tensor(self.converged, device=dev)
        subT = self._prdSubT
        self._Rij = [list(r) for r in self._Rij]
        self._Rji = [list(r) for r in self._Rji]
        dRhoCol = np.zeros(C)
        nSub = 0
        for _ in range(maxIter):
            nSub += 1
            self._push_state()
            Jw = self._prd_window_J()
            dRho = torch.zeros(C, dtype=torch.float64, device=dev)
            for li, (ai, ti, a, t) in enumerate(prdLines):
                rOld = self.params['rhoPrd'][ai][ti]
                rNew = torch.where(frozenK[None, :], rOld, fc._scatter_rho(
                    li, None if Jw is None else Jw[li]))
                rel = torch.abs(torch.where(rNew != 0.0,
                                            (rNew - rOld) / rNew, 0.0))
                dRho = torch.maximum(dRho, torch.amax(
                    rel.view(-1, C, Nc), dim=(0, 2)))
                # params['rhoPrd'] is the flat Context's rhoPrd
                self.params['rhoPrd'][ai][ti] = rNew

            out = self._prd_fs(self.params)
            Jsub = self.params['J'][subT]
            self.params['J'] = self.params['J'].index_copy(
                0, subT, torch.where(frozenK[None, :], Jsub,
                                     out['J'].to(Jsub.dtype)))
            if 'JRest' in out and self.JRest is not None:
                self.JRest = torch.where(frozenK[None, :], self.JRest,
                                         out['JRest'])
            Isub = self._I[:, subT]
            self._I = self._I.index_copy(1, subT, torch.where(
                frozenC[:, None, None], Isub, out['I'].to(Isub.dtype)))
            for li, (ai, ti, a, t) in enumerate(prdLines):
                self._Rij[ai][ti] = torch.where(frozenK, self._Rij[ai][ti],
                                                out['Rij'][li])
                self._Rji[ai][ti] = torch.where(frozenK, self._Rji[ai][ti],
                                                out['Rji'][li])
            dRhoCol = dRho.cpu().numpy()
            dRhoMax = self._col_reduce(self._reduce(
                float(np.max(np.where(self.converged, 0.0, dRhoCol))),
                'max', self.cfg.lamGroup), 'max')
            if dRhoMax < tol:
                break

        self.dRhoCol = dRhoCol
        upd = IterationUpdate(self, updatedRho=True, dRho=[dRhoMax],
                              NprdSubIter=nSub)
        upd.updatedJ = True
        return upd

    def _prd_window_plan(self, prdLines):
        """On a rank of the 'wavelength' axis, the plan of _prd_window_J:
        the union U of the PRD lines' window rows, this rank's rows of U
        (as rows of its block), every rank's count of them and each line's
        first position in U; None without a wavelength group."""
        cfg = self.cfg
        if cfg.lamGroup is None:
            return None
        active = np.zeros(cfg.Nlam, bool)
        for ai, ti, a, t in prdLines:
            active[t.Nblue:t.Nred] = True
        U = np.nonzero(active)[0]
        own = U[(U >= cfg.lamLo) & (U < cfg.lamHi)] - cfg.lamLo
        sizes = [int(np.count_nonzero((U >= lo) & (U < hi)))
                 for lo, hi in (lambda_block(cfg.Nlam, r, self._place.nLam)
                                for r in range(self._place.nLam))]
        starts = [(int(np.searchsorted(U, t.Nblue)), t.W)
                  for ai, ti, a, t in prdLines]
        return torch.as_tensor(own, device=cfg.device), sizes, starts

    def _prd_window_J(self):
        """Per PRD line the J [W, Nk] of its window, which its scattering
        integral reads: on a rank of the 'wavelength' axis J's rows of
        every PRD window, gathered over the axis in one all_gather (each
        rank its rows of their union); None where the flat Context's own
        J or JRest serves (no wavelength group, or hybrid PRD once JRest,
        whole on every rank, exists)."""
        if self._prdWindows is None or (self.cfg.hprd
                                        and self.JRest is not None):
            return None
        own, sizes, starts = self._prdWindows
        JU = all_gather_cat(self.params['J'][own], self.cfg.lamGroup, 0,
                            sizes)
        return [JU[s0:s0 + W] for s0, W in starts]

    def iterate(self, Nscatter: int = 3, NmaxIter: int = 500,
                JTol: float = 5e-3, popsTol: float = 1e-3,
                quiet: bool = True, prd: bool = False,
                maxPrdSubIter: int = 3, prdTol: float = 1e-2) -> int:
        """Iterate the batch until every column converges; converged
        columns are frozen (per-column masking) while the rest finish.
        Returns the iteration count of the slowest column; per-column
        counts in ``nIterCol``."""
        for it in range(NmaxIter):
            ju = self.formal_sol_gamma_matrices()
            if it < Nscatter:
                continue
            pu = self.stat_equil()
            if prd:
                self.prd_redistribute(maxIter=maxPrdSubIter, tol=prdTol)
            if self.flatCtx is not None:
                newConv = ((self.dJCol < JTol) & (self.dPopsCol < popsTol)
                           & ~self.converged)
                self._nIterCol[newConv] = it + 1
                self.converged |= newConv
                if not quiet:
                    print(f'-- it {it}: dJ={ju.dJMax:.2e} '
                          f'dPops={pu.dPopsMax:.2e} '
                          f'converged {int(self.converged.sum())}/{self.Ncol}')
                # every rank leaves in the same step
                if self._col_reduce(float(self.converged.all()), 'min'):
                    return it + 1
            else:
                if not quiet:
                    print(f'-- it {it}: dJ={ju.dJMax:.2e} '
                          f'dPops={pu.dPopsMax:.2e}')
                if ju.dJMax < JTol and pu.dPopsMax < popsTol:
                    return it + 1
        return NmaxIter

    # ------------------------------------------------------------------
    def _reduce(self, x: float, op: str, group) -> float:
        """x reduced over the ranks of ``group`` (x itself without one)."""
        if group is None:
            return x
        t = torch.tensor([x], dtype=torch.float64, device=self.cfg.device)
        return float(all_reduce(t, group, op)[0])

    def _col_reduce(self, x: float, op: str) -> float:
        """x reduced over the 'columns' axis of the mesh (x itself on one
        device)."""
        return self._reduce(x, op, None if self._place is None
                            else self._place.colGroup)

    def _columns_numpy(self, x: torch.Tensor) -> np.ndarray:
        """[Ncol, ...] of this rank's columns as numpy [C, ...] of all C
        columns (an all_gather over the 'columns' axis)."""
        if self._place is not None:
            x = all_gather_cat(x.to(self.cfg.device), self._place.colGroup)
        return x.cpu().numpy()

    def _lam_rows(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """x with this rank's wavelength rows on ``dim`` as the whole grid's
        (an all_gather over the 'wavelength' axis)."""
        if self.cfg.lamGroup is None:
            return x
        return all_gather_cat(x, self.cfg.lamGroup, dim,
                              self._place.lam_sizes(self.cfg.Nlam))

    @property
    def nIterCol(self) -> np.ndarray:
        """The step in which each column converged (0: not yet) [C]."""
        if self._place is None:
            return self._nIterCol
        return self._columns_numpy(torch.as_tensor(self._nIterCol))

    @property
    def pops(self) -> List[np.ndarray]:
        """Per active atom: populations [C, Nlevel, NkCol]."""
        return [self._columns_numpy(self._per_column(p))
                for p in self.params['pops']]

    @property
    def J(self) -> np.ndarray:
        """Mean intensity [C, Nlam, NkCol]."""
        return self._columns_numpy(
            self._per_column(self._lam_rows(self.params['J'], 0)))

    @property
    def I(self) -> np.ndarray:
        """Emergent intensity of the last MALI step (and PRD subset
        solves): [C, Nlam, Nmu] ([Nlam, Nmu] for one column on one
        device)."""
        I = self._I
        if self._place is None:
            return I.cpu().numpy()
        if self.cfg.Ncol == 1:
            I = I[None]
        return self._columns_numpy(self._lam_rows(I, 1))

    @property
    def ne(self) -> np.ndarray:
        """Electron density [C, NkCol] (updated when conserveCharge)."""
        if self.flatCtx is None:
            raise ValueError('per-column ne needs from_stacked batches')
        ne = np.asarray(self.flatCtx.atmos.ne).reshape(self.Ncol, -1)
        if self._place is None:
            return ne
        return self._columns_numpy(torch.as_tensor(ne))
