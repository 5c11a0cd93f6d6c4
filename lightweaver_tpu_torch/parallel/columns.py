"""1.5D synthesis: a batch of independent 1D columns iterated in lockstep.

Port of lightweaver_tpu/parallel/columns.py on one device.  The JAX
package flattens the C stacked [C, Nk] atmospheres into one C*Nk-point
Context for the pointwise set-up and the host-side updates, then vmaps
the single-column MALI step over the batched params.  Here the batch
iterates that flat Context itself, with the columns laid end to end
along depth (IterConfig.Ncol = C, NkCol depths each):

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

Layouts: the flat tensors put column c at depths [c NkCol, (c+1) NkCol);
the properties (pops, ne, J, I) return per-column numpy arrays [C, ...].
"""
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..atmosphere import Atmosphere
from ..atomic_set import RadiativeSet
from ..context import Context, _stat_eq_solve, build_iteration_fn
from ..iteration_update import IterationUpdate
from ..ops.ng import BatchedNg, NgOptions

_NO_MESH = ('distributing a ColumnBatch over devices (mesh=) is not ported '
            'to lightweaver_tpu_torch yet: the batch runs on one device')

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
    wavelength grid, iterated in lockstep on one device.

    Construct from stacked atmosphere arrays (:meth:`from_stacked`,
    array-native; Ng acceleration, charge conservation, PRD and hybrid
    PRD, and per-column convergence freezing) or from a list of prebuilt
    Contexts (``contexts=``; lockstep only).  ``mesh`` (distribution over
    devices) is not ported and raises ValueError.
    """

    def __init__(self, contexts: Optional[List[Context]] = None,
                 mesh=None, *, flatCtx: Optional[Context] = None,
                 Ncol: int = 0, ngOptions: Optional[NgOptions] = None):
        if mesh is not None:
            raise ValueError(_NO_MESH)
        self.flatCtx = None
        if flatCtx is not None:
            fc = flatCtx
            if Ncol < 1 or fc.atmos.Nspace % Ncol:
                raise ValueError(f'{fc.atmos.Nspace} depths do not split '
                                 f'into {Ncol} columns')
            self.flatCtx = fc
            self.Ncol = Ncol
            self.NkCol = fc.atmos.Nspace // Ncol
            fc._swap_cfg(Ncol=Ncol)
            fc._normalise_profiles()
            self.cfg = fc.cfg
            self._iter_fn = fc._iter_fn
            self.params = fc.build_params()
            ngOptions = ngOptions or NgOptions(0, 0, 0)
            self.ngs = [BatchedNg(ngOptions.Norder, ngOptions.Nperiod,
                                  ngOptions.Ndelay, self._by_column(n))
                        for n in fc._pops_on_host()]
            self.converged = np.zeros(Ncol, bool)
            self.nIterCol = np.zeros(Ncol, np.int64)
        elif contexts:
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
                                           Ncol=self.Ncol)
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
        self._Gamma = None
        self._Rij = None
        self._Rji = None
        self._I = None
        self._prd_fs = None
        self.JRest = None

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
        ``fsIterScheme``, ``hprd``, ``accelerateScattering``, ...)."""
        if mesh is not None:
            raise ValueError(_NO_MESH)
        temperature = np.asarray(temperature, np.float64)
        C, Nk = temperature.shape
        height = np.asarray(height, np.float64)
        if height.ndim == 1:
            height = np.broadcast_to(height[None, :], (C, Nk))

        def flat(a):
            return np.asarray(a, np.float64).reshape(C * Nk).copy()

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
        return cls(flatCtx=flatCtx, Ncol=C, ngOptions=ngOptions)

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
        """A flat tensor [..., Ncol NkCol] as numpy [Ncol, ..., NkCol]."""
        y = x.reshape(x.shape[:-1] + (self.Ncol, self.NkCol))
        return torch.movedim(y, -2, 0).cpu().numpy()

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
        return IterationUpdate(self, updatedJ=True, dJMax=dJ)

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
            dPops.append(float(torch.max(torch.abs(1.0 - n / nNew))))
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
        return IterationUpdate(self, updatedPops=True,
                               dPops=[float(dPopsMasked.max())])

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
            self._prdSubT = torch.as_tensor(self._prdSubIdxs, device=dev)
            self._prd_fs = build_prd_subset_fn(self.cfg, self._prdSubIdxs,
                                               prdPairs)

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
            dRho = torch.zeros(C, dtype=torch.float64, device=dev)
            for li, (ai, ti, a, t) in enumerate(prdLines):
                rOld = self.params['rhoPrd'][ai][ti]
                rNew = torch.where(frozenK[None, :], rOld,
                                   fc._scatter_rho(li))
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
            if np.max(np.where(self.converged, 0.0, dRhoCol)) < tol:
                break

        self.dRhoCol = dRhoCol
        upd = IterationUpdate(self, updatedRho=True,
                              dRho=[float(np.max(np.where(
                                  self.converged, 0.0, dRhoCol)))],
                              NprdSubIter=nSub)
        upd.updatedJ = True
        return upd

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
                self.nIterCol[newConv] = it + 1
                self.converged |= newConv
                if not quiet:
                    print(f'-- it {it}: dJ={ju.dJMax:.2e} '
                          f'dPops={pu.dPopsMax:.2e} '
                          f'converged {int(self.converged.sum())}/{self.Ncol}')
                if self.converged.all():
                    return it + 1
            else:
                if not quiet:
                    print(f'-- it {it}: dJ={ju.dJMax:.2e} '
                          f'dPops={pu.dPopsMax:.2e}')
                if ju.dJMax < JTol and pu.dPopsMax < popsTol:
                    return it + 1
        return NmaxIter

    # ------------------------------------------------------------------
    @property
    def pops(self) -> List[np.ndarray]:
        """Per active atom: populations [C, Nlevel, NkCol]."""
        return [self._per_column(p) for p in self.params['pops']]

    @property
    def J(self) -> np.ndarray:
        """Mean intensity [C, Nlam, NkCol]."""
        return self._per_column(self.params['J'])

    @property
    def I(self) -> np.ndarray:
        """Emergent intensity of the last MALI step (and PRD subset
        solves) [C, Nlam, Nmu]."""
        return self._I.cpu().numpy()

    @property
    def ne(self) -> np.ndarray:
        """Electron density [C, NkCol] (updated when conserveCharge)."""
        if self.flatCtx is None:
            raise ValueError('per-column ne needs from_stacked batches')
        return np.asarray(self.flatCtx.atmos.ne).reshape(self.Ncol, -1)
