"""The 1.5D column batch under hybrid PRD: ``ColumnBatch.from_stacked(...,
hprd=True)`` over stacked FAL-C columns with a line-of-sight velocity
ramp per column, stepped as ``ColumnBatch.iterate(prd=True)`` steps it
(formal_sol_gamma_matrices, stat_equil, then prd_redistribute's
sub-iterations), with its per-column convergence (converged columns
freeze).  The check compares ``check_columns`` columns drawn from the
seed, each against the plain PRD reference (reference/prd.py) run on
that column alone, and the sub-iterations the batch took in each
compared step."""
from pathlib import Path

import numpy as np
import torch

from lwbench.harness import check
from lwbench.harness.inputs import check_seed
from lwbench.harness.manifest import load_kind
from lwbench.harness.systems import host_state, lte_restart
from lwbench.reference import prd, problem

_BATCH = load_kind('column_batch', Path(__file__).resolve().parents[2])
check_units = _BATCH.check_units
shapes = _BATCH.shapes


def same_count(x, ref) -> float:
    """0 where the program took the reference's number of PRD
    sub-iterations, inf where it did not."""
    return 0.0 if np.array_equal(x, ref) else float('inf')


NUMBERS = {**check.MALI_NUMBERS, 'rho': check.rel_rows,
           'JRest': check.rel_rows, 'prd_subiters': same_count}
SPANS = ('prd',)


def make_inputs(config: dict, seed: int) -> dict:
    """column_batch's inputs (FAL-C columns, each column's temperature
    scaled by a uniform draw from the seed) with vlos per column a linear
    ramp in height, 0 at the bottom, up to a top velocity drawn from the
    seed, uniform(-vlos_top_m_s, vlos_top_m_s)."""
    out = _BATCH.make_inputs(config, seed)
    h = out['height']
    ramp = (h - h.min()) / (h.max() - h.min())
    rng = np.random.default_rng([check_seed(seed), 2])
    top = config['vlos_top_m_s']
    tops = rng.uniform(-top, top, config['columns'])
    out['vlos'] = tops[:, None] * ramp[None, :]
    return out


class System:
    """The hybrid-PRD batch; the check compares the columns ``units``."""

    def __init__(self, config, traffic, inputs, device, dtype, units):
        from lightweaver_tpu_torch import rh_atoms
        from lightweaver_tpu_torch.parallel import ColumnBatch
        for key in ('prd_max_subiter', 'prd_tol'):
            if traffic[key] != config[key]:
                raise ValueError(f'the traffic\'s {key} {traffic[key]} is '
                                 f'not the configuration\'s {config[key]}, '
                                 'which the reference takes')
        self.traffic = traffic
        self.b = ColumnBatch.from_stacked(
            inputs['height'], inputs['temperature'], inputs['vlos'],
            inputs['vturb'], inputs['ne'], inputs['nHTot'],
            lambda: [getattr(rh_atoms, f'{n}_atom')()
                     for n in config['atoms']],
            config['active'], Nrays=config['rays'], device=device,
            dtype=dtype, formalSolver=config['formal_solver'],
            fsIterScheme=traffic['scheme'], hprd=config['hprd'])
        Nk = self.b.NkCol
        self.checkCols = list(units)
        self.idx = torch.as_tensor(np.concatenate(
            [np.arange(c * Nk, (c + 1) * Nk) for c in self.checkCols]),
            device=self.b.cfg.device)
        self.subiters = 0

    def scatter_steps(self):
        for _ in range(self.traffic['nscatter']):
            self.b.formal_sol_gamma_matrices()

    def mali_step(self, spans) -> int:
        """One MALI step with its PRD sub-iterations; returns the columns
        that had not converged when it began."""
        b = self.b
        todo = int((~b.converged).sum())
        b.formal_sol_gamma_matrices()
        with spans.span('stat_equil'):
            b.stat_equil()
        with spans.span('prd'):
            upd = b.prd_redistribute(maxIter=self.traffic['prd_max_subiter'],
                                     tol=self.traffic['prd_tol'])
        self.subiters = upd.NprdSubIter
        newConv = ((b.dJCol < self.traffic['jtol'])
                   & (b.dPopsCol < self.traffic['popstol']) & ~b.converged)
        b.converged |= newConv
        return todo

    def all_converged(self) -> bool:
        return bool(self.b.converged.all())

    def restart(self):
        """The LTE start with rho 1 and no JRest, keeping the set-up and
        the PRD subset solve."""
        from lightweaver_tpu_torch.parallel import ColumnBatch
        old = self.b
        fc = old.flatCtx
        lte_restart(fc)
        for ai, ti, a, t in fc._prd_lines():
            fc.rhoPrd[ai][ti] = torch.ones_like(fc.rhoPrd[ai][ti])
        fc.JRest = None
        self.b = ColumnBatch(flatCtx=fc, Ncol=old.Ncol)
        for name in ('_prd_fs', '_prdSubIdxs', '_prdSubT', '_prdWindows'):
            setattr(self.b, name, getattr(old, name, None))

    def _state(self) -> dict:
        """The state at the check's points: J, the populations, each PRD
        line's rho and JRest (tensors, not copies)."""
        b = self.b
        return {'J': b.params['J'][:, self.idx],
                'pops': [p[:, self.idx] for p in b.params['pops']],
                'rho': [b.params['rhoPrd'][ai][ti][:, self.idx]
                        for ai, ti, a, t in b.flatCtx._prd_lines()],
                'JRest': b.JRest[:, self.idx]}

    def keep(self) -> dict:
        """The state the next step starts from, at the check's points."""
        st = self._state()
        return {'J': st['J'].clone(), 'pops': [p.clone() for p in st['pops']],
                'rho': [r.clone() for r in st['rho']],
                'JRest': st['JRest'].clone()}

    def units(self, kept: dict) -> list:
        """Per checked column, the kept state and the state now (with
        Gamma), each with the sub-iterations the last step took."""
        now = host_state(dict(self._state(), Gamma=[
            g[:, :, self.idx] for g in self.b._Gamma]))
        before = host_state(kept)
        count = np.array([float(self.subiters)])
        Nk = self.b.NkCol
        out = []
        for i in range(len(self.checkCols)):
            s = slice(i * Nk, (i + 1) * Nk)
            out.append(tuple(dict({k: [x[..., s] for x in v]
                                   if isinstance(v, list) else v[..., s]
                                   for k, v in st.items()},
                                  prd_subiters=count)
                             for st in (before, now)))
        return out


def reference(config, inputs, unit, units, device):
    """The PRD reference of column ``units[unit]`` alone, with the batch's
    PRD subset (the union over every column's velocities)."""
    atmos = problem.column_atmosphere(config, inputs, units[unit])
    return prd.Unit(config, atmos, inputs['vlos'], device)
