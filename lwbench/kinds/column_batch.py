"""The 1.5D column batch: ``ColumnBatch.from_stacked`` over stacked FAL-C
columns, with ColumnBatch.iterate's per-column convergence (converged
columns freeze).  The check compares ``check_columns`` columns drawn from
the seed, each against the reference run on that column alone."""
import numpy as np
import torch

from lwbench.harness import check
from lwbench.harness.inputs import check_seed, falc_depth_count, falc_depths
from lwbench.harness.systems import host_state, lte_restart
from lwbench.reference import crd, problem

NUMBERS = check.MALI_NUMBERS
SPANS = ()


def make_inputs(config: dict, seed: int) -> dict:
    """``columns`` FAL-C columns of ``depths`` depths, each column's
    temperature scaled by uniform(1 - spread, 1 + spread) drawn from the
    seed, vlos zero: the arithmetic of problems.stacked_falc.  height
    [Nk], the other fields [C, Nk]."""
    f = falc_depths(config['depths'])
    C, Nk = config['columns'], len(f['height'])
    spread = config['temperature_spread']
    rng = np.random.default_rng(check_seed(seed))
    scale = rng.uniform(1.0 - spread, 1.0 + spread, (C, 1))

    def rep(a):
        return np.broadcast_to(a, (C, Nk)).copy()
    return {'height': f['height'], 'temperature': f['temperature'][None, :]
            * scale, 'vlos': np.zeros((C, Nk)), 'vturb': rep(f['vturb']),
            'ne': rep(f['ne']), 'nHTot': rep(f['nHTot'])}


def check_units(config: dict, settings: dict, seed: int) -> list:
    """The batch's columns the check compares, drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    return sorted(int(c) for c in rng.choice(
        config['columns'], settings['check_columns'], replace=False))


def shapes(config: dict) -> dict:
    """Nlam (the wavelength grid by the reference's own model layer), Nmu
    (rays per direction) and Nk (columns x depths)."""
    return {'Nlam': problem.wavelength_count(config), 'Nmu': config['rays'],
            'Nk': config['columns'] * falc_depth_count(config['depths'])}


class System:
    """The batch; the check compares the columns ``units``."""

    def __init__(self, config, traffic, inputs, device, dtype, units):
        from lightweaver_tpu_torch import rh_atoms
        from lightweaver_tpu_torch.parallel import ColumnBatch
        self.traffic = traffic
        self.b = ColumnBatch.from_stacked(
            inputs['height'], inputs['temperature'], inputs['vlos'],
            inputs['vturb'], inputs['ne'], inputs['nHTot'],
            lambda: [getattr(rh_atoms, f'{n}_atom')()
                     for n in config['atoms']],
            config['active'], Nrays=config['rays'], device=device,
            dtype=dtype, formalSolver=config['formal_solver'],
            fsIterScheme=traffic['scheme'])
        Nk = self.b.NkCol
        self.checkCols = list(units)
        self.idx = torch.as_tensor(np.concatenate(
            [np.arange(c * Nk, (c + 1) * Nk) for c in self.checkCols]),
            device=self.b.cfg.device)

    def scatter_steps(self):
        for _ in range(self.traffic['nscatter']):
            self.b.formal_sol_gamma_matrices()

    def mali_step(self, spans) -> int:
        """One MALI step; returns the columns that had not converged when
        it began."""
        b = self.b
        todo = int((~b.converged).sum())
        b.formal_sol_gamma_matrices()
        with spans.span('stat_equil'):
            b.stat_equil()
        newConv = ((b.dJCol < self.traffic['jtol'])
                   & (b.dPopsCol < self.traffic['popstol']) & ~b.converged)
        b.converged |= newConv
        return todo

    def all_converged(self) -> bool:
        return bool(self.b.converged.all())

    def restart(self):
        from lightweaver_tpu_torch.parallel import ColumnBatch
        fc = self.b.flatCtx
        lte_restart(fc)
        self.b = ColumnBatch(flatCtx=fc, Ncol=self.b.Ncol)

    def keep(self) -> dict:
        """The state the next step starts from, at the check's points."""
        b = self.b
        return {'J': b.params['J'][:, self.idx].clone(),
                'pops': [p[:, self.idx].clone() for p in b.params['pops']]}

    def units(self, kept: dict) -> list:
        """Per checked column, the kept state and the state now (with
        Gamma)."""
        b = self.b
        now = host_state({'J': b.params['J'][:, self.idx],
                          'pops': [p[:, self.idx] for p in b.params['pops']],
                          'Gamma': [g[:, :, self.idx] for g in b._Gamma]})
        before = host_state(kept)
        Nk = b.NkCol
        out = []
        for i in range(len(self.checkCols)):
            s = slice(i * Nk, (i + 1) * Nk)
            out.append(tuple({k: [x[..., s] for x in v] if isinstance(v, list)
                              else v[..., s] for k, v in st.items()}
                             for st in (before, now)))
        return out


def reference(config, inputs, unit, units, device):
    """The reference of column ``units[unit]`` alone."""
    atmos = problem.column_atmosphere(config, inputs, units[unit])
    return crd.Unit(problem.build(config, atmos, device))
