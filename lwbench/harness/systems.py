"""The systems under test, one per configuration ``kind``: the program's
objects (``lightweaver_tpu_torch``), built from the seed's inputs through
the program's public constructors.

A system steps as ColumnBatch.iterate and iterate_ctx_se step after their
Nscatter steps: a MALI step is formal_sol_gamma_matrices followed by
stat_equil.  Before each step it keeps the state that step starts from
(J and the populations) at the points the check compares, so that the
reference can take the window's last step from it.
"""
import numpy as np
import torch

DTYPES = {'float64': torch.float64, 'float32': torch.float32}


def slab_context(config: dict, inputs: dict, device, dtype, scheme: str):
    """The program's 2D Context of the slab inputs (x periodic)."""
    from lightweaver_tpu_torch import atmosphere, atomic_set, context, rh_atoms
    atmos = atmosphere.Atmosphere.make_2d(
        **{k: np.array(inputs[k]) for k in ('height', 'x', 'temperature',
                                            'vx', 'vz', 'vturb', 'ne',
                                            'nHTot')})
    atmos.quadrature(config['quadrature'])
    rs = atomic_set.RadiativeSet([getattr(rh_atoms, f'{n}_atom')()
                                  for n in config['atoms']])
    rs.set_active(*config['active'])
    return context.Context(
        atmos, rs.compute_wavelength_grid(), rs.compute_eq_pops(atmos),
        formalSolver=config['formal_solver'],
        interpFn2d=config['interp_2d'], fsIterScheme=scheme, device=device,
        dtype=dtype)


def host_state(J, pops, Gamma=None) -> dict:
    """J, the populations and Gamma (per active atom) as float64 numpy."""
    def host(x):
        return x.detach().to(torch.float64).cpu().numpy()
    out = {'J': host(J), 'pops': [host(n) for n in pops]}
    if Gamma is not None:
        out['Gamma'] = [host(g) for g in Gamma]
    return out


def lte_restart(ctx):
    """Put a Context back at its LTE start (populations from eqPops, J
    zero); its set-up (background, collisions, profiles) is kept
    (chip_smoke.py:restarted)."""
    for a, st in zip(ctx.cfg.activeAtoms, ctx.popsState):
        st['n'] = ctx.cfg.state(ctx.eqPops.atomicPops[a.model.element].n)
        st.pop('nLastSE', None)
    ctx.J = torch.zeros_like(ctx.J)


class ColumnBatchSystem:
    """The 1.5D batch: ColumnBatch.from_stacked over the stacked columns,
    with ColumnBatch.iterate's per-column convergence (converged columns
    freeze); the check compares the columns ``checkCols``."""

    def __init__(self, config, traffic, inputs, device, dtype, checkCols):
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
        self.checkCols = list(checkCols)
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

    def keep(self):
        """The state the next step starts from, at the check's points."""
        b = self.b
        return (b.params['J'][:, self.idx].clone(),
                [p[:, self.idx].clone() for p in b.params['pops']])

    def units(self, kept):
        """Per checked column, the kept state and the state now (with
        Gamma) as numpy."""
        b = self.b
        now = host_state(b.params['J'][:, self.idx],
                         [p[:, self.idx] for p in b.params['pops']],
                         [g[:, :, self.idx] for g in b._Gamma])
        before = host_state(*kept)
        Nk = b.NkCol
        out = []
        for i in range(len(self.checkCols)):
            s = slice(i * Nk, (i + 1) * Nk)
            out.append(tuple({k: (v[..., s] if k == 'J' else
                                  [x[..., s] for x in v])
                              for k, v in st.items()}
                             for st in (before, now)))
        return out


class Context2DSystem:
    """The 2D slab: one Context stepped as iterate_ctx_se steps; the
    check compares every point."""

    def __init__(self, config, traffic, inputs, device, dtype, checkCols):
        self.traffic = traffic
        self.ctx = slab_context(config, inputs, device, dtype,
                                traffic['scheme'])
        self.done = False

    def scatter_steps(self):
        for _ in range(self.traffic['nscatter']):
            self.ctx.formal_sol_gamma_matrices()

    def mali_step(self, spans) -> int:
        ctx = self.ctx
        dJ = float(ctx.formal_sol_gamma_matrices().dJMax)
        with spans.span('stat_equil'):
            dPops = ctx.stat_equil().dPopsMax
        self.done = (dJ < self.traffic['jtol']
                     and dPops < self.traffic['popstol'])
        return 1

    def all_converged(self) -> bool:
        return self.done

    def restart(self):
        lte_restart(self.ctx)
        self.done = False

    def keep(self):
        return (self.ctx.J.clone(),
                [st['n'].clone() for st in self.ctx.popsState])

    def units(self, kept):
        ctx = self.ctx
        now = host_state(ctx.J, [st['n'] for st in ctx.popsState],
                         ctx._Gamma)
        return [(host_state(*kept), now)]


SYSTEMS = {'column_batch': ColumnBatchSystem, 'context_2d': Context2DSystem}
