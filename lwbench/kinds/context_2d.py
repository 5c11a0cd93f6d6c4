"""The 2D slab: one ``Context`` over a 2D (x, z) FAL-C slab periodic in
x, stepped as iterate_ctx_se steps.  The check compares every point: the
slab is its one unit."""
import numpy as np

from lwbench.harness import check
from lwbench.harness.inputs import check_seed, falc_depth_count, falc_depths
from lwbench.harness.systems import host_state, lte_restart
from lwbench.reference import crd, problem

NUMBERS = check.MALI_NUMBERS
SPANS = ()


def make_inputs(config: dict, seed: int) -> dict:
    """A 2D (x, z) FAL-C slab: ``x_columns`` columns ``dx_m`` apart; the
    temperature times 1 + a sum of the x modes 1..``x_modes`` with
    amplitudes uniform(0, 1) and phases uniform(0, 2 pi) drawn from the
    seed, scaled to a peak of ``temperature_peak``; vx the shear
    ``vx_m_s`` sin(2 pi j / Nx) of problems.slab_2d_atmos, vz FAL-C's
    vlos.  height [Nz], x [Nx], the fields [Nz, Nx]."""
    f = falc_depths(config['depths'])
    Nz, Nx = len(f['height']), config['x_columns']
    rng = np.random.default_rng(check_seed(seed))
    modes = np.arange(1, config['x_modes'] + 1)
    amp = rng.uniform(0.0, 1.0, len(modes))
    phase = rng.uniform(0.0, 2 * np.pi, len(modes))
    j = np.arange(Nx)
    s = (amp[:, None] * np.sin(2 * np.pi * modes[:, None] * j[None, :] / Nx
                               + phase[:, None])).sum(axis=0)
    pert = 1.0 + config['temperature_peak'] * s / np.abs(s).max()

    def col(a):
        return np.broadcast_to(a[:, None], (Nz, Nx)).copy()
    return {'height': f['height'], 'x': j * float(config['dx_m']),
            'temperature': f['temperature'][:, None] * pert[None, :],
            'vx': col(np.ones(Nz)) * config['vx_m_s']
            * np.sin(2 * np.pi * j / Nx)[None, :],
            'vz': col(f['vlos']), 'vturb': col(f['vturb']),
            'ne': col(f['ne']), 'nHTot': col(f['nHTot'])}


def check_units(config: dict, settings: dict, seed: int) -> list:
    """No columns to draw: the check compares the whole slab."""
    return []


def shapes(config: dict) -> dict:
    """Nlam (the wavelength grid by the reference's own model layer), Nmu
    (rays per direction: two per quadrature order) and Nk (Nz x Nx)."""
    return {'Nlam': problem.wavelength_count(config),
            'Nmu': 2 * config['quadrature'],
            'Nk': config['x_columns'] * falc_depth_count(config['depths'])}


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


class System:
    """The slab's Context."""

    def __init__(self, config, traffic, inputs, device, dtype, units):
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

    def keep(self) -> dict:
        return {'J': self.ctx.J.clone(),
                'pops': [st['n'].clone() for st in self.ctx.popsState]}

    def units(self, kept: dict) -> list:
        ctx = self.ctx
        now = host_state({'J': ctx.J, 'pops': [st['n'] for st in
                                               ctx.popsState],
                          'Gamma': ctx._Gamma})
        return [(host_state(kept), now)]


def reference(config, inputs, unit, units, device):
    """The reference of the whole slab."""
    return crd.Unit(problem.build(
        config, problem.slab_atmosphere(config, inputs), device))
