"""The inputs of a run, made from ``--seed`` and handed alike to the
program and to the reference: the atmospheres as numpy arrays.

FAL-C comes from the reference's copy of the data (its Falc82 turns the
tabulated column mass into heights).  Every seed gives the same shapes,
so the work of a step does not depend on the seed.
"""
import numpy as np

FIELDS = ('height', 'temperature', 'vlos', 'vturb', 'ne', 'nHTot')


def check_seed(seed: int) -> int:
    """A seed is a whole number (numpy's generators take any size)."""
    if seed < 0:
        raise ValueError(f'--seed takes a whole number, got {seed}')
    return seed


def falc_depths(Nk: int):
    """FAL-C's arrays at the depths np.unique(np.linspace(0, 81, Nk)
    .astype(int)) of its 82, as problems.stacked_falc picks them."""
    from ..reference.lwref.fal import Falc82
    full = Falc82()
    idx = np.unique(np.linspace(0, 81, Nk).astype(int))
    return {k: np.asarray(getattr(full, k), np.float64)[idx] for k in FIELDS}


def stacked_columns(config: dict, seed: int) -> dict:
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


def slab(config: dict, seed: int) -> dict:
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


GENERATORS = {'column_batch': stacked_columns, 'context_2d': slab}


def make(config: dict, seed: int) -> dict:
    """The inputs of a configuration of kind ``config['kind']``."""
    return GENERATORS[config['kind']](config, seed)
