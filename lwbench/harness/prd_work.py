"""The least time the card could take for the PRD lines' scattering
integrals of one MALI step, from the problem's shapes alone, so that any
implementation (eager torch ops, a CUDA kernel) is held to one count.

Per sub-iteration and PRD line of window W over Nk points, each (point,
window wavelength) pair integrates over a fine grid of absorption
frequencies (reference/prd.py's module docstring):

- fine points: at least FINE_POINTS per pair, the narrowest integration
  range, 2 PrdQWing / PrdDQ + 1 (the core's [-4, 4] at a step of 0.15);
- operations: FINE_FLOPS per fine point (gII and J's interpolation);
- bytes: J's window read and rho written once, ``itemsize`` bytes each.

The least time of a sub-iteration is the larger of the bytes over the
memory rate and the operations over the peak rate (harness/work.py's
rates); a step's is that times its sub-iterations.
"""
import math

from . import manifest
from .inputs import falc_depth_count
from .work import HBM_BYTES_PER_S, ITEMSIZE, PEAK_FLOPS

FINE_POINTS = math.floor(2 * 4.0 / 0.15) + 1
# floating-point operations per fine point: J interpolated in q (a
# difference, a division, a multiply-add: 4), gII's core form (a square,
# a square root, an add, a reciprocal; the exp of the far core: ~15 in
# all), the weight's and J's products and the two sums (4); 23, floored
FINE_FLOPS = 20


def scatter_work(windows, Nk: int, dtype: str = 'float64') -> dict:
    """bytes, flops, the least seconds of one sub-iteration and what bounds
    them, for PRD windows of ``windows`` rows over Nk points."""
    pairs = Nk * sum(windows)
    flops = FINE_FLOPS * FINE_POINTS * pairs
    nBytes = 2 * ITEMSIZE[dtype] * pairs
    tBytes = nBytes / HBM_BYTES_PER_S
    tOps = flops / PEAK_FLOPS[dtype]
    return {'bytes': nBytes, 'flops': flops, 'least_s': max(tBytes, tOps),
            'bound_by': 'bytes' if tBytes >= tOps else 'operations'}


def prd_windows(config: dict) -> list:
    """The rows of each PRD line's window on the configuration's grid (its
    active atoms' lines marked PRD), by the reference's model layer."""
    from ..reference.lwref.atomic_model import AtomicLine, LineType
    from ..reference.problem import radiative_set
    rs = radiative_set(config)
    spect = rs.compute_wavelength_grid()
    return [spect.redIdx[t.transId] - spect.blueIdx[t.transId]
            for a in rs.activeAtoms for t in a.transitions
            if isinstance(t, AtomicLine) and t.type == LineType.PRD
            and t.transId in spect.blueIdx]


def config_of(run, root) -> dict:
    """The configuration of ``root``/BENCHMARK.json whose kind and column
    batch's shapes (points, rays) are the run's; None where not exactly
    one is."""
    bench = manifest.read_json(root / 'BENCHMARK.json')
    found = []
    for c in bench['configs']:
        cfg = manifest.read_json(root / c['file'])
        if (cfg.get('kind') == run.kind and 'columns' in cfg
                and cfg['columns'] * falc_depth_count(cfg['depths'])
                == run.Nk and cfg['rays'] == run.Nmu):
            found.append(cfg)
    return found[0] if len(found) == 1 else None
