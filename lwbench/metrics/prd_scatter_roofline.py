"""The PRD scattering integrals' least time per MALI step (harness/
prd_work.py: the configuration's PRD windows, the run's points, times
the sub-iterations per step) over the device's busy time per step under
the program's lw.prd.scatter_rho spans, in %."""
from pathlib import Path

from lwbench.harness import prd_work

ROOT = Path(__file__).resolve().parents[2]


def read(run):
    busy = run.program_span('lw.prd.scatter_rho', 'busy_ms')
    subiters = run.program_span('lw.prd.subiter', 'count')
    if not busy or not subiters:
        return None
    config = prd_work.config_of(run, ROOT)
    if config is None:
        return None
    least = prd_work.scatter_work(prd_work.prd_windows(config), run.Nk,
                                  run.dtype)['least_s']
    return 100.0 * least * subiters * 1e3 / busy
