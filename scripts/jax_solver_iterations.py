"""Iterations to converge falc_h6ca under each 1D formal solver, with the
JAX package on the CPU (float64).

    python3 scripts/jax_solver_iterations.py [solver ...]

falc_h6ca is BASELINE config 1 (FAL-C, 82 depths, H 6-level + Ca II
active, 5 rays), built as tests/test_vs_reference_golden.py builds it,
with Context(formalSolver=...) and driven by iterate_ctx_se(NmaxIter=500)
(JTol 5e-3, popsTol 1e-3).  Prints, per solver, the iterations and the
wall time.  chip_smoke.py holds the port's iterations on the card under
the linear and BESSER solvers beside these counts.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)

from lightweaver_tpu.atomic_set import RadiativeSet  # noqa: E402
from lightweaver_tpu.context import Context  # noqa: E402
from lightweaver_tpu.fal import Falc82  # noqa: E402
from lightweaver_tpu.iterate_ctx import iterate_ctx_se  # noqa: E402
from lightweaver_tpu.ops.formal_solver import SOLVER_NAMES_1D  # noqa: E402
from lightweaver_tpu.rh_atoms import CaII_atom, H_6_atom  # noqa: E402


def iterations(solver):
    atmos = Falc82()
    atmos.quadrature(5)
    rs = RadiativeSet([H_6_atom(), CaII_atom()])
    rs.set_active('H', 'Ca')
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    ctx = Context(atmos, spect, eqPops, formalSolver=solver)
    return iterate_ctx_se(ctx, NmaxIter=500, quiet=True)


def main():
    for solver in sys.argv[1:] or SOLVER_NAMES_1D:
        t0 = time.perf_counter()
        n = iterations(solver)
        print(f'{solver}: {n} iterations ({time.perf_counter() - t0:.1f} s, '
              'JAX package, CPU, float64)', flush=True)


if __name__ == '__main__':
    main()
