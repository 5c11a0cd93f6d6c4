"""Where the float32 state's noise comes from, on the CPU.

    python3 scripts/torch_f32_floor.py

Runs lightweaver_tpu_torch on the CPU (the kernels' plain versions) and
prints:

1. One MALI iteration of FAL-C decimated to 24 depths, 3 rays, H 6 + Ca
   II active, after three float64 steps: the float32 iteration against
   the float64 one on the same (float32-representable) state, as
   max |x - ref| / max |ref| of J, the emergent I, Gamma, Rij and Rji,
   with the float32 Bezier-3 weights from their power series (the port)
   and from the closed forms (as the reference computes them).
2. Iterations to converge (JTol 5e-3, popsTol 1e-3, at most 600) of the
   mixed-precision problem (40 depths, 3 rays, Ca II active) in float64,
   in float32 with the series weights and in float32 with the closed
   forms.

The closed forms are selected by setting ops/formal_solver.B3_SERIES_MAX
to the Taylor switch (5e-2), which leaves the series no range.
"""
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lightweaver_tpu_torch import iterate_ctx_se  # noqa: E402
from lightweaver_tpu_torch.ops import formal_solver  # noqa: E402
from lightweaver_tpu_torch.problems import (falc_decimated,  # noqa: E402
                                            h6ca_context,
                                            mixed_precision_context)

SERIES_MAX = formal_solver.B3_SERIES_MAX


def weights(series):
    formal_solver.B3_SERIES_MAX = SERIES_MAX if series else 5e-2


def rel(x, ref):
    x, ref = x.double(), ref.double()
    return ((x - ref).abs().max() / ref.abs().max()).item()


def one_iteration():
    ctx = h6ca_context(falc_decimated(24), 3, device='cpu')
    for _ in range(3):
        ctx.formal_sol_gamma_matrices()
        ctx.stat_equil()
    params = ctx.build_params()
    # the state rounded to float32, so both precisions start from it
    state = {k: params[k].float().double()
             for k in ('bgChi', 'bgEta', 'bgSca', 'temperature', 'height')}
    state['pops'] = [n.float().double() for n in params['pops']]
    state['J'] = params['J'].float().double()
    for key in ('phi', 'wphi'):
        state[key] = [[None if x is None else x.float().double() for x in row]
                      for row in params[key]]
    ref = ctx._iter_fn({**params, **state})
    ctx32 = h6ca_context(falc_decimated(24), 3, device='cpu',
                         dtype=torch.float32)
    p32 = {**ctx32.build_params(), **state}
    for series in (True, False):
        weights(series)
        out = ctx32._iter_fn(p32)
        errs = {'J': rel(out['J'], ref['J']), 'I': rel(out['I'], ref['I']),
                'Gamma': max(rel(g, r) for g, r in zip(out['Gamma'],
                                                       ref['Gamma']))}
        for key in ('Rij', 'Rji'):
            errs[key] = max(rel(x, r) for xs, rs in zip(out[key], ref[key])
                            for x, r in zip(xs, rs))
        print(f'float32 ({"series" if series else "closed-form"} Bezier '
              'weights) vs float64, one iteration: '
              + ', '.join(f'{k} {v:.2e}' for k, v in errs.items()))
    weights(True)


def main():
    torch.set_num_threads(4)
    one_iteration()
    for dtype, series in ((torch.float64, True), (torch.float32, True),
                          (torch.float32, False)):
        weights(series)
        ctx = mixed_precision_context(device='cpu', dtype=dtype)
        nIter = 0
        fsgm = ctx.formal_sol_gamma_matrices

        def counted():
            nonlocal nIter
            nIter += 1
            return fsgm()
        ctx.formal_sol_gamma_matrices = counted
        t0 = time.perf_counter()
        ups = iterate_ctx_se(ctx, NmaxIter=600, quiet=True,
                             returnFinalConvergence=True)
        wall = time.perf_counter() - t0
        weights(True)
        name = ('float64' if dtype == torch.float64 else
                f'float32, {"series" if series else "closed-form"} weights')
        print(f'mixed-precision problem, {name}: {nIter} iterations '
              f'(600 = not converged), last dJ {float(ups[0].dJMax):.3e}, '
              f'dPops {ups[1].dPopsMax:.3e}, {wall:.1f} s on the CPU; '
              f'emergent I finite {bool(np.isfinite(ctx.I.numpy()).all())}')


if __name__ == '__main__':
    main()
