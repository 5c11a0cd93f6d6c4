"""Benchmark/autotune: time the configurable variants on the standard
FALC-500 H+Ca problem and persist the fastest to lightweaverrc.

The port of lightweaver_tpu/benchmark.py, the counterpart of the
reference's SIMD-implementation autotuner (ref: lightweaver/benchmark.py:
19-113): the tunables are the working precision, the Gamma accumulation
under the float32 state and the iteration scheme, each timed on the card
with torch.cuda.synchronize() around the MALI steps.
"""
import time
from typing import Optional

import numpy as np
import torch

SCHEMES = ('mali_full_precond', 'mali_full_precond_fused',
           'mali_full_precond_pallas')


def _build_ctx(Nspace=500, Nrays=5, dtype=None, recurrenceMode='scan',
               device='cuda'):
    """The FALC-500 problem of the JAX package's benchmark: FAL-C
    interpolated to ``Nspace`` depths in log column mass, H 6 + Ca II
    active, ``Nrays`` rays, under the default scheme and exact Gamma
    accumulation whatever lightweaverrc says (the race sets them)."""
    from .atmosphere import Atmosphere
    from .atomic_set import RadiativeSet
    from .context import Context
    from .fal import Falc82
    from .rh_atoms import CaII_atom, H_6_atom

    full = Falc82()
    cm = np.log10(full.cmass)
    cmNew = np.linspace(cm[0], cm[-1], Nspace)

    def interp(y, logY=False):
        if logY:
            return 10 ** np.interp(cmNew, cm, np.log10(y))
        return np.interp(cmNew, cm, y)

    atmos = Atmosphere(height=interp(full.height),
                       temperature=interp(full.temperature, logY=True),
                       vlos=np.zeros(Nspace), vturb=interp(full.vturb),
                       ne=interp(full.ne, logY=True),
                       nHTot=interp(full.nHTot, logY=True))
    atmos.quadrature(Nrays)
    rs = RadiativeSet([H_6_atom(), CaII_atom()])
    rs.set_active('H', 'Ca')
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    return Context(atmos, spect, eqPops,
                   dtype=torch.float64 if dtype is None else dtype,
                   recurrenceMode=recurrenceMode, gammaAccum='exact',
                   fsIterScheme=SCHEMES[0], device=device)


def _sync(ctx):
    if ctx.device.type == 'cuda':
        torch.cuda.synchronize(ctx.device)


def _time_ctx(ctx, Niter):
    """Seconds per formal_sol_gamma_matrices after two warm-up calls."""
    for _ in range(2):
        ctx.formal_sol_gamma_matrices()
    _sync(ctx)
    t0 = time.perf_counter()
    for _ in range(Niter):
        ctx.formal_sol_gamma_matrices()
    _sync(ctx)
    return (time.perf_counter() - t0) / Niter


def benchmark(Niter: int = 20, writeConfig: bool = False,
              verbose: bool = True, schemes: Optional[list] = None,
              device='cuda') -> dict:
    """Race the precisions (float64 against the float32 state, lightweaverrc
    ``Precision`` 'f64' and 'mixed'), the Gamma-accumulation contract at
    the winner ('exact' against 'blocked', only distinct under 'mixed'),
    and the iteration schemes at the winning variant (the default, the
    fused lambda step and the line Gamma kernel; ``schemes`` picks them,
    default all three on the card and the default alone on the CPU, where
    the kernels' plain versions would race instead of the kernels);
    optionally persist the winners to the user config (``Precision``,
    ``RecurrenceMode``, ``GammaAccum``, ``IterationScheme``).

    Only the 'scan' recurrence is raced: the JAX package's 'parallel' and
    'blocked' recurrences are names for the port's one sweep kernel, and
    'pallas' too (Context's recurrenceMode), so racing them would time
    the same kernel again.  Returns the JAX function's dict: 'timings'
    {(recurrence, precision): s/iter}, 'best', 'accumTimings', 'bestAccum',
    'schemeTimings', 'bestScheme'."""
    variants = [('scan', 'f64', None), ('scan', 'mixed', torch.float32)]
    results = {}
    for mode, prec, dtype in variants:
        ctx = _build_ctx(dtype=dtype, recurrenceMode=mode, device=device)
        wall = _time_ctx(ctx, Niter)
        results[(mode, prec)] = wall
        if verbose:
            print(f'{mode}/{prec}: {wall * 1e3:.1f} ms/iter')

    best = min(results, key=results.get)
    bestDtype = torch.float32 if best[1] == 'mixed' else None

    # the Gamma lambda-accumulation contract at the winning variant (only
    # distinct under mixed precision): 'blocked' trades the float64
    # lambda sums for working-dtype block partials
    bestAccum = 'exact'
    accumResults = {'exact': results[best]}
    if best[1] == 'mixed':
        ctx = _build_ctx(dtype=bestDtype, recurrenceMode=best[0],
                         device=device)
        ctx._swap_cfg(gammaAccum='blocked')
        accumResults['blocked'] = _time_ctx(ctx, Niter)
        if verbose:
            print(f"gammaAccum=blocked [{best[0]}/{best[1]}]: "
                  f"{accumResults['blocked'] * 1e3:.1f} ms/iter")
        bestAccum = min(accumResults, key=accumResults.get)

    if schemes is None:
        schemes = (list(SCHEMES) if torch.device(device).type == 'cuda'
                   else [SCHEMES[0]])
    schemeResults = {SCHEMES[0]: accumResults[bestAccum]}
    for scheme in schemes:
        if scheme in schemeResults:
            continue
        ctx = _build_ctx(dtype=bestDtype, recurrenceMode=best[0],
                         device=device)
        if bestAccum != 'exact':
            ctx._swap_cfg(gammaAccum=bestAccum)
        try:
            ctx.set_fs_iter_scheme(scheme)
        except ValueError as e:
            if verbose:
                print(f'{scheme}: unsupported ({e})')
            continue
        wall = _time_ctx(ctx, Niter)
        schemeResults[scheme] = wall
        if verbose:
            print(f'{scheme} [{best[0]}/{best[1]}]: '
                  f'{wall * 1e3:.1f} ms/iter')
    bestScheme = min(schemeResults, key=schemeResults.get)

    if verbose:
        print(f'fastest: {best[0]}/{best[1]}/{bestAccum}/{bestScheme}')
    if writeConfig:
        from .config import params
        params['RecurrenceMode'] = best[0]
        params['Precision'] = best[1]
        params['GammaAccum'] = bestAccum
        params['IterationScheme'] = bestScheme
        params.save()
    return {'timings': results, 'best': best,
            'accumTimings': accumResults, 'bestAccum': bestAccum,
            'schemeTimings': schemeResults, 'bestScheme': bestScheme}
