"""Carry iteration state across from the JAX package.

``params_from_numpy`` takes the params pytree of
``lightweaver_tpu.Context.build_params()`` (any array type numpy can read:
numpy or jax arrays, nested [atom][trans] lists with None holes) and
returns the params dict of ``lightweaver_tpu_torch.context``, so that
both iteration functions can be fed identical inputs.  Nothing here
imports jax.
"""
import numpy as np
import torch

from .context import DEFAULT_DTYPE, phi_direction_major

# params the ported slice cannot carry: they must be absent or None
_UNSUPPORTED = ('xLowerBcData', 'xUpperBcData', 'vlosMu', 'hprdI0',
                'hprdFrac')


def params_from_numpy(params, device='cpu', dtype=DEFAULT_DTYPE):
    """JAX ``build_params()`` pytree -> the port's params dict on
    ``device``.  Profiles move to the direction-major [2, W, Nmu, Nk]
    layout; PRD emission-profile ratios must be 1 (complete
    redistribution, all the port runs)."""
    def t_(x):
        return None if x is None else torch.as_tensor(
            np.array(x, dtype=np.float64), dtype=dtype, device=device)

    for key in _UNSUPPORTED:
        if params.get(key) is not None:
            raise ValueError(f'params[{key!r}] is outside the ported slice')
    for row in params.get('rhoPrd') or []:
        for rho in row:
            if rho is not None and not np.all(np.asarray(rho) == 1.0):
                raise ValueError('PRD state (rho != 1) is outside the '
                                 'ported slice')

    out = {key: t_(params[key]) for key in
           ('J', 'bgChi', 'bgEta', 'bgSca', 'temperature', 'height',
            'upperBcData', 'lowerBcData')}
    for key in ('pops', 'nStar', 'detPops', 'detNStar', 'C'):
        out[key] = [t_(x) for x in params[key]]
    out['crsw'] = float(np.asarray(params['crsw']))
    out['phi'] = [[None if p is None else phi_direction_major(t_(p))
                   for p in row] for row in params['phi']]
    out['wphi'] = [[t_(w) for w in row] for row in params['wphi']]
    return out
