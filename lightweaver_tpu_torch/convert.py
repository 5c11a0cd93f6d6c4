"""Carry iteration state across from the JAX package.

``params_from_numpy`` takes the params pytree of
``lightweaver_tpu.Context.build_params()`` (any array type numpy can read:
numpy or jax arrays, nested [atom][trans] lists with None holes) and
returns the params dict of ``lightweaver_tpu_torch.context``, so that
both iteration functions (and the PRD subset stage) can be fed identical
inputs, PRD state included.  Nothing here imports jax.
"""
import numpy as np
import torch

from .context import DEFAULT_DTYPE, STATE_DTYPE, phi_direction_major


def params_from_numpy(params, cfg=None, device='cuda'):
    """JAX ``build_params()`` pytree -> the port's params dict, in the
    dtypes and on the device of the target IterConfig ``cfg`` (without
    one: float64 on ``device``).  The state (J, populations, background,
    thermodynamics, collisional rates, rho) becomes float64, as the port's
    Context keeps it in either precision; the profiles, their weights and
    the boundary data (the z boundaries' [Nlam, Nmu] and a 2D
    atmosphere's x boundaries' [Nlam, Nmu, 2, Nz]) take the working
    dtype.  A JAX float32 Context's
    values are all float32-representable, so the port's float32 iteration
    reads exactly the JAX one's inputs.  Profiles and the hybrid-PRD
    coefficients hprdI0/hprdFrac move from the JAX layout [W, Nmu, 2, Nk]
    to the direction-major [2, W, Nmu, Nk]; the PRD ratios rhoPrd [W, Nk]
    and vlosMu [Nmu, Nk] keep theirs."""
    if cfg is not None:
        device = cfg.device
    working = DEFAULT_DTYPE if cfg is None else cfg.dtype

    def t_(x, dt=STATE_DTYPE):
        return None if x is None else torch.as_tensor(
            np.array(x, dtype=np.int64 if dt == torch.int64 else np.float64),
            dtype=dt, device=device)

    def w_(x):
        return t_(x, working)

    def nested(key, fn):
        rows = params.get(key)
        return None if rows is None else [[None if x is None else fn(x)
                                           for x in row] for row in rows]

    out = {key: t_(params.get(key)) for key in
           ('J', 'bgChi', 'bgEta', 'bgSca', 'temperature', 'height',
            'vlosMu')}
    for key in ('upperBcData', 'lowerBcData', 'xLowerBcData',
                'xUpperBcData'):
        out[key] = w_(params.get(key))
    for key in ('pops', 'nStar', 'detPops', 'detNStar', 'C'):
        out[key] = [t_(x) for x in params[key]]
    out['crsw'] = float(np.asarray(params['crsw']))
    out['phi'] = nested('phi', lambda p: phi_direction_major(w_(p)))
    out['wphi'] = nested('wphi', w_)
    out['rhoPrd'] = nested('rhoPrd', t_)
    out['hprdI0'] = nested('hprdI0', lambda x: phi_direction_major(
        t_(x, torch.int64)))
    out['hprdFrac'] = nested('hprdFrac', lambda x: phi_direction_major(
        w_(x)))
    return out
