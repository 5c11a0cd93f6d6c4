"""The fused lambda step's plain version (ops/fused.py) and the port's
'mali_full_precond_fused' scheme, against the JAX package.

The JAX kernel lightweaver_tpu/ops/pallas_fused.py:fused_lambda_step runs
in Pallas interpret mode on the CPU.  It takes rows padded to its 8-row
blocks and depth padded to 128 lanes (chi = 1 and zero emission in the
padding), its rays as [rows, 2Nmu, lanes] with md = mu*2 + d, and returns
J as the TwoSum pair (Jhi, Jlo): J is compared with Jhi + Jlo.
"""
import dataclasses

import numpy as np
import pytest
import torch

import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.atomic_set import RadiativeSet as JRadiativeSet
from lightweaver_tpu.context import Context as JContext
from lightweaver_tpu.ops.pallas_fused import \
    assign_line_slots as j_assign_line_slots
from lightweaver_tpu.ops.pallas_fused import \
    fused_lambda_step as j_fused_lambda_step
from lightweaver_tpu.ops.pallas_sweep import RB
from lightweaver_tpu_torch.context import build_iteration_fn
from lightweaver_tpu_torch.convert import params_from_numpy
from lightweaver_tpu_torch.ops import fused as tfused
from lightweaver_tpu_torch.problems import (falc_interpolated, h6ca_context,
                                            random_boundaries, random_slots)

from tests.test_torch_slice import (NRAYS, NSPACE, _jax_falc_interpolated,
                                    relerr)

FUSED = 'mali_full_precond_fused'

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def _pad(x, shape, value=0.0):
    out = np.full(shape, value)
    out[tuple(slice(0, n) for n in x.shape)] = x
    return out


@pytest.mark.parametrize('bcs', [('zero', 'therm'), ('therm', 'data'),
                                 ('data', 'zero')])
def test_plain_fused_step_matches_jax(bcs):
    """C = 2 slots, each boundary kind at each end: I/Psi/IeffBase and
    the moments to 1e-10 of each output's maximum (the JAX kernel's
    Kogge-Stone prefix reorders the depth recurrence's sums, as for the
    sweep), J against Jhi + Jlo."""
    C, NL, Nmu, Nk = 2, 12, 2, 20
    s = random_slots(C, NL, Nmu, Nk, seed=7)
    rows = random_boundaries(NL, Nmu, seed=7)
    upper, lower = ((kind, None if kind == 'zero' else rows[kind])
                    for kind in bcs)
    t_ = torch.as_tensor
    ours = tfused.fused_lambda_step(
        **{k: t_(v) for k, v in s.items()},
        upper=(upper[0], None if upper[1] is None else t_(upper[1])),
        lower=(lower[0], None if lower[1] is None else t_(lower[1])))

    LPad, NkL, M2 = -(-NL // RB) * RB, 128, 2 * Nmu
    phiJ = np.moveaxis(s['phiP'], 1, 3).reshape(C, NL, M2, Nk)
    dh = np.abs(s['height'][:-1] - s['height'][1:])

    def bc_rows(bc, width):
        kind, x = bc
        return _pad(x if kind != 'zero' else np.zeros((NL, width)),
                    (LPad, width))
    res = j_fused_lambda_step(
        _pad(phiJ, (C, LPad, M2, NkL)), _pad(s['chiCo'], (C, LPad, NkL)),
        _pad(s['etaCo'], (C, LPad, NkL)),
        _pad(s['bgChi'], (LPad, NkL), 1.0), _pad(s['bgEta'], (LPad, NkL)),
        _pad(s['scaJ'], (LPad, NkL)), _pad(dh[None, :], (1, NkL), 1.0),
        bc_rows(upper if upper[0] == 'data' else ('zero', None), Nmu),
        bc_rows(lower if lower[0] == 'data' else ('zero', None), Nmu),
        bc_rows(upper if upper[0] == 'therm' else ('zero', None), 2),
        bc_rows(lower if lower[0] == 'therm' else ('zero', None), 2),
        N=Nk, Nmu=Nmu, muz=s['muz'], wmu=s['wmu'],
        upperKind=upper[0], lowerKind=lower[0])
    res = [np.asarray(x) for x in res]

    def rays(x):        # [LPad, M2, NkL] -> [2, NL, Nmu, Nk]
        x = x[:NL, :, :Nk].reshape(NL, Nmu, 2, Nk)
        return np.moveaxis(x, 2, 0)
    refs = {'I': rays(res[0]), 'Psi': rays(res[1]),
            'IeffBase': rays(res[2]), 'J': res[3] + res[4],
            'PsiBar': res[5], 'IBar': res[6], 'IeffSrcBar': res[7]}
    got = dict(zip(('I', 'Psi', 'IeffBase'), ours[:3]), **ours[3])
    for name, ref in refs.items():
        if ref.ndim == 2:
            ref = ref[:NL, :Nk]
        e = np.abs(got[name].numpy() - ref).max() / np.abs(ref).max()
        assert e < 1e-10, (name, e)


@pytest.fixture(scope='module')
def ctx():
    """The slice test's 30-depth, 3-ray problem after two MALI steps."""
    c = h6ca_context(falc_interpolated(NSPACE), NRAYS, device='cpu')
    for _ in range(2):
        c.formal_sol_gamma_matrices()
        c.stat_equil()
    return c


def test_line_slots_match_jax(ctx):
    """The same colouring as the JAX helper: C = 2 on falc_h6ca."""
    slots, C = tfused.assign_line_slots(ctx.cfg.allAtoms)
    assert (slots, C) == j_assign_line_slots(ctx.cfg.allAtoms)
    assert C == 2


def _compare(out, ref, keys=('dJ',)):
    """Gamma/Rij/Rji (and keys) to 1e-10 with the 1e-10 max floor."""
    for ai in range(2):
        e = relerr(out['Gamma'][ai], ref['Gamma'][ai])
        assert e < 1e-10, ('Gamma', ai, e)
        for key in ('Rij', 'Rji'):
            for ti, x in enumerate(out[key][ai]):
                e = relerr(x, ref[key][ai][ti])
                assert e < 1e-10, (key, ai, ti, e)
    for key in keys:
        assert relerr(out[key], ref[key]) < 1e-10, key


def _compare_rays(out, ref, tol):
    """J and I to tol of their maximum over depth (J) or angle (I) at
    each wavelength, as test_torch_slice holds them."""
    for key in ('J', 'I'):
        ours, r = np.asarray(out[key]), np.asarray(ref[key])
        e = (np.abs(ours - r).max(axis=1) / np.abs(r).max(axis=1)).max()
        assert e < tol, (key, e)


def test_fused_scheme_matches_default(ctx):
    """The scheme's iteration against the default scheme on the same
    params.  The fused assembly forms chi as bg + continua + (n_i - g n_j)
    a1 phi where the gather sums n_i Vij - n_j Vji per window, so chi
    differs by rounding; Gamma/Rij/Rji/dJ agree to 1e-10 (floor 1e-10 of
    each maximum), J and I to 1e-9 of each wavelength's maximum (the
    slice test's bar: the depth recurrence carries the rounding of the
    optically thick deep UV)."""
    params = ctx.build_params()
    outs = {}
    for scheme in ('mali_full_precond', FUSED):
        cfg = dataclasses.replace(ctx.cfg, fsIterScheme=scheme)
        outs[scheme] = build_iteration_fn(cfg)({**params, 'pack': None})
    _compare(outs[FUSED], outs['mali_full_precond'])
    _compare_rays(outs[FUSED], outs['mali_full_precond'], 1e-9)


@pytest.mark.slow
def test_fused_iteration_matches_jax_fused_scheme():
    """One iteration of the port's scheme against the JAX package's
    iteration under the same scheme name (interpret mode) on the same
    params, at test_torch_slice's tolerances."""
    atmos = _jax_falc_interpolated(NSPACE)
    atmos.quadrature(NRAYS)
    rs = JRadiativeSet([jatoms.H_6_atom(), jatoms.CaII_atom()])
    rs.set_active('H', 'Ca')
    spect = rs.compute_wavelength_grid()
    jctx = JContext(atmos, spect, rs.compute_eq_pops(atmos),
                    fsIterScheme=FUSED)
    tctx = h6ca_context(falc_interpolated(NSPACE), NRAYS, device='cpu')
    tctx.set_fs_iter_scheme(FUSED)
    for _ in range(2):
        jctx.formal_sol_gamma_matrices()
        jctx.stat_equil()
    out = tctx._iter_fn(params_from_numpy(jctx.build_params(), tctx.cfg))
    ju = jctx.formal_sol_gamma_matrices()
    ref = {'Gamma': jctx._Gamma, 'Rij': jctx._Rij, 'Rji': jctx._Rji,
           'dJ': ju.dJMax, 'J': jctx.J, 'I': jctx.I}
    _compare(out, ref)
    _compare_rays(out, ref, 1e-9)
