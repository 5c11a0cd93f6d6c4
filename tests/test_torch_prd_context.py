"""PRD in the port's Context against the JAX package, on a small problem.

FAL-C interpolated to 20 depths (bench.py's interpolation), 3 rays, H
6-level active with Ly-alpha and Ly-beta in PRD.  The JAX Context runs
three MALI steps each followed by stat_equil and prd_redistribute, so rho
departs from 1 by up to ~30; its state (J, populations, rates, rho) then
goes into the port through params_from_numpy and into a port Context, and
each stage is held against the JAX one on those identical inputs:

- the PRD subset formal solution (build_prd_subset_fn) and its rows
  against the full-grid solve,
- prd_redistribute (rho, dRho, J, the PRD lines' rates),
- one MALI iteration with that rho under each of the port's three schemes
  against the JAX default scheme,
- prd_redistribute's two non-default modes: persistent Ng on rho
  (prdNgOptions) and the full-grid formal solution (prdFsMode='full').

The bars are the slice test's (tests/test_torch_slice.py): Gamma, Rij and
Rji to 1e-10 relative above a floor of 1e-10 of each maximum, J and I to
1e-9 of each wavelength's maximum, and rho to 1e-9 (2e-11 measured).  The
last test runs the kernel schemes on H 6 + Mg II (a four-line Mg II group,
three fused slots) against the port's default scheme after
prd_redistribute, through the Context's own cached params.
"""
import dataclasses

import numpy as np
import pytest
import torch

import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.atomic_set import RadiativeSet as JRadiativeSet
from lightweaver_tpu.context import Context as JContext
from lightweaver_tpu.context import \
    build_prd_subset_fn as j_build_prd_subset_fn
from lightweaver_tpu.ops.ng import NgOptions as JNgOptions
from lightweaver_tpu_torch import H_6_atom, RadiativeSet
from lightweaver_tpu_torch.context import (Context, build_iteration_fn,
                                           build_prd_subset_fn)
from lightweaver_tpu_torch.convert import params_from_numpy
from lightweaver_tpu_torch.ops import fused as tfused
from lightweaver_tpu_torch.ops import gamma as tgamma
from lightweaver_tpu_torch.ops.ng import NgOptions
from lightweaver_tpu_torch.problems import (falc_interpolated, h6mg_context,
                                            vlos_ramp)

from tests.test_torch_slice import _jax_falc_interpolated, relerr

NSPACE, NRAYS = 20, 3
SCHEMES = ('mali_full_precond', 'mali_full_precond_pallas',
           'mali_full_precond_fused')

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def h6_pair(hprd):
    """The JAX and port Contexts of the small H 6 problem (with the 0-5
    km/s outflow ramp under hybrid PRD)."""
    atmos = _jax_falc_interpolated(NSPACE)
    atmos.quadrature(NRAYS)
    if hprd:
        atmos.vlos = 5e3 * (atmos.height - atmos.height.min()) \
            / (atmos.height.max() - atmos.height.min())
    rs = JRadiativeSet([jatoms.H_6_atom()])
    rs.set_active('H')
    spect = rs.compute_wavelength_grid()
    jctx = JContext(atmos, spect, rs.compute_eq_pops(atmos), hprd=hprd)
    tctx = port_context(hprd)
    np.testing.assert_array_equal(tctx.atmos.vlos, jctx.atmos.vlos)
    return jctx, tctx


def port_context(hprd):
    """The port Context of the small H 6 problem."""
    atmos = falc_interpolated(NSPACE)
    atmos.quadrature(NRAYS)
    if hprd:
        vlos_ramp(atmos)
    rs = RadiativeSet([H_6_atom()])
    rs.set_active('H')
    spect = rs.compute_wavelength_grid()
    return Context(atmos, spect, rs.compute_eq_pops(atmos), hprd=hprd,
                   device='cpu')


def _np(x):
    return None if x is None else np.array(x)


def _snapshot(params):
    """A JAX build_params() dict with its nested lists copied: they are
    the Context's own lists (rhoPrd, pops), which later calls rebind."""
    def copy(x):
        return [copy(v) for v in x] if isinstance(x, list) else x
    return {k: copy(v) for k, v in params.items()}


def inject(tctx, jctx):
    """The JAX Context's iteration state (J, JRest, populations, rates,
    rho) into the port Context."""
    def t_(x):
        return torch.as_tensor(_np(x))
    tctx._params = tctx.build_params()
    tctx.J = t_(jctx.J)
    tctx.JRest = None if jctx.JRest is None else t_(jctx.JRest)
    for st, jst in zip(tctx.popsState, jctx.popsState):
        st['n'] = t_(jst['n'])
    tctx._Rij = [[t_(x) for x in row] for row in jctx._Rij]
    tctx._Rji = [[t_(x) for x in row] for row in jctx._Rji]
    for ai, ti, a, t in tctx._prd_lines():
        tctx.rhoPrd[ai][ti] = t_(jctx.rhoPrd[ai][ti])


def stepped(hprd):
    """Three JAX MALI + prd_redistribute steps, then the records the tests
    compare with: the state before a fourth prd_redistribute (params and
    the Context state), after it, and the JAX default scheme's iteration
    on the state after it."""
    jctx, tctx = h6_pair(hprd)
    for _ in range(3):
        jctx.formal_sol_gamma_matrices()
        jctx.stat_equil()
        jctx.prd_redistribute()
    jctx.formal_sol_gamma_matrices()
    jctx.stat_equil()
    inject(tctx, jctx)
    rec = {'paramsPre': _snapshot(jctx.build_params())}
    ju = jctx.prd_redistribute()
    lines = [(ai, ti) for ai, ti, a, t in jctx._prd_lines()]
    rec['redistributed'] = {
        'dRho': ju.dRho, 'NprdSubIter': ju.NprdSubIter, 'J': _np(jctx.J),
        'JRest': _np(jctx.JRest),
        'rho': [_np(jctx.rhoPrd[ai][ti]) for ai, ti in lines],
        'Rij': [_np(jctx._Rij[ai][ti]) for ai, ti in lines],
        'Rji': [_np(jctx._Rji[ai][ti]) for ai, ti in lines]}
    rec['paramsPost'] = _snapshot(jctx.build_params())
    ju = jctx.formal_sol_gamma_matrices()
    rec['iteration'] = {
        'Gamma': [_np(G) for G in jctx._Gamma],
        'Rij': [[_np(x) for x in r] for r in jctx._Rij],
        'Rji': [[_np(x) for x in r] for r in jctx._Rji],
        'J': _np(jctx.J), 'I': _np(jctx.I), 'dJ': float(ju.dJMax),
        'JRest': _np(jctx.JRest)}
    return jctx, tctx, rec


@pytest.fixture(scope='module')
def prd():
    return stepped(hprd=False)


def per_wavelength(ours, ref):
    """max over wavelengths of max|ours - ref| / max|ref| along the other
    axis (J and I span tens of decades over wavelength)."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    return (np.abs(ours - ref).max(axis=1) / np.abs(ref).max(axis=1)).max()


def compare_iteration(out, ref):
    for ai in range(len(ref['Gamma'])):
        e = relerr(out['Gamma'][ai], ref['Gamma'][ai])
        assert e < 1e-10, ('Gamma', ai, e)
        for key in ('Rij', 'Rji'):
            for ti, x in enumerate(out[key][ai]):
                e = relerr(x, ref[key][ai][ti])
                assert e < 1e-10, (key, ai, ti, e)
    for key in ('J', 'I'):
        e = per_wavelength(out[key], ref[key])
        assert e < 1e-9, (key, e)
    assert relerr(out['dJ'], ref['dJ']) < 1e-10


def compare_subset_stage(jctx, tctx, params):
    """The port's build_prd_subset_fn against the JAX one on the same
    params: J and I per wavelength to 1e-9, dJ and the PRD lines' rates
    to 1e-10 (and JRest per wavelength under hybrid PRD)."""
    sub = jctx._prd_subset_idxs()
    lines = [(ai, ti) for ai, ti, a, t in jctx._prd_lines()]
    ref = j_build_prd_subset_fn(jctx.cfg, sub, lines)(params)
    out = build_prd_subset_fn(tctx.cfg, sub, lines)(
        params_from_numpy(params, tctx.cfg))
    assert out['J'].shape == (len(sub), NSPACE)
    assert out['I'].shape == (len(sub), NRAYS)
    for key in ('J', 'I') + (('JRest',) if jctx.cfg.hprd else ()):
        e = per_wavelength(out[key], ref[key])
        assert e < 1e-9, (key, e)
    assert relerr(out['dJ'], ref['dJ']) < 1e-10
    for key in ('Rij', 'Rji'):
        for li in range(len(lines)):
            e = relerr(out[key][li], ref[key][li])
            assert e < 1e-10, (key, li, e)


def compare_redistribute(tctx, ref, hprd):
    """The port's prd_redistribute from the injected state against the
    JAX one's records."""
    tu = tctx.prd_redistribute()
    assert tu.updatedRho and tu.NprdSubIter == ref['NprdSubIter']
    np.testing.assert_allclose(tu.dRho, ref['dRho'], rtol=1e-9)
    lines = [(ai, ti) for ai, ti, a, t in tctx._prd_lines()]
    for li, (ai, ti) in enumerate(lines):
        rho = tctx.rhoPrd[ai][ti]
        assert isinstance(rho, torch.Tensor)
        assert np.abs(ref['rho'][li] - 1.0).max() > 1.0
        e = relerr(rho, ref['rho'][li], floorRel=0.0)
        assert e < 1e-9, ('rho', ti, e)
        for key in ('Rij', 'Rji'):
            e = relerr(getattr(tctx, '_' + key)[ai][ti], ref[key][li])
            assert e < 1e-10, (key, ti, e)
    assert per_wavelength(tctx.J, ref['J']) < 1e-9
    if hprd:
        assert per_wavelength(tctx.JRest, ref['JRest']) < 1e-9


def test_prd_subset_idxs_match_jax():
    """The PRD subset (the union of the PRD windows) and hybrid PRD's
    wider one, with the inclusive one-point scan on each side, equal
    JAX's; under hybrid PRD it holds points outside every window."""
    subs = {}
    for hprd in (False, True):
        jctx, tctx = h6_pair(hprd)
        sub = tctx._prd_subset_idxs()
        np.testing.assert_array_equal(sub, jctx._prd_subset_idxs())
        assert len(sub) < tctx.cfg.Nlam
        subs[hprd] = set(sub.tolist())
        if hprd:
            np.testing.assert_array_equal(tctx.cfg.prdIdxs,
                                          jctx.cfg.prdIdxs)
            for key, (i0, frac) in jctx.cfg.hprdCoeffs.items():
                np.testing.assert_array_equal(tctx.cfg.hprdCoeffs[key][0],
                                              i0)
                np.testing.assert_array_equal(tctx.cfg.hprdCoeffs[key][1],
                                              frac)
    assert subs[False] < subs[True]


def test_prd_subset_stage_matches_jax(prd):
    jctx, tctx, rec = prd
    compare_subset_stage(jctx, tctx, rec['paramsPre'])


def test_prd_subset_rows_equal_the_full_grid(prd):
    """The subset formal solution reproduces the full-grid one on its rows
    from the same state: the same chi/srcNum sums on each row, so J and
    the PRD lines' Rij agree to rounding (the JAX package's
    test_prd_subset_fs_matches_full_grid holds 1e-9 and 1e-6)."""
    _, tctx, rec = prd
    params = params_from_numpy(rec['paramsPre'], device='cpu')
    full = tctx._iter_fn({**params, 'pack': None})
    sub = tctx._prd_subset_idxs()
    lines = [(ai, ti) for ai, ti, a, t in tctx._prd_lines()]
    out = build_prd_subset_fn(tctx.cfg, sub, lines)(params)
    assert relerr(out['J'], full['J'][sub], floorRel=0.0) < 1e-12
    assert relerr(out['I'], full['I'][sub], floorRel=0.0) < 1e-12
    for li, (ai, ti) in enumerate(lines):
        assert relerr(out['Rij'][li], full['Rij'][ai][ti]) < 1e-12


def test_prd_redistribute_matches_jax(prd):
    _, tctx, rec = prd
    compare_redistribute(tctx, rec['redistributed'], hprd=False)


@pytest.mark.parametrize('mode', ['prdNgOptions', 'prdFsMode'])
def test_prd_redistribute_modes_match_jax(prd, mode):
    """prd_redistribute's two non-default modes against the JAX
    package's, from the JAX Context's current state: persistent Ng on rho
    (NgOptions(2, 2, 0); two calls of three sub-iterations, so that the
    extrapolation fires once in each) and the full-grid MALI step in place
    of the subset solve (prdFsMode='full', one call).  Same bars as
    test_prd_redistribute_matches_jax, dRho to 1e-9 absolute; under
    'full' also Gamma."""
    jctx = prd[0]
    tctx = port_context(hprd=False)
    inject(tctx, jctx)
    if mode == 'prdNgOptions':
        jctx.prdNgOptions, tctx.prdNgOptions = JNgOptions(2, 2, 0), \
            NgOptions(2, 2, 0)
    else:
        jctx.prdFsMode = tctx.prdFsMode = 'full'
    try:
        for _ in range(2 if mode == 'prdNgOptions' else 1):
            ju = jctx.prd_redistribute(tol=0.0)
            tu = tctx.prd_redistribute(tol=0.0)
            assert tu.NprdSubIter == ju.NprdSubIter == 3
            # dRho is itself a relative change of rho (1e-3 once rho
            # settles): held absolutely, at rho's bar
            np.testing.assert_allclose(tu.dRho, ju.dRho, rtol=0.0,
                                       atol=1e-9)
        if mode == 'prdNgOptions':
            assert [ng.count for ng in tctx._prdNgs] == [7, 7]
        else:
            for ai in range(len(jctx.activeAtoms)):
                assert relerr(tctx._Gamma[ai], _np(jctx._Gamma[ai])) < 1e-10
        for ai, ti, a, t in tctx._prd_lines():
            e = relerr(tctx.rhoPrd[ai][ti], _np(jctx.rhoPrd[ai][ti]),
                       floorRel=0.0)
            assert e < 1e-9, ('rho', ti, e)
            for key in ('_Rij', '_Rji'):
                e = relerr(getattr(tctx, key)[ai][ti],
                           _np(getattr(jctx, key)[ai][ti]))
                assert e < 1e-10, (key, ti, e)
        assert per_wavelength(tctx.J, _np(jctx.J)) < 1e-9
    finally:
        jctx.prdNgOptions, jctx._prdNgs, jctx.prdFsMode = None, None, \
            'subset'


@pytest.mark.parametrize('scheme', SCHEMES)
def test_iteration_with_rho_matches_jax(prd, scheme):
    """One MALI iteration with the redistributed rho under each scheme
    against the JAX default scheme on the same params."""
    _, tctx, rec = prd
    cfg = dataclasses.replace(tctx.cfg, fsIterScheme=scheme)
    out = build_iteration_fn(cfg)(params_from_numpy(rec['paramsPost'], cfg))
    compare_iteration(out, rec['iteration'])


@pytest.mark.parametrize('scheme', SCHEMES[1:])
def test_kernel_schemes_take_the_live_rho(scheme):
    """H 6 + Mg II, 12 depths, 2 rays: under each kernel scheme, the
    Context's iteration after prd_redistribute (its params and packs are
    cached from the first call) matches the default scheme's iteration on
    freshly built params of the same state.  A rho packed once and reused
    would converge, to a wrong answer (Gamma off by 1.1 of its maximum,
    measured).  Mg II's four overlapping lines form one line-kernel
    group; the fused scheme colours three slots.  The rates agree to
    1e-10 above a floor of 1e-10 of each maximum (2.4e-13 measured),
    Gamma to 1e-10 above a floor of 1e-6 (2.0e-12 measured): the entries
    below it, 1e-9 of H's maximum, are differences of far larger terms
    that the schemes form in another order (test_torch_gamma's
    comparison has the same floor)."""
    ctx = h6mg_context(falc_interpolated(12), 2, device='cpu')
    ctx.set_fs_iter_scheme(scheme)
    mg = ctx.activeAtoms[1]
    assert max(len(g) for g in tgamma.line_groups(mg)) == 4
    assert tfused.assign_line_slots(ctx.cfg.allAtoms)[1] == 3
    for _ in range(2):
        ctx.formal_sol_gamma_matrices()
        ctx.stat_equil()
        ctx.prd_redistribute()
    assert max(float((r - 1.0).abs().max()) for row in ctx.rhoPrd
               for r in row if r is not None) > 0.1
    params = ctx.build_params()
    default = dataclasses.replace(ctx.cfg, fsIterScheme=SCHEMES[0])
    ref = build_iteration_fn(default)({**params, 'pack': None})
    ctx.formal_sol_gamma_matrices()
    out = {'Gamma': ctx._Gamma, 'Rij': ctx._Rij, 'Rji': ctx._Rji,
           'J': ctx.J, 'I': ctx.I}
    for ai in range(2):
        assert relerr(out['Gamma'][ai], ref['Gamma'][ai], 1e-6) < 1e-10
        for key in ('Rij', 'Rji'):
            for ti, x in enumerate(out[key][ai]):
                assert relerr(x, ref[key][ai][ti]) < 1e-10, (key, ai, ti)
    for key in ('J', 'I'):
        assert per_wavelength(out[key], ref[key]) < 1e-9, key
