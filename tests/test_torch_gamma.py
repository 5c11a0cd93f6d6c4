"""The line Gamma kernel's plain version (ops/gamma.py) and the port's
'mali_full_precond_pallas' scheme, against the JAX package.

The JAX kernel lightweaver_tpu/ops/pallas_gamma.py:group_gamma_rates runs
in Pallas interpret mode on the CPU, as the JAX package's own tests run
it.  It takes S and chiTot where the port takes srcNum; the test forms
srcNum = S * chiTot in numpy, the same product the JAX kernel forms, so
both see one value.  Its lambda blocks are 16 rows aligned to the global
grid, the port's 8 rows of the window: G4 is compared summed over blocks.
The port packs every group of every active atom into one table and one
call (ops/gamma.py:LineTable, line_gamma_rates); the packed plain version
is held to the per-group one and to the JAX kernel group by group.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.atomic_set import RadiativeSet as JRadiativeSet
from lightweaver_tpu.context import Context as JContext
from lightweaver_tpu.ops.pallas_gamma import BW as J_BW
from lightweaver_tpu.ops.pallas_gamma import aligned_window as j_aligned_window
from lightweaver_tpu.ops.pallas_gamma import \
    group_gamma_rates as j_group_gamma_rates
from lightweaver_tpu.ops.pallas_gamma import line_groups as j_line_groups
from lightweaver_tpu_torch import context as tcontext
from lightweaver_tpu_torch.context import build_iteration_fn, line_pack
from lightweaver_tpu_torch.convert import params_from_numpy
from lightweaver_tpu_torch.ops import gamma as tgamma
from lightweaver_tpu_torch.problems import (falc_interpolated, h6ca_context,
                                            h6mg_context, random_line_group)

from tests.test_torch_slice import (NRAYS, NSPACE, _jax_falc_interpolated,
                                    relerr)

PALLAS = 'mali_full_precond_pallas'

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def _jax_layout(x):
    """Port ray layout [2, NL, Nmu, Nk] -> the JAX kernel's [NL, 2Nmu, Nk]
    (md = mu*2 + d)."""
    x = np.moveaxis(x, 0, 2)
    return x.reshape(x.shape[0], -1, x.shape[-1])


@pytest.mark.parametrize('K', [1, 3, 5, 6])
def test_plain_group_kernel_matches_jax(K):
    """K = 1, K = 3 with three pair moments, and K = 5, 6 (past the
    kernel's templated sizes) with 10 and 15, rho != 1: block-summed G4,
    PPB and PairPPB to 1e-12 of each output's maximum (the two sum the
    same terms in another order)."""
    Nlam, Nmu, Nk, row0, Wu = 64, 2, 12, 16, 32
    g = random_line_group(K, Nlam, Nmu, Nk, row0=row0, Wu=Wu, seed=K)
    levels = g.pop('levels')
    assert g.pop('row0') == row0
    rng = np.random.default_rng(10 + K)
    chiTot = rng.uniform(0.5, 2.0, g['srcNum'].shape)
    S = g['srcNum'] / chiTot
    g['srcNum'] = S * chiTot
    ts = [type('T', (), {'i': i, 'j': j}) for i, j in levels]
    st = tgamma.group_statics(ts)

    ours = tgamma.group_gamma_rates(
        **{k: torch.as_tensor(v) for k, v in g.items()}, st=st, row0=row0)
    M2 = 2 * Nmu
    phiJ = np.moveaxis(g['phi'], 1, 3).reshape(K, Wu, M2, Nk)
    ref = j_group_gamma_rates(
        phiJ, g['rho'], *(_jax_layout(g[k]) for k in
                          ('Psi', 'IeffBase', 'I')),
        _jax_layout(S), _jax_layout(chiTot), g['chiCL'], g['UCL'],
        g['etaC'], g['n'], g['coef'], g['wphi'],
        wmuHalf=tuple(g['wmuHalf']), levels=tuple(levels),
        signs=tuple(tuple((float(a), float(b)) for a, b in row)
                    for row in st.signs),
        uIn=tuple(tuple((float(a), float(b)) for a, b in row)
                  for row in st.uIn),
        alignedNblue=row0)
    G4, PPB, PairPPB = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(ours[0].sum(dim=2).numpy() / np.abs(G4).max(),
                               G4.sum(axis=2) / np.abs(G4).max(), rtol=0,
                               atol=1e-12)
    for a, b in ((ours[1], PPB), (ours[2], PairPPB)):
        scale = max(np.abs(b).max(), 1e-300)
        np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=0,
                                   atol=1e-12)


@pytest.fixture(scope='module')
def ctx():
    """The slice test's 30-depth, 3-ray problem after two MALI steps."""
    c = h6ca_context(falc_interpolated(NSPACE), NRAYS, device='cpu')
    for _ in range(2):
        c.formal_sol_gamma_matrices()
        c.stat_equil()
    return c


def test_line_groups_match_jax(ctx):
    """The same groups as the JAX helper; on falc_h6ca ten one-line H
    groups and the Ca II groups {0-3, 0-4}, {1-4, 2-4}, {1-3}."""
    H, Ca = ctx.activeAtoms
    for a in (H, Ca):
        assert tgamma.line_groups(a) == j_line_groups(a)
    assert [len(g) for g in tgamma.line_groups(H)] == [1] * 10
    assert sorted(tuple((Ca.trans[t].i, Ca.trans[t].j) for t in g)
                  for g in tgamma.line_groups(Ca)) == \
        [((0, 3), (0, 4)), ((1, 3),), ((1, 4), (2, 4))]


def _compare(out, ref, tol, floorRel, keys=('J', 'I', 'dJ')):
    for ai in range(2):
        e = relerr(out['Gamma'][ai], ref['Gamma'][ai], floorRel)
        assert e < tol, ('Gamma', ai, e)
        for key in ('Rij', 'Rji'):
            for ti, x in enumerate(out[key][ai]):
                e = relerr(x, ref[key][ai][ti], floorRel)
                assert e < tol, (key, ai, ti, e)
    for key in keys:
        e = relerr(out[key], ref[key], floorRel)
        assert e < tol, (key, e)


def test_pallas_scheme_matches_default(ctx):
    """The scheme's iteration against the default scheme on the same
    params: the line kernel sums the same products in another order.
    Gamma/Rij/Rji/J/I/dJ agree to 1e-12 relative above a floor of 1e-6
    of each array's maximum (1.9e-13 measured).  Below it sit Gamma
    entries that are differences of far larger terms; there the two
    differ by rounding of the large terms (5e-18 of the maximum measured,
    2.6e-11 relative at an entry 1e-9 of the maximum)."""
    params = ctx.build_params()
    outs = {}
    for scheme in ('mali_full_precond', PALLAS):
        cfg = dataclasses.replace(ctx.cfg, fsIterScheme=scheme)
        outs[scheme] = build_iteration_fn(cfg)({**params, 'pack': None})
    _compare(outs[PALLAS], outs['mali_full_precond'], 1e-12, 1e-6)


@pytest.mark.slow
def test_pallas_iteration_matches_jax_pallas_scheme():
    """One iteration of the port's scheme against the JAX package's
    iteration under the same scheme name (interpret mode), on the same
    params: the tolerances of test_torch_slice's comparison."""
    atmos = _jax_falc_interpolated(NSPACE)
    atmos.quadrature(NRAYS)
    rs = JRadiativeSet([jatoms.H_6_atom(), jatoms.CaII_atom()])
    rs.set_active('H', 'Ca')
    spect = rs.compute_wavelength_grid()
    jctx = JContext(atmos, spect, rs.compute_eq_pops(atmos),
                    fsIterScheme=PALLAS)
    tctx = h6ca_context(falc_interpolated(NSPACE), NRAYS, device='cpu')
    tctx.set_fs_iter_scheme(PALLAS)
    for _ in range(2):
        jctx.formal_sol_gamma_matrices()
        jctx.stat_equil()
    out = tctx._iter_fn(params_from_numpy(jctx.build_params(), tctx.cfg))
    ju = jctx.formal_sol_gamma_matrices()
    ref = {'Gamma': jctx._Gamma, 'Rij': jctx._Rij, 'Rji': jctx._Rji,
           'dJ': ju.dJMax}
    _compare(out, ref, 1e-10, 1e-10, keys=('dJ',))
    for key, r in (('J', jctx.J), ('I', jctx.I)):
        ours, r = np.asarray(out[key]), np.asarray(r)
        e = (np.abs(ours - r).max(axis=1) / np.abs(r).max(axis=1)).max()
        assert e < 1e-9, (key, e)
    assert jax.default_backend() == 'cpu'


@pytest.fixture(scope='module')
def prd_ctx():
    """falc_h6mg at 20 depths and 3 rays after one MALI step and one
    prd_redistribute: rho != 1 on its PRD lines, Mg II's K = 4 group."""
    c = h6mg_context(falc_interpolated(20), 3, device='cpu')
    c.formal_sol_gamma_matrices()
    c.stat_equil()
    c.prd_redistribute(maxIter=1)
    return c


def _line_call(c):
    """The scheme's table and the arguments of line_gamma_rates for one
    iteration of ``c``, with srcNum = S chiTot formed in numpy (module
    docstring), and S and chiTot for the JAX kernel."""
    itP = build_iteration_fn(dataclasses.replace(c.cfg, fsIterScheme=PALLAS))
    params = c.build_params()
    chi, src = itP.gather(params, itP.scaJ(params))
    I, Psi, IeffB, _ = itP.formal_solve(params, chi, src)
    S = src.numpy() / chi.numpy()
    src = torch.as_tensor(S * chi.numpy())
    table = itP.pack(params)
    args = itP.line_inputs(params, I, Psi, IeffB, src, table)
    return table, args, S, chi.numpy()


def _jax_group(gargs, S, chiTot):
    """group_gamma_rates of the JAX package on one group's port arguments:
    the window padded to its 16-row alignment (zero coefficient rows, rho
    one), the ray rows to a multiple of 16.  Returns G4 summed over its
    blocks [K, 4, Nk] and PPB, PairPPB on the port's window."""
    (phi, rho, Psi, IeffB, I, _, chiCL, UCL, etaC, n, coef, wphi, wmuHalf,
     st, row0) = [x.numpy() if torch.is_tensor(x) else x for x in gargs]
    K, _, Wu, Nmu, Nk = phi.shape
    aNb, WuA, padLo, padHi = j_aligned_window(row0, row0 + Wu)
    Nlam = Psi.shape[1]
    NlamPad = -(-Nlam // J_BW) * J_BW

    def rows(x, axis, value=0.0):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (padLo, padHi)
        return np.pad(x, pad, constant_values=value)

    def lam(x, axis):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (0, NlamPad - Nlam)
        return np.pad(x, pad)
    phiJ = np.moveaxis(rows(phi, 2), 1, 3).reshape(K, WuA, 2 * Nmu, Nk)
    G4, PPB, PairPPB = (np.asarray(x) for x in j_group_gamma_rates(
        phiJ, rows(rho, 1, 1.0), *(lam(_jax_layout(x), 0) for x in (
            Psi, IeffB, I, S, chiTot)), lam(chiCL, 1), lam(UCL, 1),
        lam(etaC, 0), n, rows(coef, 1), wphi,
        wmuHalf=tuple(wmuHalf), levels=tuple(st.levels),
        signs=tuple(tuple((float(a), float(b)) for a, b in r)
                    for r in st.signs),
        uIn=tuple(tuple((float(a), float(b)) for a, b in r) for r in st.uIn),
        alignedNblue=aNb))
    win = slice(padLo, padLo + Wu)
    return (G4.sum(axis=2), PPB[:, win],
            PairPPB[:, win])


def _check_table_records(table, Nmu, Nk):
    """The table's groups sit end to end in the packed inputs and outputs;
    its int32 records hold each group's sizes, offsets, stacked levels and
    the sign and U bit masks of its statics (csrc/gamma.cu:LineGroup); one
    work item per (group, row block, depth tile)."""
    meta = table.meta.numpy()
    assert meta.shape == (len(table.groups), 12 + 5 * tgamma.KMAX)
    ends = dict.fromkeys(('phi', 'coef', 'wphi', 'rho', 'g4', 'ppb',
                          'pair'), 0)
    items = set()
    for gi, g in enumerate(table.groups):
        assert g.nBlk == -(-g.Wu // tgamma.BW)
        P = max(1, g.K * (g.K - 1) // 2)
        sizes = {'phi': g.K * 2 * g.Wu * Nmu * Nk, 'coef': g.K * g.Wu * 4,
                 'wphi': g.K * Nk, 'rho': g.K * g.Wu * Nk,
                 'g4': g.K * 4 * g.nBlk * Nk, 'ppb': g.K * g.Wu * Nk,
                 'pair': P * g.Wu * Nk}
        for key, size in sizes.items():
            assert getattr(g, key + 'Off') == ends[key]
            ends[key] += size
        levels = [g.levOff + lv for ij in g.statics.levels for lv in ij]
        nLev = 12 + 2 * tgamma.KMAX
        assert list(meta[gi, :nLev]) == [
            g.K, g.row0, g.Wu, g.nBlk, g.ai, g.phiOff, g.coefOff,
            g.wphiOff, g.rhoOff, g.g4Off, g.ppbOff, g.pairOff] + \
            levels + [0] * (2 * tgamma.KMAX - len(levels))
        masks = meta[gi, nLev:].reshape(tgamma.KMAX, 3).astype(int)
        assert not masks[g.K:].any()
        for m in range(g.K):
            for m2 in range(g.K):
                sI, sJ = g.statics.signs[m][m2]
                inI, inJ = g.statics.uIn[m][m2]
                bits = [(masks[m, w] >> (h + m2)) & 1 for w in range(3)
                        for h in (0, 16)]
                assert bits == [sI > 0, sI < 0, sJ > 0, sJ < 0, inI, inJ]
        items |= {(gi, b, t) for b in range(g.nBlk)
                  for t in range(-(-Nk // tgamma.TK))}
    assert tuple(table.sizes) == (ends['g4'], ends['ppb'], ends['pair'])
    assert table.phi.numel() == ends['phi']
    assert torch.equal(table.rho, torch.ones(ends['rho'],
                                             dtype=table.rho.dtype))
    got = [tuple(x) for x in table.items.numpy().tolist()]
    assert len(got) == len(items) == table.nItems and set(got) == items


def test_line_table_matches_groups(ctx, prd_ctx):
    """The table holds each active atom's line_groups in order, with
    group_statics of the members and the atom's level offset in the
    stacked rows, and its records as _check_table_records says."""
    for c in (ctx, prd_ctx):
        table = line_pack(c.cfg, c.build_params())
        want = [(ai, tuple(g)) for ai, a in enumerate(c.activeAtoms)
                for g in tgamma.line_groups(a)]
        assert [(g.ai, g.members) for g in table.groups] == want
        for g in table.groups:
            a = c.activeAtoms[g.ai]
            ts = [a.trans[ti] for ti in g.members]
            assert g.statics == tgamma.group_statics(ts)
            assert g.levOff == sum(x.Nlevel for x in c.activeAtoms[:g.ai])
            assert g.nLev == a.Nlevel
            assert (g.K, g.row0, g.Wu) == (len(ts), min(t.Nblue for t in ts),
                                           max(t.Nred for t in ts)
                                           - min(t.Nblue for t in ts))
        _check_table_records(table, c.cfg.Nmu, c.cfg.Nk)


def test_line_table_takes_a_group_of_six():
    """A table of random groups of K = 2, 6 and 1 (the K = 6 one past the
    kernel's templated sizes, 15 pair rows, members sharing five levels):
    the statics of its members, its records, and the plain packed version
    equal to the per-group one.  A group past KMAX raises."""
    Nlam, Nmu, Nk = 48, 2, 40
    groups, cases = [], []
    for K, row0, Wu, seed in ((2, 3, 10, 1), (6, 10, 30, 2), (1, 40, 5, 3)):
        g = random_line_group(K, Nlam, Nmu, Nk, row0=row0, Wu=Wu, seed=seed)
        st = tgamma.group_statics([type('T', (), {'i': i, 'j': j})
                                   for i, j in g['levels']])
        t_ = torch.as_tensor
        groups.append({'ai': 0, 'members': tuple(range(K)), 'row0': row0,
                       'phi': t_(g['phi']), 'coef': t_(g['coef']),
                       'wphi': t_(g['wphi']), 'statics': st})
        cases.append(g)
    table = tgamma.LineTable(groups, [5], Nmu, Nk)
    assert [g.K for g in table.groups] == [2, 6, 1]
    six = table.groups[1]
    assert six.statics.levels == ((0, 1), (0, 2), (1, 2), (2, 3), (0, 3),
                                  (1, 3))
    # member (1, 2): chi_i (level 1) gains (1, 2) and (1, 3), loses (0, 1);
    # chi_j (level 2) loses (0, 2), (1, 2), gains (2, 3)
    assert six.statics.signs[2] == ((-1, 0), (0, -1), (1, -1), (0, 1),
                                    (0, 0), (1, 0))
    assert table.maxK == 6
    assert [tuple(x) for x in table.items[:3].tolist()] == [
        (1, 0, 0), (1, 0, 1), (1, 1, 0)]
    _check_table_records(table, Nmu, Nk)

    rays = {k: torch.as_tensor(cases[1][k]) for k in
            ('Psi', 'IeffBase', 'I', 'srcNum', 'chiCL', 'UCL', 'n',
             'wmuHalf')}
    rho = torch.cat([torch.as_tensor(g['rho']).reshape(-1) for g in cases])
    args = (table, rho, rays['Psi'], rays['IeffBase'], rays['I'],
            rays['srcNum'], rays['chiCL'], rays['UCL'],
            torch.as_tensor(cases[1]['etaC'])[None], rays['n'],
            rays['wmuHalf'])
    packed = table.views(*tgamma.line_gamma_rates(*args))
    for gi, out in enumerate(packed):
        ref = tgamma.group_gamma_rates(*table.group_args(gi, *args[1:]))
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match='outside the kernel'):
        tgamma.LineTable([{**groups[1], 'phi': groups[1]['phi'].repeat(
            3, 1, 1, 1, 1)}], [5], Nmu, Nk)


@pytest.mark.parametrize('problem', ['falc_h6ca', 'falc_h6mg_prd'])
def test_packed_line_plain_matches_groups_and_jax(problem, ctx, prd_ctx):
    """The packed plain version on every group of one iteration (falc_h6ca's
    13 groups; falc_h6mg's with rho != 1 and its K = 4 group) equals the
    per-group plain version exactly, and the JAX kernel in interpret mode
    to 1e-12 of each output's maximum (the same terms summed in another
    order; G4 summed over the blocks)."""
    c = ctx if problem == 'falc_h6ca' else prd_ctx
    table, args, S, chiTot = _line_call(c)
    packed = tgamma.line_gamma_rates(*args)
    Ks, rhoDev = [], 0.0
    for gi, got in enumerate(table.views(*packed)):
        gargs = table.group_args(gi, *args[1:])
        Ks.append(table.groups[gi].K)
        rhoDev = max(rhoDev, (gargs[1] - 1.0).abs().max().item())
        for a, b in zip(got, tgamma.group_gamma_rates_plain(*gargs)):
            assert torch.equal(a, b)
        ref = _jax_group(gargs, S, chiTot)
        for name, a, b in zip(('G4', 'PPB', 'PairPPB'),
                              (got[0].sum(dim=2), got[1], got[2]), ref):
            scale = max(np.abs(b).max(), 1e-300)
            err = np.abs(a.numpy() - b).max() / scale
            assert err < 1e-12, (gi, name, err)
    if problem == 'falc_h6ca':
        assert len(Ks) == 13
    else:
        assert max(Ks) == 4 and rhoDev > 0.0


@pytest.mark.parametrize('case', ['default', 'fused', 'pallas', 'hprd'])
def test_step_forms_each_transition_once(case, monkeypatch):
    """One MALI step after a warm-up (falc at 20 depths: H 6 + Ca II under
    the three schemes, H 6 + Mg II under hybrid PRD with rho != 1)
    evaluates _uv at most once per transition: every stage reads the
    step's table (context.transition_terms).  Rows [lo, hi) of each entry
    are bit for bit the row-range _uv and its chi and eta, on the whole
    window and on sub-ranges at its ends and inside it."""
    if case == 'hprd':
        c = h6mg_context(falc_interpolated(20), 5, hprd=True, device='cpu')
    else:
        c = h6ca_context(falc_interpolated(20), 5, device='cpu')
        if case != 'default':
            c.set_fs_iter_scheme('mali_full_precond_' + case)
    c.formal_sol_gamma_matrices()
    c.stat_equil()
    if case == 'hprd':
        c.prd_redistribute(maxIter=1)

    counts = {}
    uv = tcontext._uv

    def counting(cfg, params, ai, ti, t, lo=None, hi=None):
        counts[(ai, ti)] = counts.get((ai, ti), 0) + 1
        return uv(cfg, params, ai, ti, t, lo, hi)
    monkeypatch.setattr(tcontext, '_uv', counting)
    c.formal_sol_gamma_matrices()
    monkeypatch.undo()
    assert counts and max(counts.values()) == 1, counts

    cfg = c.cfg
    params = tcontext._working_params(cfg, c.build_params())
    for ai, a in enumerate(cfg.allAtoms):
        for ti, t in enumerate(a.trans):
            terms = tcontext.transition_terms(cfg, params, ai, ti)
            assert tcontext.transition_terms(cfg, params, ai, ti) is terms
            W, b = t.W, t.Nblue
            for lo, hi in ((0, W), (0, 1), (W // 3, 2 * W // 3 + 1),
                           (W - 2, W)):
                part = tcontext._uv(cfg, params, ai, ti, t, b + lo, b + hi)
                part = (*part, *tcontext._chi_eta(params, ai, t, part))
                for x, y in zip(terms, part):
                    assert torch.equal(x[:, lo:hi], y), (ai, ti, lo, hi)
