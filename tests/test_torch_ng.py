"""Ng acceleration of the populations in the port against the JAX package.

The small problem: FAL-C interpolated to 12 depths (bench.py's
interpolation), 2 rays, H 6-level + Ca II active, Ng(Norder=2,
Nperiod=3, Ndelay=14), 3 Lambda iterations and then 27 MALI steps each
followed by stat_equil (first extrapolation at the 13th stat_equil, five
in all).  From the LTE start this problem's first iterates swing by
factors of 10-1000; an earlier Ndelay (4-10) extrapolates them to
negative populations in the port and the JAX package alike, after which
the two runs are noise.  Ndelay = 14 keeps every population positive.

Two port Contexts run beside one JAX Context:

- in lockstep: before each step the port takes the JAX Context's J,
  populations and Ng history, so each step is compared on identical
  inputs.  After a stat_equil without extrapolation the populations agree
  within 1e-9 (relative, floor 1e-10 of the maximum; 9.4e-11 measured).
  An extrapolation amplifies the solve's ~1e-11 differences: its
  least-squares fit divides differences of nearly equal iterates, and the
  closer the run is to converged the worse the fit is conditioned (the
  first four extrapolations: 1.9e-10 at most; the fifth, at the 25th
  stat_equil, takes 2.8e-11 to 4.9e-9).  Those steps are held to 1e-8,
  and every step extrapolates where the JAX one does;
- free-running from the same start: the amplified differences carry
  into the next steps (5.2e-9 at most), held to 1e-8, with the same
  iterations extrapolated.

The two kernel schemes on the CPU (their plain versions) are held to the
default scheme in lockstep over the first three extrapolations:
`_pallas` at 1e-10 (4.0e-11 measured), `_fused` at 1e-9 (1.5e-10
measured: its chunked-scan depth sums run in another order, which the
stat-eq solve amplifies as in tests/test_torch_slice.py).  The float32
state is held in lockstep with the JAX float32 Context through its first
extrapolation, errors normalised per depth by the largest population.
BASELINE config 2 (falc_multi_ng:
H 6 + Ca II + Na I active, Mg II passive, Ng(2, 5, 50)) is checked for
its golden inputs, one iteration against the JAX Context and the first
three dJ against the golden run; its convergence is marked slow.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.atomic_set import RadiativeSet as JRadiativeSet
from lightweaver_tpu.context import Context as JContext
from lightweaver_tpu.fal import Falc82 as JFalc82
from lightweaver_tpu.ops.ng import NgOptions as JNgOptions
from lightweaver_tpu_torch import (CaII_atom, ExplodingMatrixError, H_6_atom,
                                   RadiativeSet, iterate_ctx_se)
from lightweaver_tpu_torch.context import Context
from lightweaver_tpu_torch.ops.ng import NgOptions
from lightweaver_tpu_torch.problems import falc_interpolated, multi_ng_context

from tests.test_torch_slice import _jax_falc_interpolated, relerr

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')
NSPACE, NRAYS = 12, 2
NG = (2, 3, 14)
NSCATTER, NITER = 3, 30
SCHEMES = ('mali_full_precond', 'mali_full_precond_pallas',
           'mali_full_precond_fused')

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def jax_context(dtype=None, **options):
    """The JAX Context of the small H 6 + Ca II problem."""
    atmos = _jax_falc_interpolated(NSPACE)
    atmos.quadrature(NRAYS)
    rs = JRadiativeSet([jatoms.H_6_atom(), jatoms.CaII_atom()])
    rs.set_active('H', 'Ca')
    spect = rs.compute_wavelength_grid()
    return JContext(atmos, spect, rs.compute_eq_pops(atmos), dtype=dtype,
                    **options)


def port_context(**options):
    """The port Context of the small H 6 + Ca II problem on the CPU."""
    atmos = falc_interpolated(NSPACE)
    atmos.quadrature(NRAYS)
    rs = RadiativeSet([H_6_atom(), CaII_atom()])
    rs.set_active('H', 'Ca')
    spect = rs.compute_wavelength_grid()
    return Context(atmos, spect, rs.compute_eq_pops(atmos), device='cpu',
                   **options)


def copy_ng(dst, src):
    """Ng history of ``src`` (the JAX package's or the port's) into
    ``dst``."""
    dst.previous = np.array(src.previous, copy=True)
    dst.count, dst.init, dst.len = src.count, src.init, src.len


def sync(dst, src):
    """J, the populations and the Ng histories of Context ``src`` (JAX or
    port) into the port Context ``dst``."""
    def host(x):
        return np.array(x.cpu() if torch.is_tensor(x) else x, np.float64)
    dst.J = torch.as_tensor(host(src.J), dtype=dst.accumDtype)
    for st, sst in zip(dst.popsState, src.popsState):
        st['n'] = torch.as_tensor(host(sst['n']), dtype=torch.float64)
    for ng, sng in zip(dst.ngs, src.ngs):
        copy_ng(ng, sng)


def pops_err(a, b):
    return max(relerr(x['n'], y['n']) for x, y in zip(a.popsState,
                                                     b.popsState))


@pytest.fixture(scope='module')
def runs():
    """The JAX run with a lockstep and a free-running port Context beside
    it; per stat_equil: (lockstep error, free error, JAX flag, lockstep
    flag, free flag, JAX dPops, lockstep dPops)."""
    jctx = jax_context(ngOptions=JNgOptions(*NG))
    lock = port_context(ngOptions=NgOptions(*NG))
    free = port_context(ngOptions=NgOptions(*NG))
    rows = []
    for it in range(NITER):
        sync(lock, jctx)
        for c in (jctx, lock, free):
            c.formal_sol_gamma_matrices()
        if it < NSCATTER:
            continue
        ju, lu, fu = (c.stat_equil() for c in (jctx, lock, free))
        rows.append((pops_err(lock, jctx), pops_err(free, jctx),
                     ju.ngAccelerated, lu.ngAccelerated, fu.ngAccelerated,
                     ju.dPops, lu.dPops))
    return jctx, lock, free, rows


def test_lockstep_pops_match_jax(runs):
    plain = [r[0] for r in runs[3] if not r[2]]
    extrapolated = [r[0] for r in runs[3] if r[2]]
    assert max(plain) < 1e-9, plain
    assert max(extrapolated) < 1e-8, extrapolated


def test_lockstep_extrapolates_where_jax_does(runs):
    rows = runs[3]
    assert [r[2] for r in rows] == [r[3] for r in rows]
    assert sum(r[2] for r in rows) == 5


def test_lockstep_dpops_match_jax(runs):
    for r in runs[3]:
        np.testing.assert_allclose(r[6], r[5], rtol=1e-6, atol=1e-14)


def test_free_run_tracks_jax(runs):
    rows = runs[3]
    assert [r[2] for r in rows] == [r[4] for r in rows]
    errs = [r[1] for r in rows]
    assert max(errs) < 1e-8, errs


def test_ng_keeps_populations_positive(runs):
    for c in runs[1:3]:
        for st in c.popsState:
            assert torch.all(st['n'] > 0.0)


SCHEME_BARS = {SCHEMES[1]: 1e-10, SCHEMES[2]: 1e-9}


@pytest.mark.parametrize('scheme', SCHEMES[1:])
def test_kernel_schemes_equal_default_with_ng(scheme):
    """The scheme's Context in lockstep with a default-scheme one (J,
    populations and Ng history copied in before each step): populations
    within the scheme's bar after every stat_equil, the same
    extrapolations."""
    ref = port_context(ngOptions=NgOptions(*NG))
    ctx = port_context(ngOptions=NgOptions(*NG), fsIterScheme=scheme)
    flags = []
    for it in range(NITER - 8):
        sync(ctx, ref)
        for c in (ref, ctx):
            c.formal_sol_gamma_matrices()
        if it < NSCATTER:
            continue
        ru, cu = ref.stat_equil(), ctx.stat_equil()
        assert pops_err(ctx, ref) < SCHEME_BARS[scheme], it
        flags.append((ru.ngAccelerated, cu.ngAccelerated))
    assert all(a == b for a, b in flags)
    assert sum(a for a, _ in flags) == 3


def test_non_finite_populations_raise_on_the_host_path():
    """With Ng the populations come to the host every iteration; a
    singular Gamma raises ExplodingMatrixError there too."""
    ctx = port_context(ngOptions=NgOptions(*NG))
    ctx.formal_sol_gamma_matrices()
    ctx._Gamma[1] = torch.zeros_like(ctx._Gamma[1])
    with pytest.raises(ExplodingMatrixError, match='Ca'):
        ctx.stat_equil()


def test_one_host_copy_per_stat_equil(monkeypatch):
    """stat_equil with Ng pulls every atom's populations in one copy."""
    ctx = port_context(ngOptions=NgOptions(*NG))
    ctx.formal_sol_gamma_matrices()
    pulls = []
    cpu = torch.Tensor.cpu

    def counted(self, *args, **kwargs):
        pulls.append(self.shape)
        return cpu(self, *args, **kwargs)
    monkeypatch.setattr(torch.Tensor, 'cpu', counted)
    ctx.stat_equil()
    assert pulls == [(sum(st['n'].numel() for st in ctx.popsState),)]


def depth_err(a, b):
    """max |a - b| over the largest population of each depth, over the
    atoms of Contexts a and b."""
    out = 0.0
    for x, y in zip(a.popsState, b.popsState):
        x, y = np.asarray(x['n'], np.float64), np.asarray(y['n'], np.float64)
        out = max(out, (np.abs(x - y).max(axis=0)
                        / np.abs(y).max(axis=0)).max())
    return out


def test_ng_f32_state_against_jax():
    """The float32 state in lockstep with the JAX float32 Context up to
    and through Ng's first extrapolation (the 13th stat_equil), and a
    float64 port Context on the same state beside them.  At the
    extrapolating step: the same flag, finite populations, within twice
    the JAX float32 state's own distance to the float64 step (per depth;
    measured 6.8e-3 and 7.3e-3) and within 1e-2 of the float64 step
    (2.9e-3 measured)."""
    jctx = jax_context(dtype=jnp.float32, ngOptions=JNgOptions(*NG))
    tctx = port_context(ngOptions=NgOptions(*NG), dtype=torch.float32)
    t64 = port_context(ngOptions=NgOptions(*NG))
    for it in range(NSCATTER + 13):
        sync(tctx, jctx)
        sync(t64, jctx)
        for c in (jctx, tctx, t64):
            c.formal_sol_gamma_matrices()
        if it < NSCATTER:
            continue
        ju, tu, _ = (c.stat_equil() for c in (jctx, tctx, t64))
    assert ju.ngAccelerated and tu.ngAccelerated
    for st in tctx.popsState:
        assert torch.isfinite(st['n']).all()
    assert depth_err(tctx, jctx) <= 2.0 * depth_err(jctx, t64)
    assert depth_err(tctx, t64) < 1e-2


# ---- BASELINE config 2: falc_multi_ng -----------------------------------
@pytest.fixture(scope='module')
def multi_ref():
    return (np.load(os.path.join(GOLDEN, 'falc_multi_ng_inputs.npz')),
            np.load(os.path.join(GOLDEN, 'falc_multi_ng_ref.npz')))


def test_multi_ng_inputs_reproducible(multi_ref):
    """The golden inputs still match what the port derives."""
    inputs, _ = multi_ref
    c = multi_ng_context(NgOptions(2, 5, 50), device='cpu')
    np.testing.assert_allclose(np.asarray(c.spect.wavelength),
                               inputs['wavelength'], rtol=1e-12)
    for ia in range(3):
        np.testing.assert_allclose(c.C[ia], inputs[f'atom{ia}_C'],
                                   rtol=1e-10)
        np.testing.assert_allclose(c.popsState[ia]['n'],
                                   inputs[f'atom{ia}_n0'], rtol=1e-10)
    np.testing.assert_allclose(c.bgChi, inputs['bg_chi'], rtol=1e-10)
    # Na I D1/D2 (manifest windows 715-875, 717-878) form one line group
    from lightweaver_tpu_torch.ops.gamma import line_groups
    assert (0, 1) in [tuple(g) for g in line_groups(c.activeAtoms[2])]


def test_multi_ng_iteration_vs_jax_and_golden_dj(multi_ref):
    """One falc_multi_ng MALI step against the JAX Context
    (Gamma 1e-10 above a floor of 1e-10 of its maximum, J and I 1e-10 of
    each wavelength's maximum; the populations after the stat_equil that
    follows the three Lambda iterations 1e-9,
    8.8e-10 measured: the solve amplifies Gamma's ~1e-11 differences, as
    in tests/test_torch_slice.py), and the first three dJ against the
    golden run's out_dJ_hist at 1e-6."""
    _, ref = multi_ref
    atmos = JFalc82()
    atmos.quadrature(5)
    rs = JRadiativeSet([jatoms.H_6_atom(), jatoms.CaII_atom(),
                        jatoms.NaI_atom(), jatoms.MgII_atom()])
    rs.set_active('H', 'Ca', 'Na')
    spect = rs.compute_wavelength_grid()
    jctx = JContext(atmos, spect, rs.compute_eq_pops(atmos),
                    ngOptions=JNgOptions(2, 5, 50))
    tctx = multi_ng_context(NgOptions(2, 5, 50), device='cpu')
    jctx.formal_sol_gamma_matrices()
    tu = tctx.formal_sol_gamma_matrices()
    for ai in range(3):
        assert relerr(tctx._Gamma[ai], jctx._Gamma[ai]) < 1e-10, ai
    for key in ('J', 'I'):
        ours = np.asarray(getattr(tctx, key))
        theirs = np.asarray(getattr(jctx, key))
        e = (np.abs(ours - theirs).max(axis=1)
             / np.abs(theirs).max(axis=1)).max()
        assert e < 1e-10, (key, e)
    # the golden run's first three iterations are the Lambda iterations
    dJ = [float(tu.dJMax)]
    for _ in range(2):
        jctx.formal_sol_gamma_matrices()
        dJ.append(float(tctx.formal_sol_gamma_matrices().dJMax))
    np.testing.assert_allclose(dJ, ref['out_dJ_hist'][:3], rtol=1e-6)
    jctx.stat_equil()
    tctx.stat_equil()
    assert pops_err(tctx, jctx) < 1e-9


@pytest.mark.slow
def test_multi_ng_converged_vs_reference(multi_ref):
    """BASELINE config 2 converged on the CPU: 221 +- 2 iterations,
    populations within 1e-6 and J/I within 3e-6 of the golden run (the
    JAX package's bars: Ng compounds rounding differences)."""
    _, ref = multi_ref
    c = multi_ng_context(NgOptions(2, 5, 50), device='cpu')
    nIter = iterate_ctx_se(c, NmaxIter=500, quiet=True)
    assert abs(nIter - int(ref['out_niter'][0])) <= 2
    for ia in range(3):
        assert relerr(c.popsState[ia]['n'], ref[f'out_pops_a{ia}'],
                      floorRel=0.0) < 1e-6
    assert relerr(c.J, ref['out_J'], floorRel=0.0) < 3e-6
    assert relerr(c.I, ref['out_I'], floorRel=0.0) < 3e-6


@pytest.mark.slow
def test_multi_ng_early_ng_explodes():
    """Ng engaged at Ndelay = 10 extrapolates the pre-asymptotic iterates
    to negative populations and the solve goes singular, in the compiled
    reference and the JAX package alike: ExplodingMatrixError."""
    c = multi_ng_context(NgOptions(2, 5, 10), device='cpu')
    with pytest.raises(ExplodingMatrixError):
        iterate_ctx_se(c, NmaxIter=100, quiet=True)
