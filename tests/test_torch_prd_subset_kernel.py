"""The PRD subset solve's kernel (csrc/prd_subset.cu, ops/prd_subset.py)
and the hoisted subset solve of context.py:build_prd_subset_fn: the
rho-free terms formed once per redistribution, chi and srcNum assembled
from them and the PRD lines' rho each sub-iteration.

On the CPU: the hoisted path through the plain version
(prd_subset_sweep_plain) against the present path (sweep_inputs +
formal_solve_sweep) on a small falc_h6mg column batch under hybrid and
angle-averaged PRD; the spans that show the terms formed once per
prd_redistribute call; the wrapper's checks; CPU tensors never load the
kernel.  On the card (marker gpu): the kernel against the plain version in
float64 and float32, on synthetic rows with two overlapping PRD lines and
each boundary kind, and the batch's hoisted stage against its present
path.

No jax here, so the file also runs where only torch is installed; on a
machine with an NVIDIA GPU:

    python -m pytest tests/test_torch_prd_subset_kernel.py --noconftest -q

Without a GPU the tests marked gpu skip.
"""
import numpy as np
import pytest
import torch

from lightweaver_tpu_torch import H_6_atom, MgII_atom, problems, tracing
from lightweaver_tpu_torch.context import prd_subset_kernel_covers
from lightweaver_tpu_torch.ops import _build, prd_subset, sweep
from lightweaver_tpu_torch.ops.formal_solver import SOLVER_NAMES_1D
from lightweaver_tpu_torch.problems import column_batch, stacked_falc

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)

EPS = float(torch.finfo(torch.float64).eps)
# hoisted against present path, max |a - b| / max |b| per output: the
# two sum chi and srcNum in another order (a few ulp of each element),
# and the sweep carries that through optical depths up to 1e6.  Rounding
# chi of the present path by one ulp at random moves the batch's J by
# 1.5-3.2e-13, I by 1.1-2.5e-12 and PsiBar by 4.4-5.7e-11 (the Bezier
# weights cancel at large dtau); the hoisted path differs by as much
# (test_hoisted_within_rounding_of_present_path)
TOL_RATES = 1e-13
TOL_J = 1e-12
TOL_I = 1e-11
TOL_PSIBAR = 2e-10
# kernel on the card, max |kernel - other| / max |other| per output:
# against the sweep kernel on the plain version's assembled chi and
# srcNum none (the kernel rounds the assembly's operations as the plain
# version does, and sweeps by the same warp_ray), and against the plain
# version that of the scan against the sequential sweep (the sweep
# kernel's own bar, tests/test_torch_columns_kernels.py)
TOL_KERNEL = 0.0
TOL_PLAIN = 1e-9

RED = 'lw.prd.redistribute'
SOLVE = f'{RED}/lw.prd.subiter/lw.prd.subset_solve'


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def batch(hprd, device='cpu', C=4, Nk=20):
    """C falc_h6mg columns of Nk depths (H 6 + Mg II active, four PRD
    lines), two with velocity ramps, after a MALI step, a
    prd_redistribute (rho != 1) and a second MALI step with its
    statistical equilibrium: the state a redistribution starts from."""
    h = stacked_falc(C, Nk)[0]
    ramp = (h - h.min()) / (h.max() - h.min())
    vlos = np.zeros((C, Nk))
    vlos[1], vlos[2] = 1e4 * ramp, -5e3 * ramp
    b = column_batch(C, models=lambda: [H_6_atom(), MgII_atom()],
                     activeSpecies=('H', 'Mg'), Nk=Nk,
                     vlos=vlos if hprd else None, Nrays=3, device=device,
                     hprd=hprd)
    b.formal_sol_gamma_matrices()
    b.stat_equil()
    b.prd_redistribute(maxIter=2, tol=0.0)
    b.formal_sol_gamma_matrices()
    b.stat_equil()
    return b


def rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def both_paths(b):
    """The batch's subset stage by the present path and by the hoisted
    one (held terms, two calls), and the full rays and moments of each."""
    fs = b._prd_fs
    p = b.params
    hoisted = fs.hoisted
    try:
        fs.hoisted = False
        ref = fs(p)
        I0, _, _, m0 = sweep.formal_solve_sweep(*fs.sweep_inputs(p))
        fs.hoisted = True
        held = {}
        outs = [fs(p, held), fs(p, held)]
    finally:
        fs.hoisted = hoisted
    args = fs.kernel_args(p, held['terms'])
    I1, m1 = prd_subset.prd_subset_sweep(*args)
    return ref, outs, (I0, m0), (I1, m1), args


def check_paths(ref, outs, full0, full1, scale=1.0):
    for out in outs:
        assert set(out) == set(ref)
        assert rel(out['J'], ref['J']) <= scale * TOL_J
        assert rel(out['dJ'], ref['dJ']) <= scale * 10 * TOL_J
        assert rel(out['I'], ref['I']) <= scale * TOL_I
        for k in ('Rij', 'Rji'):
            assert len(out[k]) == len(ref[k]) == 4
            for x, y in zip(out[k], ref[k]):
                assert rel(x, y) <= scale * TOL_RATES, k
        if 'JRest' in ref:
            assert rel(out['JRest'], ref['JRest']) <= scale * TOL_J
    # the second call of a redistribution reads the held terms: the same
    # numbers
    for k in ('J', 'I', 'dJ'):
        assert torch.equal(outs[0][k], outs[1][k])
    (I0, m0), (I1, m1) = full0, full1
    assert rel(I1, I0) <= scale * TOL_I
    assert rel(m1['J'], m0['J']) <= scale * TOL_J
    assert rel(m1['PsiBar'], m0['PsiBar']) <= scale * TOL_PSIBAR


@pytest.mark.parametrize('hprd', [True, False], ids=['hprd', 'aa_prd'])
def test_hoisted_plain_matches_present_path(hprd):
    """On the CPU the batch takes the present path; the hoisted path
    through the plain version gives its J, I, dJ, rates and JRest, and
    the full rays I and moments, within the bars above; its assembled chi
    is within 4 ulp of sweep_inputs' element by element, srcNum within 4
    ulp of its row's largest value."""
    b = batch(hprd)
    assert not b._prd_fs.hoisted
    ref, outs, full0, full1, args = both_paths(b)
    check_paths(ref, outs, full0, full1)
    chi1, src1 = prd_subset.assemble(*args[:4])
    chi0, src0 = b._prd_fs.sweep_inputs(b.params)[:2]
    assert (((chi1 - chi0).abs() / chi0.abs()).max() <= 4 * EPS)
    rowMax = src0.abs().amax(dim=-1, keepdim=True)
    assert (((src1 - src0).abs() / rowMax).max() <= 4 * EPS)
    # Mg II h and k overlap: some rows are covered by two lines
    lines = args[3]
    cover = torch.zeros(args[0].shape[1], dtype=torch.int64)
    for L in lines:
        cover[L.s0:L.s0 + L.Vij.shape[1]] += 1
    assert len(lines) == 4 and cover.max() == 2
    assert all((L.i0 is not None) == hprd for L in lines)


def test_hoisted_within_rounding_of_present_path():
    """The hoisted path's full rays I and moments J and PsiBar differ from
    the present path's by no more than twice what a random one-ulp
    rounding of the present path's chi moves them (the largest of three
    draws): the difference is the summation order's rounding."""
    b = batch(True)
    _, _, (I0, m0), (I1, m1), _ = both_paths(b)
    sa = b._prd_fs.sweep_inputs(b.params)
    moved = {'I': 0.0, 'J': 0.0, 'PsiBar': 0.0}
    for seed in range(3):
        g = torch.Generator().manual_seed(seed)
        u = 2.0 * torch.rand(sa[0].shape, generator=g,
                             dtype=torch.float64) - 1.0
        I2, _, _, m2 = sweep.formal_solve_sweep(sa[0] * (1.0 + EPS * u),
                                                *sa[1:])
        for k, a in (('I', I2), ('J', m2['J']), ('PsiBar', m2['PsiBar'])):
            b0 = I0 if k == 'I' else m0[k]
            moved[k] = max(moved[k], rel(a, b0))
    assert rel(I1, I0) <= 2 * moved['I']
    assert rel(m1['J'], m0['J']) <= 2 * moved['J']
    assert rel(m1['PsiBar'], m0['PsiBar']) <= 2 * moved['PsiBar']


def test_terms_formed_once_per_redistribution():
    """With the hoisted path (forced on the CPU), one prd_redistribute of
    the batch forms the terms once (lw.prd.subset_terms, inside the first
    subset solve) and launches one kernel per sub-iteration
    (lw.prd.subset_kernel), and moves J and rho as the present path does;
    the single Context's prd_redistribute the same."""
    runs = {}
    for hoisted in (False, True):
        b = batch(True, C=3, Nk=12)
        b._prd_fs.hoisted = hoisted
        b.formal_sol_gamma_matrices()
        b.stat_equil()
        tracing.enable()
        upd = b.prd_redistribute(maxIter=3, tol=0.0)
        tracing.disable()
        runs[hoisted] = (b, tracing.collect())
        tracing.reset()
    b, got = runs[True]
    n = upd.NprdSubIter
    assert n == 3
    assert got[SOLVE]['count'] == n
    assert got[f'{SOLVE}/lw.prd.subset_terms']['count'] == 1
    assert got[f'{SOLVE}/lw.prd.subset_kernel']['count'] == n
    assert not any('subset_terms' in k or 'subset_kernel' in k
                   for k in runs[False][1])
    # three sub-iterations, each reading the last one's rates and JRest
    b0 = runs[False][0]
    assert rel(b.params['J'], b0.params['J']) <= 10 * TOL_J
    for ai, ti, a, t in b.flatCtx._prd_lines():
        assert rel(b.params['rhoPrd'][ai][ti],
                   b0.params['rhoPrd'][ai][ti]) <= 10 * TOL_J

    ctx = problems.h6mg_context(problems.falc_decimated(12), Nrays=1,
                                hprd=True, device='cpu')
    ctx.formal_sol_gamma_matrices()
    ctx.stat_equil()
    ctx._prd_subset_fn().hoisted = True
    tracing.enable()
    upd = ctx.prd_redistribute(maxIter=2, tol=0.0)
    tracing.disable()
    got = tracing.collect()
    assert upd.NprdSubIter == 2
    assert got[f'{SOLVE}/lw.prd.subset_terms']['count'] == 1
    assert got[f'{SOLVE}/lw.prd.subset_kernel']['count'] == 2
    # and in the on-device loop: once per population update's
    # sub-iterations
    tracing.reset()
    tracing.enable()
    ctx.iterate_on_device(NmaxIter=5, Nscatter=3, prd=True)
    tracing.disable()
    got = tracing.collect()
    terms = sum(v['count'] for k, v in got.items()
                if k.endswith('lw.prd.subset_terms'))
    kern = sum(v['count'] for k, v in got.items()
               if k.endswith('lw.prd.subset_kernel'))
    assert terms == 2 and kern >= terms


def test_kernel_picked_from_configuration():
    """The hoisted path runs where csrc/prd_subset.cu covers the
    configuration: a CUDA device, 1D, a solver of the sweep kernel,
    float64 or float32 and at most MAX_LINES lines; a CPU batch keeps
    the present path."""
    cfg = batch(False, C=3, Nk=12).cfg
    assert not prd_subset_kernel_covers(cfg, 4)

    class Cfg:
        device = torch.device('cuda')
        Ndim = 1
        formalSolver = 'piecewise_bezier3_1d'
        dtype = torch.float64
    assert prd_subset_kernel_covers(Cfg, 4)
    assert prd_subset_kernel_covers(Cfg, prd_subset.MAX_LINES)
    assert not prd_subset_kernel_covers(Cfg, prd_subset.MAX_LINES + 1)
    for key, value in (('Ndim', 2), ('formalSolver', 'piecewise_linear_2d'),
                       ('dtype', torch.float16),
                       ('device', torch.device('cpu'))):
        other = type('Other', (Cfg,), {key: value})
        assert not prd_subset_kernel_covers(other, 4), key


def synthetic(NL=40, Nmu=3, Nk=24, Ncol=2, bcs=('zero', 'therm'),
              dtype=torch.float64, device='cpu', seed=0):
    """prd_subset_sweep's arguments on random rows: chi rising with depth
    over optical depths 1e-3 to 30, two PRD lines whose rows overlap in
    [15, 25) (a hybrid-PRD one with comoving coefficients and an
    angle-averaged one), and the boundaries ``bcs``."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=g,
                                           dtype=torch.float64)
    NT = Ncol * Nk
    depth = 10.0 ** torch.linspace(-3, 1.5, Nk, dtype=torch.float64)
    base = depth.repeat(Ncol)
    chiFix = u(2, NL, Nmu, NT, lo=1.0, hi=2.0) * base
    etaFix = u(2, NL, Nmu, NT, lo=0.5, hi=1.0) * base
    scaJ = u(NL, NT, lo=0.0, hi=0.5) * base
    lines = []
    for s0, nW, W, off, hprd in ((5, 20, 26, 3, True), (15, 20, 20, 0,
                                                        False)):
        Vij = u(2, nW, Nmu, NT, lo=0.0, hi=0.3) * base
        nj = u(NT, lo=0.1, hi=1.0)
        rho = u(W, NT, lo=0.5, hi=1.5)
        i0 = frac = None
        if hprd:
            i0 = torch.randint(0, W - 1, (2, W, Nmu, NT), generator=g)
            frac = u(2, W, Nmu, NT)
        lines.append(prd_subset.SubsetLine(s0, Vij, nj, 0.7, 0.4, rho, off,
                                           i0, frac))
    if Ncol == 1:
        height = -torch.arange(Nk, dtype=torch.float64)
        bcShape = {'data': (NL, Nmu), 'therm': (NL, 2)}
    else:
        height = -torch.arange(Nk, dtype=torch.float64).repeat(Ncol, 1)
        bcShape = {'data': (NL, Nmu, Ncol), 'therm': (NL, Ncol, 2)}
    def rows(kind):
        if kind == 'zero':
            return None
        x = u(*bcShape[kind], lo=0.5, hi=2.0)
        if kind == 'therm':
            # the Planck rows fall outwards: positive boundary values
            x[..., 1] = x[..., 0] * u(*x.shape[:-1], lo=0.9, hi=1.0)
        return x
    bc = [(kind, rows(kind)) for kind in bcs]
    muz = torch.linspace(0.2, 1.0, Nmu, dtype=torch.float64)
    wmu = torch.full((Nmu,), 1.0 / Nmu, dtype=torch.float64)

    def t_(x):
        if x is None or not x.is_floating_point():
            return None if x is None else x.to(device)
        return x.to(device=device, dtype=dtype)
    lines = [L._replace(Vij=t_(L.Vij), nj=t_(L.nj), rho=t_(L.rho),
                        i0=t_(L.i0), frac=t_(L.frac)) for L in lines]
    return (t_(chiFix), t_(etaFix), t_(scaJ), lines, t_(height), t_(muz),
            t_(wmu), *[(k, t_(x)) for k, x in bc])


def _no_build(*args, **kwargs):
    raise AssertionError('a CPU tensor reached the CUDA kernel')


@pytest.mark.parametrize('solver', SOLVER_NAMES_1D)
def test_cpu_runs_plain_and_never_loads_the_kernel(monkeypatch, solver):
    """prd_subset_sweep on CPU tensors is the plain version bit for bit,
    builds or loads no library, and is the assembly followed by the plain
    sweep with the boundaries of the assembled chi."""
    monkeypatch.setattr(_build, 'load', _no_build)
    for bcs in (('zero', 'therm'), ('therm', 'data'), ('data', 'zero')):
        args = synthetic(bcs=bcs)
        n0 = prd_subset.prd_subset_cuda.launches
        I, m = prd_subset.prd_subset_sweep(*args, solver=solver)
        I2, m2 = prd_subset.prd_subset_sweep_plain(*args, solver=solver)
        assert torch.equal(I, I2) and torch.equal(m['J'], m2['J'])
        assert prd_subset.prd_subset_cuda.launches == n0
        assert torch.isfinite(I).all() and (I >= 0).all()


def test_wrapper_refuses():
    """ValueError on shapes and rows that do not fit, TypeError on a
    dtype, before anything runs."""
    args = list(synthetic())
    L = args[3][0]
    bad = {
        'chiFix of three dimensions': [args[0][0]] + args[1:],
        'etaFix of another shape': args[:1] + [args[1][:, :-1]] + args[2:],
        'float32 scaJ': args[:2] + [args[2].float()] + args[3:],
        'rows past NL': args[:3] + [[L._replace(s0=30)]] + args[4:],
        'window rows past W': args[:3] + [[L._replace(off=10)]] + args[4:],
        'i0 without frac': args[:3] + [[L._replace(frac=None)]] + args[4:],
        'int32 i0': args[:3] + [[L._replace(i0=L.i0.int())]] + args[4:],
        'nj of another length': args[:3] + [[L._replace(nj=L.nj[:-1])]]
        + args[4:],
        'an unknown boundary': args[:7] + [('open', None), args[8]],
        'zero boundary with rows': args[:7] + [('zero', args[2])]
        + args[8:],
    }
    for name, a in bad.items():
        with pytest.raises((TypeError, ValueError)):
            prd_subset.prd_subset_sweep(*a)
    with pytest.raises(ValueError):
        prd_subset.prd_subset_sweep(*args, solver='piecewise_linear_2d')


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')


def outputs(out):
    I, m = out
    return {'I': I, 'J': m['J'], 'PsiBar': m['PsiBar'], 'IBar': m['IBar'],
            'IeffSrcBar': m['IeffSrcBar']}


@pytest.mark.gpu
@pytest.mark.parametrize('solver', SOLVER_NAMES_1D)
@pytest.mark.parametrize('bcs', [('zero', 'therm'), ('therm', 'data'),
                                 ('data', 'zero')])
@pytest.mark.parametrize('Ncol', [1, 3])
def test_kernel_matches_plain(Ncol, bcs, solver):
    """float64: one launch on the card against the sweep kernel on the
    plain assembly and against the plain version (check_kernel), rows
    covered by two lines included."""
    cuda_or_skip()
    args = synthetic(Ncol=Ncol, bcs=bcs, device='cuda', seed=Ncol)
    n0 = prd_subset.prd_subset_cuda.launches
    kern = outputs(prd_subset.prd_subset_sweep(*args, solver=solver))
    torch.cuda.synchronize()
    assert prd_subset.prd_subset_cuda.launches == n0 + 1
    check_kernel(kern, args, solver)


def check_kernel(kern, args, solver=SOLVER_NAMES_1D[1]):
    """The kernel's outputs against the sweep kernel on the plain
    assembly within TOL_KERNEL, and against the plain version within
    TOL_PLAIN (``args`` prd_subset_sweep's, the solver among them or
    not)."""
    if len(args) == 10:
        args, solver = args[:9], args[9]
    swept = sweep.formal_solve_sweep(*prd_subset.sweep_args(*args),
                                     solver=solver)
    swept = outputs((swept[0], swept[3]))
    plain = outputs(prd_subset.prd_subset_sweep_plain(*args, solver=solver))
    for name in kern:
        assert torch.isfinite(kern[name]).all(), name
        assert rel(kern[name], swept[name]) <= TOL_KERNEL, (
            name, rel(kern[name], swept[name]))
        assert rel(kern[name], plain[name]) <= TOL_PLAIN, (
            name, rel(kern[name], plain[name]))


@pytest.mark.gpu
@pytest.mark.parametrize('solver', SOLVER_NAMES_1D)
@pytest.mark.parametrize('bcs', [('zero', 'therm'), ('data', 'zero')])
def test_f32_kernel_matches_plain(bcs, solver):
    """float32: each output within err(kernel f32, plain f64) <= 2
    err(plain f32, plain f64) + 1e-6 (the float32 rule); J summed in
    double."""
    cuda_or_skip()
    args = synthetic(Ncol=3, bcs=bcs, device='cuda', seed=7,
                     dtype=torch.float32)
    args64 = synthetic(Ncol=3, bcs=bcs, device='cuda', seed=7)
    n0 = prd_subset.prd_subset_cuda.launches_f32
    kern = outputs(prd_subset.prd_subset_sweep(*args, solver=solver))
    torch.cuda.synchronize()
    assert prd_subset.prd_subset_cuda.launches_f32 == n0 + 1
    assert kern['J'].dtype == torch.float64
    assert kern['I'].dtype == torch.float32
    plain = outputs(prd_subset.prd_subset_sweep_plain(*args, solver=solver))
    ref = outputs(prd_subset.prd_subset_sweep_plain(*args64, solver=solver))
    for name in kern:
        ek = rel(kern[name].double(), ref[name])
        ep = rel(plain[name].double(), ref[name])
        assert ek <= 2 * ep + 1e-6, (name, ek, ep)


@pytest.mark.gpu
@pytest.mark.parametrize('hprd', [True, False], ids=['hprd', 'aa_prd'])
def test_card_batch_takes_the_kernel(hprd):
    """A batch on the card takes the hoisted path: one launch per
    sub-iteration, the present path's numbers within the CPU's bars; and
    the kernel on the batch's own inputs by check_kernel."""
    cuda_or_skip()
    b = batch(hprd, device='cuda')
    assert b._prd_fs.hoisted
    n0 = prd_subset.prd_subset_cuda.launches
    ref, outs, full0, full1, args = both_paths(b)
    torch.cuda.synchronize()
    # two stage calls and the full-ray call
    assert prd_subset.prd_subset_cuda.launches == n0 + 3
    # the card's present path sums chi and srcNum in torch and sweeps by
    # the scan with FMAs: another realisation of the rounding the CPU's
    # bars cover (the emergent I read 1.9e-11 against the CPU's 4.9e-12)
    check_paths(ref, outs, full0, full1, scale=4.0)
    check_kernel(outputs(full1), args)
