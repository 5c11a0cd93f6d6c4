"""The kernel wrappers of lightweaver_tpu_torch and their CUDA kernels:
the depth sweep, the line Gamma kernel, the fused lambda step and the two
toolchain probes.

No jax here, so the file also runs where only torch is installed; on a
machine with an NVIDIA GPU each kernel is compared with its plain version:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

(--noconftest: tests/conftest.py imports and configures jax, which the
port does not need).  Without a GPU the tests marked gpu skip.
"""
import numpy as np
import pytest
import torch

from lightweaver_tpu_torch.ops import fused as tfused
from lightweaver_tpu_torch.ops import gamma as tgamma
from lightweaver_tpu_torch.ops import probe as tprobe
from lightweaver_tpu_torch.ops import sweep as tsweep
from lightweaver_tpu_torch.problems import (random_boundaries,
                                            random_line_group, random_rays,
                                            random_slots)

SCHEMES = ('mali_full_precond', 'mali_full_precond_pallas',
           'mali_full_precond_fused')

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def _sweep_case(NL, Nmu, Nk, seed=0, device='cpu'):
    """Random smooth rays (as tests/test_pallas_sweep.py builds them),
    direction-major [2, NL, Nmu, Nk]."""
    return {k: torch.tensor(v, dtype=torch.float64, device=device)
            for k, v in random_rays(NL, Nmu, Nk, seed).items()}


def test_sweep_moments_are_the_ray_sums():
    """J, PsiBar and IeffSrcBar are the wmu/2-weighted sums over both
    directions and all mu of I, Psi and IeffBase + Psi*srcNum (1e-13:
    summation order only)."""
    c = _sweep_case(5, 4, 20, seed=4)
    I, Psi, IeffB, mom = tsweep.formal_solve_sweep(**c)
    w = 0.5 * c['wmu'].numpy()[None, None, :, None]
    for name, x in (('J', I), ('IBar', I), ('PsiBar', Psi),
                    ('IeffSrcBar', IeffB + Psi * c['srcNum'])):
        ref = (x.numpy() * w).sum(axis=(0, 2))
        np.testing.assert_allclose(mom[name].numpy(), ref, rtol=1e-13)


def test_sweep_and_fused_take_any_number_of_rays():
    """Past 16 rays per direction the sweep and fused kernels take a
    row's rays in passes of at most 32 warps (csrc/sweep_row.cuh): the
    wrappers' block width and shared memory for Nmu = 17 and more, the
    refusal past an H100 block's shared memory, and plain calls at
    Nmu = 17 whose moments are the ray sums (1e-13)."""
    assert [tsweep.rays_per_pass(n) for n in (1, 5, 16, 17, 32, 40)] == \
        [2, 10, 32, 17, 32, 27]
    assert tsweep.smem_bytes(torch.float64, 17, 500) == (
        16 * 500 + 8 * 2 * 2 * 500 + 8 * 2 * 3 * 32 * 17)
    assert tsweep.smem_bytes(torch.float32, 32, 82) == (
        16 * 82 + 4 * 2 * 3 * 82 + 4 * 2 * 3 * 32 * 32)
    tsweep.check_smem(torch.float64, 32, 3000)
    with pytest.raises(ValueError, match='232448'):
        tsweep.check_smem(torch.float64, 5, 5000)
    c = _sweep_case(3, 17, 40, seed=17)
    I, Psi, IeffB, mom = tsweep.formal_solve_sweep(**c)
    assert I.shape == (2, 3, 17, 40)
    w = 0.5 * c['wmu'].numpy()[None, None, :, None]
    for name, x in (('J', I), ('PsiBar', Psi),
                    ('IeffSrcBar', IeffB + Psi * c['srcNum'])):
        ref = (x.numpy() * w).sum(axis=(0, 2))
        np.testing.assert_allclose(mom[name].numpy(), ref, rtol=1e-13)
    f = _slots_case(2, 'therm', 'data', NL=6, Nmu=17, Nk=40, seed=17)
    I, Psi, IeffB, mom = tfused.fused_lambda_step(**f)
    assert I.shape == (2, 6, 17, 40) and torch.isfinite(I).all()
    ref = (I.numpy() * 0.5 * f['wmu'].numpy()[None, None, :, None]).sum(
        axis=(0, 2))
    np.testing.assert_allclose(mom['J'].numpy(), ref, rtol=1e-13)


def test_sweep_checks_inputs():
    c = _sweep_case(4, 2, 10)
    with pytest.raises(ValueError, match='srcNum'):
        tsweep.formal_solve_sweep(**{**c, 'srcNum': c['srcNum'][:, :2]})
    with pytest.raises(ValueError, match='wmu is torch.float32'):
        tsweep.formal_solve_sweep(**{**c, 'wmu': c['wmu'].float()})
    with pytest.raises(ValueError, match='Nk >= 3'):
        tsweep.formal_solve_sweep(**{**c, 'chi': c['chi'][..., :2],
                                     'srcNum': c['srcNum'][..., :2],
                                     'height': c['height'][:2]})


def test_sweep_dispatch_never_falls_back():
    """Only a CPU tensor takes the plain version: other devices raise,
    and the CUDA route refuses tensors that are not on a card rather than
    computing on the CPU."""
    c = _sweep_case(4, 2, 10)
    meta = {k: v.to('meta') for k, v in c.items()}
    with pytest.raises(RuntimeError, match='no sweep kernel'):
        tsweep.formal_solve_sweep(**meta)
    before = tsweep.sweep_cuda.launches
    with pytest.raises(ValueError, match='CUDA'):
        tsweep.sweep_cuda(**c)
    assert tsweep.sweep_cuda.launches == before


def test_context_on_cuda_without_a_gpu_raises():
    """Asking for device='cuda' where there is no GPU fails at once; no
    stage quietly runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip('checks the behaviour without a CUDA device')
    from lightweaver_tpu_torch.problems import falc_interpolated, h6ca_context
    with pytest.raises((RuntimeError, AssertionError)):
        h6ca_context(falc_interpolated(12), 2, device='cuda')


SWEEP_NK = [3, 31, 32, 33, 82, 500]


@pytest.mark.gpu
@pytest.mark.parametrize('Nk', SWEEP_NK)
def test_sweep_kernel_matches_plain(Nk):
    """The CUDA kernel against the plain version on the card, at the main
    path's shapes and at the edges of its 32-depth chunks.  nvcc contracts
    multiply-adds into FMAs and torch's separate ops do not, and the
    kernel sums the recurrence as a chunked scan; the difference compounds
    along the depth chain, hence 1e-9 of each quantity's maximum."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    c = _sweep_case(1046, 5, Nk, seed=5, device='cuda')
    plain = tsweep.formal_solve_sweep_plain(**c)
    before = tsweep.sweep_cuda.launches
    kern = tsweep.formal_solve_sweep(**c)
    torch.cuda.synchronize()
    assert tsweep.sweep_cuda.launches == before + 1
    for name, a, b in zip(('I', 'Psi', 'IeffBase'), kern[:3], plain[:3]):
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err < 1e-9, (name, err)
    for name in ('J', 'IBar', 'PsiBar', 'IeffSrcBar'):
        a, b = kern[3][name], plain[3][name]
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err < 1e-9, (name, err)


@pytest.mark.gpu
def test_context_on_cuda_goes_through_the_kernel():
    """One MALI iteration of a small problem on the card: the formal
    solve launches the kernel once and J agrees with the same iteration
    on the CPU to 1e-9 of each wavelength's maximum over depth (FMA
    contraction and the card's exp, carried along the depth chain)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    from lightweaver_tpu_torch.problems import falc_interpolated, h6ca_context
    cpu = h6ca_context(falc_interpolated(20), 3, device='cpu')
    gpu = h6ca_context(falc_interpolated(20), 3, device='cuda')
    cpu.formal_sol_gamma_matrices()
    before = tsweep.sweep_cuda.launches
    gpu.formal_sol_gamma_matrices()
    assert tsweep.sweep_cuda.launches == before + 1
    J, Jref = gpu.J.cpu().numpy(), cpu.J.numpy()
    err = np.abs(J - Jref).max(axis=1) / np.abs(Jref).max(axis=1)
    assert err.max() < 1e-9


def _group_case(K, device='cpu', Nlam=40, Nmu=3, Nk=20, seed=0):
    """Arguments of ops.gamma.group_gamma_rates for a random group."""
    g = random_line_group(K, Nlam, Nmu, Nk, row0=5, Wu=Nlam - 12, seed=seed)
    st = tgamma.group_statics([type('T', (), {'i': i, 'j': j})
                               for i, j in g.pop('levels')])
    row0 = g.pop('row0')
    args = {k: torch.tensor(v, dtype=torch.float64, device=device)
            for k, v in g.items()}
    return {**args, 'st': st, 'row0': row0}


def _slots_case(C, upper, lower, device='cpu', NL=24, Nmu=3, Nk=20, seed=0):
    """Arguments of ops.fused.fused_lambda_step for random slots and the
    named boundary kinds."""
    def t_(x):
        return torch.tensor(x, dtype=torch.float64, device=device)
    args = {k: t_(v) for k, v in random_slots(C, NL, Nmu, Nk, seed).items()}
    rows = random_boundaries(NL, Nmu, seed)
    for name, kind in (('upper', upper), ('lower', lower)):
        args[name] = (kind, None if kind == 'zero' else t_(rows[kind]))
    return args


def _max_rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def test_probe_plain_versions():
    """2x + 1 and the recurrence o_k = a_k o_{k-1} + b_k (pallas_probe's
    check: a = 0.5, b = 1 down 64 rows), against numpy."""
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    assert torch.equal(tprobe.elementwise(x), x * 2.0 + 1.0)
    a = torch.full((64, 256), 0.5)
    b = torch.ones((64, 256))
    ref, refs = np.zeros(256, np.float32), []
    for _ in range(64):
        ref = np.float32(0.5) * ref + np.float32(1.0)
        refs.append(ref)
    np.testing.assert_array_equal(tprobe.recurrence(a, b).numpy(),
                                  np.stack(refs))


def test_group_gamma_block_sums_and_moments():
    """The plain line kernel: G4's blocks sum to the window integrals, PPB
    is the mu moment of Psi phi, and K = 1 has one zero pair row."""
    c = _group_case(2)
    G4, PPB, PairPPB = tgamma.group_gamma_rates(**c)
    K, _, Wu, Nmu, Nk = c['phi'].shape
    assert G4.shape == (K, 4, -(-Wu // tgamma.BW), Nk)
    rows = slice(c['row0'], c['row0'] + Wu)
    w = c['wmuHalf'][None, None, :, None]
    Psi = c['Psi'][:, rows]
    for m in range(K):
        ref = (w * c['phi'][m] * Psi).sum(dim=(0, 2))
        np.testing.assert_allclose(PPB[m], ref, rtol=1e-13)
        # Rij = sum w wl I Vij with Vij = a1 phi
        wl = c['coef'][m, :, 3][:, None] * c['wphi'][m][None, :]
        Vij = c['coef'][m, :, 0][None, :, None, None] * c['phi'][m]
        Rij = (c['I'][:, rows] * Vij * w * wl[None, :, None, :]).sum(
            dim=(0, 1, 2))
        np.testing.assert_allclose(G4[m, 2].sum(dim=0), Rij, rtol=1e-12)
    np.testing.assert_allclose(
        PairPPB[0], (w * c['phi'][0] * c['phi'][1] * Psi).sum(dim=(0, 2)),
        rtol=1e-13)
    _, _, pair1 = tgamma.group_gamma_rates(**_group_case(1))
    assert pair1.shape[0] == 1 and not pair1.any()


def test_group_gamma_checks_inputs():
    c = _group_case(2)
    with pytest.raises(ValueError, match='srcNum'):
        tgamma.group_gamma_rates(**{**c, 'srcNum': c['srcNum'][:, :5]})
    with pytest.raises(ValueError, match='window'):
        tgamma.group_gamma_rates(**{**c, 'row0': 30})
    # K = 2 (KMAX/2 + 1) members, past the kernel's bound
    with pytest.raises(ValueError, match='outside the kernel'):
        tgamma.group_gamma_rates(**{**c, 'phi': c['phi'].repeat(
            tgamma.KMAX // 2 + 1, 1, 1, 1, 1)})


def test_fused_plain_is_assembly_then_sweep():
    """The plain fused step is the slot assembly fed to the plain sweep
    with the boundary values of context.formal_solve."""
    c = _slots_case(2, 'therm', 'data')
    I, Psi, IeffB, mom = tfused.fused_lambda_step(**c)
    chi, src = tfused.assemble(c['phiP'], c['chiCo'], c['etaCo'],
                               c['bgChi'], c['bgEta'], c['scaJ'])
    bnu = c['upper'][1]
    dtau = (0.5 * (chi[0, :, :, 0] + chi[0, :, :, 1])
            * torch.abs(c['height'][0] - c['height'][1]) / c['muz'][None, :])
    IupwD = bnu[:, 0:1] - (bnu[:, 1:2] - bnu[:, 0:1]) / dtau
    ref = tsweep.formal_solve_sweep_plain(chi, src, c['height'], c['muz'],
                                          IupwD, c['lower'][1], c['wmu'])
    for a, b in zip((I, Psi, IeffB), ref[:3]):
        assert torch.equal(a, b)
    for k in ('J', 'PsiBar', 'IeffSrcBar'):
        assert torch.equal(mom[k], ref[3][k])


def test_fused_checks_inputs():
    c = _slots_case(2, 'zero', 'therm')
    with pytest.raises(ValueError, match='boundary kind'):
        tfused.fused_lambda_step(**{**c, 'upper': ('hot', None)})
    with pytest.raises(ValueError, match='lower must be'):
        tfused.fused_lambda_step(**{**c, 'lower': ('therm',
                                                   c['lower'][1][:, :1])})
    with pytest.raises(ValueError, match='chiCo'):
        tfused.fused_lambda_step(**{**c, 'chiCo': c['chiCo'][:1]})


def test_kernel_dispatch_never_falls_back():
    """As for the sweep: a tensor on another device raises, and each CUDA
    route refuses CPU tensors without counting a launch."""
    g = _group_case(1)
    f = _slots_case(1, 'zero', 'zero')
    x = torch.ones(4)

    def meta(d):
        return {k: (v.to('meta') if torch.is_tensor(v) else v)
                for k, v in d.items()}
    with pytest.raises(RuntimeError, match='no line Gamma kernel'):
        tgamma.group_gamma_rates(**meta(g))
    with pytest.raises(RuntimeError, match='no fused kernel'):
        tfused.fused_lambda_step(**meta(f))
    with pytest.raises(RuntimeError, match='no probe kernel'):
        tprobe.elementwise(x.to('meta'))
    counters = (tgamma.line_gamma_rates_cuda, tfused.fused_cuda,
                tprobe.elementwise_cuda, tprobe.recurrence_cuda)
    before = [fn.launches for fn in counters]
    for call in (lambda: tgamma.group_gamma_rates_cuda(**g),
                 lambda: tfused.fused_cuda(**f),
                 lambda: tprobe.elementwise_cuda(x),
                 lambda: tprobe.recurrence_cuda(x[None], x[None])):
        with pytest.raises(ValueError, match='CUDA'):
            call()
    assert [fn.launches for fn in counters] == before


@pytest.mark.gpu
def test_probe_kernels_match_plain():
    """The elementwise probe is exact (2x is exact, so an FMA rounds as
    the plain version does); the recurrence's FMA rounds once per row
    where the plain version rounds twice: 1e-6 in float32."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    x = torch.arange(8 * 128, dtype=torch.float32, device='cuda') \
        .reshape(8, 128)
    assert torch.equal(tprobe.elementwise(x), tprobe.elementwise_plain(x))
    rng = np.random.default_rng(0)
    a, b = (torch.tensor(rng.uniform(0, 1, (64, 256)), dtype=torch.float32,
                         device='cuda') for _ in range(2))
    before = tprobe.recurrence_cuda.launches
    out = tprobe.recurrence(a, b)
    torch.cuda.synchronize()
    assert tprobe.recurrence_cuda.launches == before + 1
    assert _max_rel(out, tprobe.recurrence_plain(a, b)) < 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize('K', [1, 2, 4, 5, 6, 8])
def test_group_gamma_kernel_matches_plain(K):
    """The line kernel against its plain version on the card: the same
    terms summed rows-then-rays instead of rays-then-rows, and FMA
    contraction: 1e-11 of each output's maximum."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    c = _group_case(K, device='cuda', Nlam=300, Nmu=5, Nk=82, seed=K)
    plain = tgamma.group_gamma_rates_plain(**c)
    before = tgamma.line_gamma_rates_cuda.launches
    kern = tgamma.group_gamma_rates(**c)
    torch.cuda.synchronize()
    assert tgamma.line_gamma_rates_cuda.launches == before + 1
    for name, a, b in zip(('G4', 'PPB', 'PairPPB'), kern, plain):
        if name == 'PairPPB' and K == 1:
            assert not a.any()
            continue
        assert _max_rel(a, b) < 1e-11, name


@pytest.mark.gpu
@pytest.mark.parametrize('bcs', [('zero', 'therm'), ('therm', 'data'),
                                 ('data', 'zero')])
def test_fused_kernel_matches_plain(bcs):
    """The fused kernel against its plain version on the card, as the
    sweep kernel: 1e-9 of each output's maximum (FMA contraction in the
    assembly and along the depth chain)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    c = _slots_case(2, *bcs, device='cuda', NL=200, Nmu=5, Nk=82, seed=3)
    plain = tfused.fused_lambda_step_plain(**c)
    before = tfused.fused_cuda.launches
    kern = tfused.fused_lambda_step(**c)
    torch.cuda.synchronize()
    assert tfused.fused_cuda.launches == before + 1
    for name, a, b in zip(('I', 'Psi', 'IeffBase'), kern[:3], plain[:3]):
        assert _max_rel(a, b) < 1e-9, name
    for name in ('J', 'IBar', 'PsiBar', 'IeffSrcBar'):
        assert _max_rel(kern[3][name], plain[3][name]) < 1e-9, name


@pytest.mark.gpu
@pytest.mark.parametrize('scheme', SCHEMES[1:])
def test_scheme_on_cuda_goes_through_its_kernel(scheme):
    """One MALI iteration of a small problem on the card under each
    kernel scheme: the scheme's kernel runs (the line kernel once for all
    line groups, the fused kernel once and the sweep not at all), and J
    and Gamma agree with the same scheme on the CPU to 1e-9 (FMA
    contraction and the card's exp along the depth chain)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    from lightweaver_tpu_torch.problems import falc_interpolated, h6ca_context
    cpu = h6ca_context(falc_interpolated(20), 3, device='cpu')
    gpu = h6ca_context(falc_interpolated(20), 3, device='cuda')
    for ctx in (cpu, gpu):
        ctx.set_fs_iter_scheme(scheme)
    cpu.formal_sol_gamma_matrices()
    counts = (tsweep.sweep_cuda, tgamma.line_gamma_rates_cuda,
              tfused.fused_cuda)
    before = [fn.launches for fn in counts]
    gpu.formal_sol_gamma_matrices()
    torch.cuda.synchronize()
    sweeps, lines, fused = (fn.launches - b for fn, b in zip(counts,
                                                              before))
    if scheme == 'mali_full_precond_pallas':
        assert (sweeps, lines, fused) == (1, 1, 0)
    else:
        assert (sweeps, lines, fused) == (0, 0, 1)
    J, Jref = gpu.J.cpu().numpy(), cpu.J.numpy()
    err = np.abs(J - Jref).max(axis=1) / np.abs(Jref).max(axis=1)
    assert err.max() < 1e-9
    for ai in range(2):
        assert _max_rel(gpu._Gamma[ai].cpu(), cpu._Gamma[ai]) < 1e-9


@pytest.mark.gpu
def test_fused_kernel_matches_plain_on_rho_scaled_slots():
    """C = 3 slots whose coefficient rows carry a PRD ratio rho != 1, as
    context.fused_inputs forms them: chiCo = (ni - g rho nj) a1 and
    etaCo = u g a1 rho nj, here chiCo - rho x and etaCo x rho for random
    rho in [0.5, 1.5].  The bar is the plain slots' 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    c = _slots_case(3, 'therm', 'therm', device='cuda', NL=200, Nmu=5,
                    Nk=82, seed=7)
    rho = torch.tensor(np.random.default_rng(7).uniform(0.5, 1.5,
                                                        c['chiCo'].shape),
                       dtype=torch.float64, device='cuda')
    c['chiCo'] = c['chiCo'] * (1.5 - 0.5 * rho)
    c['etaCo'] = c['etaCo'] * rho
    plain = tfused.fused_lambda_step_plain(**c)
    before = tfused.fused_cuda.launches
    kern = tfused.fused_lambda_step(**c)
    torch.cuda.synchronize()
    assert tfused.fused_cuda.launches == before + 1
    for name, a, b in zip(('I', 'Psi', 'IeffBase'), kern[:3], plain[:3]):
        assert _max_rel(a, b) < 1e-9, name
    for name in ('J', 'IBar', 'PsiBar', 'IeffSrcBar'):
        assert _max_rel(kern[3][name], plain[3][name]) < 1e-9, name


def _h6mg_after_redistribution(device, scheme='mali_full_precond',
                               dtype=None):
    """A small falc_h6mg (20 depths, 3 rays) after one MALI step and one
    prd_redistribute, so that rho != 1 on every PRD line."""
    from lightweaver_tpu_torch.problems import falc_interpolated, h6mg_context
    ctx = h6mg_context(falc_interpolated(20), 3, device=device, dtype=dtype)
    ctx.set_fs_iter_scheme(scheme)
    ctx.formal_sol_gamma_matrices()
    ctx.stat_equil()
    ctx.prd_redistribute(maxIter=1)
    return ctx


@pytest.mark.gpu
def test_kernels_match_plain_on_prd_inputs():
    """The line kernel on every group of falc_h6mg in one launch (Mg II's
    four-line group among them) and the fused kernel (C = 3 slots) with
    the live rho != 1, each against its plain version at its bar: 1e-11
    and 1e-9 of each output's maximum."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    import dataclasses

    from lightweaver_tpu_torch.context import build_iteration_fn
    ctx = _h6mg_after_redistribution('cuda')
    params = ctx.build_params()
    scaJ = params['bgSca'] * params['J']
    chi, src = ctx._iter_fn.gather(params, scaJ)
    rays = ctx._iter_fn.formal_solve(params, chi, src)
    cfg = ctx.cfg
    itP = build_iteration_fn(dataclasses.replace(
        cfg, fsIterScheme='mali_full_precond_pallas'))
    args = itP.line_inputs(params, *rays[:3], src, itP.pack(params))
    assert max(g.K for g in args[0].groups) == 4
    kern = args[0].views(*tgamma.line_gamma_rates(*args))
    plain = args[0].views(*tgamma.line_gamma_rates_plain(*args))
    for g, k3, p3 in zip(args[0].groups, kern, plain):
        for name, a, b in zip(('G4', 'PPB', 'PairPPB'), k3, p3):
            if b.any():
                assert _max_rel(a, b) < 1e-11, (g.members, name)
    itF = build_iteration_fn(dataclasses.replace(
        cfg, fsIterScheme='mali_full_precond_fused'))
    args = itF.fused_inputs(params, scaJ, itF.pack(params))
    assert args[0].shape[0] == 3
    kern = tfused.fused_lambda_step(*args)
    plain = tfused.fused_lambda_step_plain(*args)
    for name, a, b in zip(('I', 'Psi', 'IeffBase'), kern[:3], plain[:3]):
        assert _max_rel(a, b) < 1e-9, name
    for name in ('J', 'IBar', 'PsiBar', 'IeffSrcBar'):
        assert _max_rel(kern[3][name], plain[3][name]) < 1e-9, name


@pytest.mark.gpu
@pytest.mark.parametrize('scheme', SCHEMES)
def test_prd_on_cuda_goes_through_its_kernels(scheme):
    """falc_h6mg (20 depths, 3 rays) under each scheme on the card: the
    MALI step launches the scheme's kernels (the line kernel once for all
    groups), each PRD sub-iteration's
    subset solve launches the sweep once, and J and rho after a MALI step
    and a prd_redistribute agree with the CPU's to 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    counts = (tsweep.sweep_cuda, tgamma.line_gamma_rates_cuda,
              tfused.fused_cuda)
    before = [fn.launches for fn in counts]
    gpu = _h6mg_after_redistribution('cuda', scheme)
    torch.cuda.synchronize()
    sweeps, lines, fused = (fn.launches - b for fn, b in zip(counts,
                                                              before))
    expected = {'mali_full_precond': (2, 0, 0),
                'mali_full_precond_pallas': (2, 1, 0),
                'mali_full_precond_fused': (1, 0, 1)}[scheme]
    assert (sweeps, lines, fused) == expected
    cpu = _h6mg_after_redistribution('cpu', scheme)
    J, Jref = gpu.J.cpu().numpy(), cpu.J.numpy()
    err = np.abs(J - Jref).max(axis=1) / np.abs(Jref).max(axis=1)
    assert err.max() < 1e-9
    for ai, ti, _, _ in cpu._prd_lines():
        assert _max_rel(gpu.rhoPrd[ai][ti].cpu(), cpu.rhoPrd[ai][ti]) < 1e-9


def _f32_rule(kern, plain, ref):
    """Each float32 kernel output is as close to the float64 plain version
    on the same inputs as the float32 plain version is, within 2x + 1e-6
    (two float32 orderings of the same sums; chip_smoke.py's rule)."""
    for k, p, r in zip(kern, plain, ref):
        if not r.any():
            assert not k.any()
            continue
        assert _max_rel(k.double(), r) <= 2 * _max_rel(p.double(), r) + 1e-6


def _f32_args(args):
    """float32 copies of a case's floating tensors, and float64 copies of
    those (the same float32-representable values)."""
    def conv(a, dt):
        if torch.is_tensor(a):
            return a.to(dt) if a.is_floating_point() else a
        if isinstance(a, tuple) and len(a) == 2 and isinstance(a[0], str):
            return (a[0], conv(a[1], dt))
        return a
    a32 = {k: conv(v, torch.float32) for k, v in args.items()}
    return a32, {k: conv(v, torch.float64) for k, v in a32.items()}


def _ray_list(out):
    return list(out[:3]) + [out[3][k] for k in ('J', 'PsiBar', 'IBar',
                                                  'IeffSrcBar')]


@pytest.mark.gpu
@pytest.mark.parametrize('Nk', SWEEP_NK)
def test_f32_sweep_kernel_matches_plain(Nk):
    """The float32 sweep instance on the card: every output by the rule of
    _f32_rule, J float64 and equal to the float64 sum of the kernel's own
    float32 products w I to 1e-13; the float64 count does not move."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    c32, c64 = _f32_args(_sweep_case(1046, 5, Nk, seed=5, device='cuda'))
    before = (tsweep.sweep_cuda.launches, tsweep.sweep_cuda.launches_f32)
    kern = tsweep.formal_solve_sweep(**c32)
    torch.cuda.synchronize()
    assert (tsweep.sweep_cuda.launches,
            tsweep.sweep_cuda.launches_f32) == (before[0], before[1] + 1)
    _f32_rule(_ray_list(kern), _ray_list(tsweep.formal_solve_sweep_plain(
        **c32)), _ray_list(tsweep.formal_solve_sweep_plain(**c64)))
    w = 0.5 * c32['wmu']
    own = [sum((w[m] * kern[0][d, :, m]).double() for m in range(5))
           for d in range(2)]
    assert kern[3]['J'].dtype == torch.float64
    assert _max_rel(kern[3]['J'], own[0] + own[1]) <= 1e-13


@pytest.mark.gpu
@pytest.mark.parametrize('K', [1, 2, 4, 5, 6, 8])
def test_f32_group_gamma_kernel_matches_plain(K):
    """The float32 line Gamma instance on the card by the rule of
    _f32_rule: float partials, G4 float32."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    c32, c64 = _f32_args(_group_case(K, device='cuda', Nlam=300, Nmu=5,
                                     Nk=82, seed=K))
    before = tgamma.line_gamma_rates_cuda.launches_f32
    kern = tgamma.group_gamma_rates(**c32)
    torch.cuda.synchronize()
    assert tgamma.line_gamma_rates_cuda.launches_f32 == before + 1
    assert kern[0].dtype == torch.float32
    _f32_rule(kern, tgamma.group_gamma_rates_plain(**c32),
              tgamma.group_gamma_rates_plain(**c64))


@pytest.mark.gpu
@pytest.mark.parametrize('bcs', [('zero', 'therm'), ('therm', 'data')])
def test_f32_fused_kernel_matches_plain(bcs):
    """The float32 fused instance on the card by the rule of _f32_rule, J
    in float64."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    c32, c64 = _f32_args(_slots_case(2, *bcs, device='cuda', NL=200, Nmu=5,
                                     Nk=82, seed=3))
    before = tfused.fused_cuda.launches_f32
    kern = tfused.fused_lambda_step(**c32)
    torch.cuda.synchronize()
    assert tfused.fused_cuda.launches_f32 == before + 1
    assert kern[3]['J'].dtype == torch.float64
    _f32_rule(_ray_list(kern), _ray_list(tfused.fused_lambda_step_plain(
        **c32)), _ray_list(tfused.fused_lambda_step_plain(**c64)))


@pytest.mark.gpu
@pytest.mark.parametrize('scheme', SCHEMES)
def test_f32_scheme_on_cuda_goes_through_its_f32_kernel(scheme):
    """One MALI iteration of a small float32 problem on the card under each
    scheme launches the scheme's float32 instances and no float64 one; J,
    Gamma and the rates come out float64."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    from lightweaver_tpu_torch.problems import falc_interpolated, h6ca_context
    ctx = h6ca_context(falc_interpolated(20), 3, device='cuda',
                       dtype=torch.float32)
    ctx.set_fs_iter_scheme(scheme)
    counts = [(fn, attr) for fn in (tsweep.sweep_cuda,
                                    tgamma.line_gamma_rates_cuda,
                                    tfused.fused_cuda)
              for attr in ('launches_f32', 'launches')]
    before = [getattr(fn, attr) for fn, attr in counts]
    ctx.formal_sol_gamma_matrices()
    torch.cuda.synchronize()
    got = [getattr(fn, attr) - b for (fn, attr), b in zip(counts, before)]
    expected = {'mali_full_precond': [1, 0, 0, 0, 0, 0],
                'mali_full_precond_pallas': [1, 0, 1, 0, 0, 0],
                'mali_full_precond_fused': [0, 0, 0, 0, 1, 0]}[scheme]
    assert got == expected
    assert ctx.J.dtype == ctx._Gamma[0].dtype == torch.float64
    assert ctx._Rij[0][0].dtype == torch.float64


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_packed_line_kernel_matches_plain(dtype):
    """One launch of the line kernel for every group of falc_h6mg (20
    depths, 3 rays, rho != 1, Mg II's K = 4 group) against
    line_gamma_rates_plain: 1e-11 of each output's maximum in float64;
    in float32 by the rule of _f32_rule with the float64 plain version on
    the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    import dataclasses

    from lightweaver_tpu_torch.context import build_iteration_fn
    ctx = _h6mg_after_redistribution('cuda', dtype=dtype)
    itP = build_iteration_fn(dataclasses.replace(
        ctx.cfg, fsIterScheme='mali_full_precond_pallas'))
    params = ctx.build_params()
    chi, src = itP.gather(params, itP.scaJ(params))
    rays = itP.formal_solve(params, chi, src)
    args = itP.line_inputs(params, *rays[:3], src, itP.pack(params))
    table = args[0]
    assert max(g.K for g in table.groups) == 4
    assert (args[1] != 1.0).any()
    before = tgamma.line_gamma_rates_cuda.launches_f32 \
        if dtype == torch.float32 else tgamma.line_gamma_rates_cuda.launches
    kern = tgamma.line_gamma_rates(*args)
    torch.cuda.synchronize()
    after = tgamma.line_gamma_rates_cuda.launches_f32 \
        if dtype == torch.float32 else tgamma.line_gamma_rates_cuda.launches
    assert after == before + 1
    plain = tgamma.line_gamma_rates_plain(*args)
    if dtype == torch.float64:
        for name, a, b in zip(('G4', 'PPB', 'PairPPB'), kern, plain):
            assert _max_rel(a, b) < 1e-11, name
        return
    assert kern[0].dtype == torch.float32
    up = [x.double() if torch.is_tensor(x) else x for x in args[1:]]
    ref = tgamma.line_gamma_rates_plain(table.to(torch.float64), *up)
    for k3, p3, r3 in zip(*(table.views(*x) for x in (kern, plain, ref))):
        _f32_rule(k3, p3, r3)


RAY_COUNTS = [1, 5, 17, 32]
RAY_NK = [3, 33, 500]
DTYPES = [torch.float64, torch.float32]


def _check_instance(kern, plain, ref, dtype, wmu):
    """float64: every output within 1e-9 of the plain version's maximum
    (the sweep's bar); float32: the rule of _f32_rule, J float64 and
    equal to the float64 sum of the kernel's own float32 products w I to
    1e-13 (mu ascending within a direction, then down + up)."""
    if dtype == torch.float64:
        for a, b in zip(_ray_list(kern), _ray_list(plain)):
            assert _max_rel(a, b) < 1e-9
        return
    _f32_rule(_ray_list(kern), _ray_list(plain), _ray_list(ref))
    w = 0.5 * wmu
    own = [sum((w[m] * kern[0][d, :, m]).double()
               for m in range(kern[0].shape[2])) for d in range(2)]
    assert kern[3]['J'].dtype == torch.float64
    assert _max_rel(kern[3]['J'], own[0] + own[1]) <= 1e-13


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('Nk', RAY_NK)
@pytest.mark.parametrize('Nmu', RAY_COUNTS)
def test_sweep_kernel_takes_any_number_of_rays(Nmu, Nk, dtype):
    """The sweep kernel against its plain version at 1 to 32 rays per
    direction (17 and 32 in two passes of 17 and 32 warps) and at the
    edges of its chunks, in each instance (_check_instance)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    c = _sweep_case(64, Nmu, Nk, seed=Nmu + Nk, device='cuda')
    ref = None
    if dtype == torch.float32:
        c, c64 = _f32_args(c)
        ref = tsweep.formal_solve_sweep_plain(**c64)
    attr = 'launches_f32' if dtype == torch.float32 else 'launches'
    before = getattr(tsweep.sweep_cuda, attr)
    kern = tsweep.formal_solve_sweep(**c)
    torch.cuda.synchronize()
    assert getattr(tsweep.sweep_cuda, attr) == before + 1
    _check_instance(kern, tsweep.formal_solve_sweep_plain(**c), ref, dtype,
                    c['wmu'])


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('Nk', RAY_NK)
@pytest.mark.parametrize('Nmu', RAY_COUNTS)
def test_fused_kernel_takes_any_number_of_rays(Nmu, Nk, dtype):
    """The fused kernel against its plain version at 1 to 32 rays per
    direction, C = 1, 2 and 3 slots and each boundary kind at each end,
    in each instance (_check_instance)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    attr = 'launches_f32' if dtype == torch.float32 else 'launches'
    for C in (1, 2, 3):
        for bcs in (('zero', 'therm'), ('therm', 'data'), ('data', 'zero')):
            c = _slots_case(C, *bcs, device='cuda', NL=48, Nmu=Nmu, Nk=Nk,
                            seed=C + Nmu + Nk)
            ref = None
            if dtype == torch.float32:
                c, c64 = _f32_args(c)
                ref = tfused.fused_lambda_step_plain(**c64)
            before = getattr(tfused.fused_cuda, attr)
            kern = tfused.fused_lambda_step(**c)
            torch.cuda.synchronize()
            assert getattr(tfused.fused_cuda, attr) == before + 1
            _check_instance(kern, tfused.fused_lambda_step_plain(**c), ref,
                            dtype, c['wmu'])


@pytest.mark.gpu
@pytest.mark.parametrize('scheme', SCHEMES)
def test_twenty_rays_on_cuda_under_each_scheme(scheme):
    """falc_h6mg (20 depths) with 20 rays, past one pass of the sweep and
    fused kernels: a MALI step, stat_equil and one prd_redistribute on
    the card go through the scheme's kernels (the PRD subset solve
    through the sweep), and J and rho agree with the CPU's to 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    from lightweaver_tpu_torch.problems import falc_interpolated, h6mg_context

    def run(device):
        ctx = h6mg_context(falc_interpolated(20), 20, device=device)
        ctx.set_fs_iter_scheme(scheme)
        ctx.formal_sol_gamma_matrices()
        ctx.stat_equil()
        ctx.prd_redistribute(maxIter=1)
        return ctx
    counts = (tsweep.sweep_cuda, tgamma.line_gamma_rates_cuda,
              tfused.fused_cuda)
    before = [fn.launches for fn in counts]
    gpu = run('cuda')
    torch.cuda.synchronize()
    assert gpu.cfg.Nmu == 20
    got = tuple(fn.launches - b for fn, b in zip(counts, before))
    assert got == {'mali_full_precond': (2, 0, 0),
                   'mali_full_precond_pallas': (2, 1, 0),
                   'mali_full_precond_fused': (1, 0, 1)}[scheme]
    cpu = run('cpu')
    J, Jref = gpu.J.cpu().numpy(), cpu.J.numpy()
    err = np.abs(J - Jref).max(axis=1) / np.abs(Jref).max(axis=1)
    assert err.max() < 1e-9
    for ai, ti, _, _ in cpu._prd_lines():
        assert _max_rel(gpu.rhoPrd[ai][ti].cpu(), cpu.rhoPrd[ai][ti]) < 1e-9
