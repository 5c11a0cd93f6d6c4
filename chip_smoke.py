"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero and prints no
result):

1. Environment: torch and CUDA versions, the card's name and power limit;
   then the four kernel libraries are built from csrc/ at once, one nvcc
   each, with ptxas's registers and spills.
2. Probes: the two toolchain probes (csrc/probe.cu) against their plain
   versions (2x + 1 exactly, the recurrence within 1e-6 in f32).
3. Sweep kernel: csrc/sweep.cu against its plain PyTorch version on the
   card, in f64, at the main path's shapes (Nlam=1046, Nmu=5, Nk=82 and
   500), inputs from a numpy seed; times of both.
4. Scheme kernels: the line Gamma kernel (csrc/gamma.cu, every line group)
   and the fused lambda step (csrc/fused.cu) against their plain versions
   on the inputs of one iteration of falc_h6ca and of FALC-500; times.
5. Main path: falc_h6ca (FAL-C, H 6-level + Ca II active, 5 rays) on the
   card through Context and iterate_ctx_se, against the compiled
   reference's golden run (tests/golden/falc_h6ca_ref.npz); the sweep
   kernel's launch count over that run.
6. The same under each iteration scheme, 'mali_full_precond_pallas' and
   'mali_full_precond_fused', with the launch counts of their kernels.
7. PRD kernel inputs: falc_h6mg (FAL-C, H 6-level + Mg II active, 5
   rays, Ly-alpha, Ly-beta and Mg II h & k in PRD) after three MALI
   steps and one prd_redistribute, so rho != 1: the line Gamma kernel on
   every group (Mg II's four-line group among them), the fused kernel
   with its three rho-scaled slots and the sweep on the PRD subset rows,
   each against its plain version; times.
8. falc_h6mg PRD converged under each scheme through
   iterate_ctx_se(prd=True), and its hybrid-PRD variant (0-5 km/s
   outflow) under the default scheme, against their golden runs
   (tests/golden/falc_h6mg_{prd,hprd}_ref.npz), with iterations, PRD
   sub-iterations, wall time and launch counts; the kernel schemes must
   refuse hybrid PRD.  Then a stage breakdown of one PRD iteration.
9. FALC-500 (the same setup as falc_h6ca interpolated to 500 depths,
   bench.py's problem): 50 formal_sol_gamma_matrices iterations, best of
   3, and a per-stage breakdown; then each scheme: best of 3 blocks of
   20 and its stage breakdown.

The kernels' JSON record holds phase 7's errors and times and phase 8's
launch counts for the three kernels of the PRD path, and the probes'.
The last three lines are the card's name and power limit as nvidia-smi
prints them, the kernels' JSON record and the ok line.
"""
import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
NITER_REF_SLACK = 2
GOLDEN_RTOL = 1e-7
# nvcc contracts multiply-adds into FMAs, the plain version's separate
# torch ops do not; the difference compounds along the depth chain
KERNEL_TOL = 1e-9
# the line kernel sums the same products as its plain version, rows then
# rays instead of rays then rows, with FMAs; no depth chain
GAMMA_TOL = 1e-11
# float32 recurrence: one FMA rounding per row against two
PROBE_TOL = 1e-6
PALLAS = 'mali_full_precond_pallas'
FUSED = 'mali_full_precond_fused'


def phase(name):
    print(f'== {name}', flush=True)


def relerr(ours, ref):
    ours = np.asarray(ours)
    ref = np.asarray(ref)
    return float((np.abs(ours - ref) / np.abs(ref).clip(1e-300)).max())


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def environment():
    phase('environment')
    if not torch.cuda.is_available():
        print('no CUDA device: this smoke run needs an NVIDIA GPU',
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}')
    print(f'nvidia-smi: {smi}')
    return smi


def counters():
    from lightweaver_tpu_torch.ops import fused, gamma, probe, sweep
    return {'sweep': sweep.sweep_cuda,
            'gamma': gamma.group_gamma_rates_cuda,
            'fused': fused.fused_cuda,
            'probe_elementwise': probe.elementwise_cuda,
            'probe_recurrence': probe.recurrence_cuda}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def build_kernels():
    """Build the four libraries at once (one nvcc each, in threads: the
    compiler runs outside the interpreter lock) and print ptxas's
    registers and spills, also for a cached build."""
    from lightweaver_tpu_torch.ops import _build, fused, gamma, probe, sweep
    phase('build the CUDA kernels from csrc/ (nvcc, sm_90a)')
    mods = {'probe': probe, 'sweep': sweep, 'gamma': gamma, 'fused': fused}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as ex:
        list(ex.map(lambda m: m.load_library(), mods.values()))
    print(f'built {", ".join(f"csrc/{n}.cu" for n in mods)} in '
          f'{time.perf_counter() - t0:.1f} s; nvcc flags: '
          f'{" ".join(_build.NVCC_FLAGS)}')
    for name in mods:
        for line in _build.build_log(name).splitlines():
            if any(w in line for w in ('Compiling entry', 'registers',
                                       'spill', 'error')):
                print(f'  {name} ptxas: {line.strip()}')


def max_rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def probe_check():
    """pallas_probe.py's two checks on the card (the inputs of that
    script), then random inputs for the recurrence; times."""
    from lightweaver_tpu_torch.ops import probe
    phase('probes: elementwise 2x+1 and the row recurrence (f32)')
    x = torch.arange(8 * 128, dtype=torch.float32,
                     device='cuda').reshape(8, 128)
    a = torch.full((64, 256), 0.5, device='cuda')
    b = torch.ones((64, 256), device='cuda')
    reset_counts()
    outE = probe.elementwise(x)
    outR = probe.recurrence(a, b)
    torch.cuda.synchronize()
    counts = read_counts()
    rng = np.random.default_rng(0)
    a2, b2 = (torch.tensor(rng.uniform(0, 1, (64, 256)), dtype=torch.float32,
                           device='cuda') for _ in range(2))
    absErr = {'probe_elementwise': (outE - probe.elementwise_plain(x))
              .abs().max().item(),
              'probe_recurrence': (outR - probe.recurrence_plain(a, b))
              .abs().max().item()}
    relRandom = max_rel(probe.recurrence(a2, b2),
                        probe.recurrence_plain(a2, b2))
    torch.cuda.synchronize()
    print(f'  elementwise max|kernel-plain| = '
          f'{absErr["probe_elementwise"]:.3e} (exact required); recurrence '
          f'max|kernel-plain| = {absErr["probe_recurrence"]:.3e} on the '
          f'probe inputs, max|kernel-plain|/max|plain| = {relRandom:.3e} on '
          f'random ones (bar {PROBE_TOL})')
    if absErr['probe_elementwise'] != 0.0:
        raise AssertionError('elementwise probe is not exact')
    if relRandom > PROBE_TOL or absErr['probe_recurrence'] > PROBE_TOL:
        raise AssertionError('recurrence probe disagrees')
    result = {}
    for name, kern, plain in (
            ('probe_elementwise', lambda: probe.elementwise(x),
             lambda: probe.elementwise_plain(x)),
            ('probe_recurrence', lambda: probe.recurrence(a2, b2),
             lambda: probe.recurrence_plain(a2, b2))):
        p1, k1, k2, p2 = (cuda_ms(f, 20) for f in (plain, kern, kern, plain))
        print(f'  {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / '
              f'{p2:.4f} ms per call; launches in the probe run '
              f'{counts[name]}')
        if counts[name] < 1:
            raise AssertionError(f'{name} kernel did not launch')
        result[name] = dict(launches=counts[name], max_abs_err=absErr[name],
                            ms=min(k1, k2), plain_ms=min(p1, p2))
    return result


def kernel_check():
    """The sweep kernel against its plain version on random rays at the
    main path's shapes; times."""
    from lightweaver_tpu_torch.ops import sweep
    from lightweaver_tpu_torch.problems import random_rays
    phase('sweep kernel: compare with the plain version (f64)')
    for Nk in (82, 500):
        c = {k: torch.tensor(v, dtype=torch.float64, device='cuda')
             for k, v in random_rays(1046, 5, Nk, seed=Nk).items()}
        plain = sweep.formal_solve_sweep_plain(**c)
        kern = sweep.formal_solve_sweep(**c)
        torch.cuda.synchronize()
        rel, absErr = compare_outputs(f'sweep Nk={Nk}', RAY_NAMES,
                                      ray_outputs(kern), ray_outputs(plain),
                                      KERNEL_TOL)
        print(f'  Nk={Nk} sweep: max|kernel-plain|/max|plain| = {rel:.3e} '
              f'(bar {KERNEL_TOL}), max abs {absErr:.3e}')
        timed_pair(f'Nk={Nk} sweep, per call (1046 x 5 x 2 rays)',
                   lambda: sweep.formal_solve_sweep(**c),
                   lambda: sweep.formal_solve_sweep_plain(**c))


def one_iteration_inputs(Nk):
    """The Context of falc_h6ca (Nk=82) or FALC-500 on the card after one
    MALI step, its params and this iteration's rays (default scheme)."""
    from lightweaver_tpu_torch.fal import Falc82
    from lightweaver_tpu_torch.problems import falc_interpolated, h6ca_context
    atmos = Falc82() if Nk == 82 else falc_interpolated(Nk)
    ctx = h6ca_context(atmos, 5, device='cuda')
    ctx.formal_sol_gamma_matrices()
    ctx.stat_equil()
    params = ctx.build_params()
    scaJ = params['bgSca'] * params['J']
    chi, src = ctx._iter_fn.gather(params, scaJ)
    rays = ctx._iter_fn.formal_solve(params, chi, src)
    return ctx, params, scaJ, src, rays


def compare_outputs(label, names, kern, plain, tol):
    worstRel = worstAbs = 0.0
    for n, a, b in zip(names, kern, plain):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f'non-finite {n} ({label})')
        if not b.any():
            # K = 1 groups have one zero pair row, on both sides
            if a.any():
                raise AssertionError(f'{n} should be zero ({label})')
            continue
        absErr = (a - b).abs().max().item()
        rel = absErr / b.abs().max().item()
        worstRel, worstAbs = max(worstRel, rel), max(worstAbs, absErr)
        if rel > tol:
            raise AssertionError(f'kernel disagrees on {n} ({label}): '
                                 f'{rel:.3e} > {tol}')
    return worstRel, worstAbs


RAY_NAMES = ('I', 'Psi', 'IeffBase', 'J', 'PsiBar', 'IBar', 'IeffSrcBar')


def ray_outputs(out):
    """(I, Psi, IeffBase, moments) as one list in RAY_NAMES order."""
    return list(out[:3]) + [out[3][k] for k in RAY_NAMES[3:]]


def timed_pair(label, kern, plain, reps=20):
    """Kernel and plain version in turns (plain, kernel, kernel, plain);
    the min of each pair."""
    p1, k1, k2, p2 = (cuda_ms(f, r) for f, r in (
        (plain, 3), (kern, reps), (kern, reps), (plain, 3)))
    print(f'  {label}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / '
          f'{p2:.4f} ms')
    return min(k1, k2), min(p1, p2)


def check_line_kernel(label, ctx, params, src, rays):
    """The line Gamma kernel on every line group of one iteration against
    its plain version; the time of all groups."""
    from lightweaver_tpu_torch.context import build_iteration_fn
    from lightweaver_tpu_torch.ops import gamma
    itP = build_iteration_fn(dataclasses.replace(ctx.cfg,
                                                 fsIterScheme=PALLAS))
    groups = list(itP.line_group_inputs(params, *rays[:3], src,
                                        itP.pack(params)))
    worst = [0.0, 0.0]
    for ai, g, args in groups:
        plain = gamma.group_gamma_rates_plain(*args)
        kern = gamma.group_gamma_rates(*args)
        torch.cuda.synchronize()
        rel, absErr = compare_outputs(
            f'{label} atom {ai} group {g["members"]}',
            ('G4', 'PPB', 'PairPPB'), kern, plain, GAMMA_TOL)
        worst = [max(worst[0], rel), max(worst[1], absErr)]
        rhoDev = (args[1] - 1.0).abs().max().item()
        if rhoDev > 0.0 or len(g['members']) > 3:
            print(f'  {label} atom {ai} group {g["members"]} (K = '
                  f'{len(g["members"])}, max|rho-1| = {rhoDev:.3e}): '
                  f'max|kernel-plain|/max|plain| = {rel:.3e}')
    print(f'  {label} line Gamma, {len(groups)} groups: '
          f'max|kernel-plain|/max|plain| = {worst[0]:.3e} (bar '
          f'{GAMMA_TOL}), max abs {worst[1]:.3e}')
    ms, plainMs = timed_pair(
        f'{label} line Gamma, all groups of one iteration',
        lambda: [gamma.group_gamma_rates(*a) for _, _, a in groups],
        lambda: [gamma.group_gamma_rates_plain(*a) for _, _, a in groups])
    return dict(max_abs_err=worst[1], max_rel_err=worst[0], ms=ms,
                plain_ms=plainMs,
                K=max(len(g['members']) for _, g, _ in groups))


def check_fused_kernel(label, ctx, params, scaJ):
    """The fused kernel on the fused scheme's inputs for the same state
    against its plain version; its time."""
    from lightweaver_tpu_torch.context import build_iteration_fn
    from lightweaver_tpu_torch.ops import fused
    itF = build_iteration_fn(dataclasses.replace(ctx.cfg, fsIterScheme=FUSED))
    args = itF.fused_inputs(params, scaJ, itF.pack(params))
    plain = fused.fused_lambda_step_plain(*args)
    kern = fused.fused_lambda_step(*args)
    torch.cuda.synchronize()
    rel, absErr = compare_outputs(f'fused {label}', RAY_NAMES,
                                  ray_outputs(kern), ray_outputs(plain),
                                  KERNEL_TOL)
    C = args[0].shape[0]
    print(f'  {label} fused (C={C} slots): max|kernel-plain|/max|plain| = '
          f'{rel:.3e} (bar {KERNEL_TOL}), max abs {absErr:.3e}')
    ms, plainMs = timed_pair(f'{label} fused, per call',
                             lambda: fused.fused_lambda_step(*args),
                             lambda: fused.fused_lambda_step_plain(*args))
    return dict(max_abs_err=absErr, max_rel_err=rel, ms=ms, plain_ms=plainMs,
                C=C)


def scheme_kernel_check():
    """The line Gamma kernel on every line group and the fused kernel, on
    the inputs of one iteration at Nk=82 and 500, against their plain
    versions; per-iteration times (all groups for the line kernel)."""
    phase('scheme kernels: line Gamma (csrc/gamma.cu) and fused lambda '
          'step (csrc/fused.cu) vs their plain versions (f64)')
    for Nk in (82, 500):
        ctx, params, scaJ, src, rays = one_iteration_inputs(Nk)
        check_line_kernel(f'Nk={Nk}', ctx, params, src, rays)
        check_fused_kernel(f'Nk={Nk}', ctx, params, scaJ)
        del ctx, params, rays
        torch.cuda.empty_cache()


def prd_kernel_check():
    """The three kernels on the inputs of one iteration of falc_h6mg after
    three MALI steps and one prd_redistribute (rho != 1): the line Gamma
    kernel on every group (Mg II's four-line group among them), the fused
    kernel with C = 3 rho-scaled slots, and the sweep on the PRD subset
    rows, each against its plain version; times."""
    from lightweaver_tpu_torch.context import build_prd_subset_fn
    from lightweaver_tpu_torch.ops import sweep
    from lightweaver_tpu_torch.problems import h6mg_context
    phase('PRD kernel inputs: falc_h6mg after 3 MALI steps and one '
          'prd_redistribute (f64, rho != 1)')
    ctx = h6mg_context(device='cuda')
    for _ in range(3):
        ctx.formal_sol_gamma_matrices()
        ctx.stat_equil()
    ctx.prd_redistribute()
    rhoDev = max((r - 1.0).abs().max().item() for row in ctx.rhoPrd
                 for r in row if r is not None)
    print(f'  max|rho-1| over the PRD lines = {rhoDev:.3e}')
    if not rhoDev > 0.1:
        raise AssertionError('rho stayed at 1 after prd_redistribute')
    params = ctx.build_params()
    scaJ = params['bgSca'] * params['J']
    chi, src = ctx._iter_fn.gather(params, scaJ)
    rays = ctx._iter_fn.formal_solve(params, chi, src)
    result = {'gamma': check_line_kernel('PRD', ctx, params, src, rays),
              'fused': check_fused_kernel('PRD', ctx, params, scaJ)}
    if result['gamma']['K'] != 4 or result['fused']['C'] != 3:
        raise AssertionError(f'expected a K = 4 line group and C = 3 slots, '
                             f'got {result["gamma"]["K"]} and '
                             f'{result["fused"]["C"]}')

    sub = ctx._prd_subset_idxs()
    lines = [(ai, ti) for ai, ti, _, _ in ctx._prd_lines()]
    args = build_prd_subset_fn(ctx.cfg, sub, lines).sweep_inputs(params)
    plain = sweep.formal_solve_sweep_plain(*args)
    kern = sweep.formal_solve_sweep(*args)
    torch.cuda.synchronize()
    rel, absErr = compare_outputs('PRD subset sweep', RAY_NAMES,
                                  ray_outputs(kern), ray_outputs(plain),
                                  KERNEL_TOL)
    print(f'  PRD subset sweep ({len(sub)} of {ctx.cfg.Nlam} rows): '
          f'max|kernel-plain|/max|plain| = {rel:.3e} (bar {KERNEL_TOL}), '
          f'max abs {absErr:.3e}')
    ms, plainMs = timed_pair('PRD subset sweep, per call',
                             lambda: sweep.formal_solve_sweep(*args),
                             lambda: sweep.formal_solve_sweep_plain(*args))
    result['sweep'] = dict(max_abs_err=absErr, max_rel_err=rel, ms=ms,
                           plain_ms=plainMs)
    del ctx, params, rays, args, plain, kern
    torch.cuda.empty_cache()
    return result


def converge_falc_h6ca(scheme):
    """falc_h6ca converged on the card under ``scheme``, held against the
    golden run; returns (iterations, launch counts of the run)."""
    from lightweaver_tpu_torch import iterate_ctx_se
    from lightweaver_tpu_torch.fal import Falc82
    from lightweaver_tpu_torch.problems import h6ca_context
    ref = np.load(ROOT / 'tests' / 'golden' / 'falc_h6ca_ref.npz')
    t0 = time.perf_counter()
    ctx = h6ca_context(Falc82(), 5, device='cuda')
    if scheme is not None:
        ctx.set_fs_iter_scheme(scheme)
    torch.cuda.synchronize()
    print(f'Context on {ctx.device}: Nlam={ctx.cfg.Nlam} Nmu={ctx.cfg.Nmu} '
          f'Nk={ctx.cfg.Nk}, scheme {ctx.cfg.fsIterScheme}, built in '
          f'{time.perf_counter() - t0:.2f} s')

    reset_counts()
    t0 = time.perf_counter()
    nIter = iterate_ctx_se(ctx, NmaxIter=500, quiet=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()

    nIterRef = int(ref['out_niter'][0])
    errs = {f'pops_a{ia}': relerr(ctx.popsState[ia]['n'].cpu(),
                                  ref[f'out_pops_a{ia}']) for ia in range(2)}
    errs['J'] = relerr(ctx.J.cpu(), ref['out_J'])
    errs['I'] = relerr(ctx.I.cpu(), ref['out_I'])
    print(f'converged in {nIter} iterations (reference {nIterRef}); '
          f'{wall:.2f} s, {wall / nIter * 1e3:.3f} ms/iter '
          '(formal_sol_gamma_matrices + stat_equil, host clock)')
    print('max relative error vs golden: '
          + ', '.join(f'{k} {v:.3e}' for k, v in errs.items()))
    print('kernel launches over the run: '
          + ', '.join(f'{k} {v}' for k, v in counts.items())
          + f' ({nIter} formal_sol_gamma_matrices calls)')
    if abs(nIter - nIterRef) > NITER_REF_SLACK:
        raise AssertionError(f'{nIter} iterations vs reference {nIterRef}')
    bad = {k: v for k, v in errs.items() if not v < GOLDEN_RTOL}
    if bad:
        raise AssertionError(f'golden mismatch above {GOLDEN_RTOL}: {bad}')
    return ctx, nIter, counts


def main_path():
    phase('main path: falc_h6ca on the card vs the golden reference')
    _, nIter, counts = converge_falc_h6ca(None)
    if counts['sweep'] < nIter:
        raise AssertionError(f'sweep kernel launched {counts["sweep"]} '
                             f'times in {nIter} iterations')


def scheme_paths():
    """falc_h6ca under each kernel scheme; the launch counts show that the
    scheme's kernel ran: the line kernel once per group per iteration, the
    fused kernel once per iteration and the sweep never."""
    from lightweaver_tpu_torch.ops import gamma
    for scheme in (PALLAS, FUSED):
        phase(f'scheme {scheme}: falc_h6ca on the card vs the golden '
              'reference')
        ctx, nIter, counts = converge_falc_h6ca(scheme)
        if scheme == PALLAS:
            nGroups = sum(len(gamma.line_groups(a)) for a in ctx.activeAtoms)
            if counts['gamma'] < nGroups * nIter:
                raise AssertionError(
                    f'line kernel launched {counts["gamma"]} times, fewer '
                    f'than {nGroups} groups x {nIter} iterations')
        elif counts['fused'] < nIter or counts['sweep'] != 0:
            raise AssertionError(
                f'fused scheme launched fused {counts["fused"]} and '
                f'sweep {counts["sweep"]} times in {nIter} iterations')


def converge_h6mg(scheme, hprd=False):
    """falc_h6mg (PRD, or hybrid PRD with the outflow ramp) converged on
    the card under ``scheme`` with iterate_ctx_se(prd=True), held against
    its golden run; the launch counts show the path's kernels ran: the
    sweep once per MALI step (default, _pallas) and once per PRD
    sub-iteration (the subset solve, every scheme), the line kernel once
    per group per MALI step, the fused kernel once per MALI step.
    Returns (Context, launch counts)."""
    from lightweaver_tpu_torch import iterate_ctx_se
    from lightweaver_tpu_torch.ops import gamma
    from lightweaver_tpu_torch.problems import h6mg_context
    name = 'hprd' if hprd else 'prd'
    phase(f'falc_h6mg {name.upper()} under {scheme}: converged on the card '
          'vs the golden reference')
    ref = np.load(ROOT / 'tests' / 'golden' / f'falc_h6mg_{name}_ref.npz')
    t0 = time.perf_counter()
    ctx = h6mg_context(hprd=hprd, device='cuda')
    ctx.set_fs_iter_scheme(scheme)
    torch.cuda.synchronize()
    print(f'Context on {ctx.device}: Nlam={ctx.cfg.Nlam} Nmu={ctx.cfg.Nmu} '
          f'Nk={ctx.cfg.Nk}, {len(ctx._prd_lines())} PRD lines, built in '
          f'{time.perf_counter() - t0:.2f} s')

    # count the PRD sub-iterations of the run
    redistribute, subIters = ctx.prd_redistribute, []

    def counted(**kwargs):
        update = redistribute(**kwargs)
        subIters.append(update.NprdSubIter)
        return update
    ctx.prd_redistribute = counted

    reset_counts()
    t0 = time.perf_counter()
    nIter = iterate_ctx_se(ctx, NmaxIter=500, prd=True, quiet=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    del ctx.prd_redistribute
    nSub = sum(subIters)

    errs = {f'pops_a{ia}': relerr(ctx.popsState[ia]['n'].cpu(),
                                  ref[f'out_pops_a{ia}']) for ia in range(2)}
    for key in ('J', 'I'):
        ours, refA = getattr(ctx, key).cpu().numpy(), ref[f'out_{key}']
        if hprd:
            # amplitude-normalised per wavelength, as the golden test
            errs[key] = float((np.abs(ours - refA).max(axis=1)
                               / np.abs(refA).max(axis=1)).max())
        else:
            errs[key] = relerr(ours, refA)
    for ai, ti, _, _ in ctx._prd_lines():
        errs[f'rho_a{ai}t{ti}'] = relerr(ctx.rhoPrd[ai][ti].cpu(),
                                         ref[f'out_rho_a{ai}t{ti}'])
    nIterRef = int(ref['out_niter'][0])
    print(f'converged in {nIter} iterations (reference {nIterRef}); '
          f'{wall:.2f} s, {wall / nIter * 1e3:.3f} ms/iter '
          '(formal_sol_gamma_matrices + stat_equil + prd_redistribute, '
          f'host clock); {nSub} PRD sub-iterations in all')
    print('max relative error vs golden'
          + (' (J, I amplitude-normalised per wavelength)' if hprd else '')
          + ': ' + ', '.join(f'{k} {v:.3e}' for k, v in errs.items()))
    print('kernel launches over the run: '
          + ', '.join(f'{k} {v}' for k, v in counts.items())
          + f' ({nIter} MALI steps, {nSub} subset solves)')
    if abs(nIter - nIterRef) > NITER_REF_SLACK:
        raise AssertionError(f'{nIter} iterations vs reference {nIterRef}')
    bad = {k: v for k, v in errs.items() if not v < GOLDEN_RTOL}
    if bad:
        raise AssertionError(f'golden mismatch above {GOLDEN_RTOL}: {bad}')
    sizes = [len(g) for a in ctx.activeAtoms for g in gamma.line_groups(a)]
    nGroups = len(sizes)
    if scheme == PALLAS:
        print(f'line kernel: {nGroups} groups per MALI step, K = {sizes}')
    expected = {
        'mali_full_precond': dict(sweep=nIter + nSub, gamma=0, fused=0),
        PALLAS: dict(sweep=nIter + nSub, gamma=nGroups * nIter, fused=0),
        FUSED: dict(sweep=nSub, gamma=0, fused=nIter)}[scheme]
    got = {k: counts[k] for k in expected}
    if got != expected or nSub < 1:
        raise AssertionError(f'launches {got}, expected {expected}')
    return ctx, counts


def prd_paths():
    """falc_h6mg PRD under each scheme, then hybrid PRD under the default
    scheme (the kernel schemes refuse it); then the stage breakdown of one
    PRD iteration on the default scheme's converged Context."""
    launches = dict.fromkeys(('sweep', 'gamma', 'fused'), 0)
    runs = [('mali_full_precond', False), (PALLAS, False), (FUSED, False),
            ('mali_full_precond', True)]
    for scheme, hprd in runs:
        ctx, counts = converge_h6mg(scheme, hprd)
        for k in launches:
            launches[k] += counts[k]
        if scheme == 'mali_full_precond' and not hprd:
            breakdownCtx = ctx
    for scheme in (PALLAS, FUSED):
        try:
            ctx.set_fs_iter_scheme(scheme)
        except ValueError as e:
            print(f'  hybrid PRD under {scheme}: ValueError ({e})')
        else:
            raise AssertionError(f'{scheme} accepted hybrid PRD')
    del ctx
    prd_breakdown(breakdownCtx)
    return launches


def prd_breakdown(ctx, reps=5):
    """One PRD iteration on the default scheme, stage by stage (host
    clock, synchronised after each stage, mean of ``reps``): the MALI step
    (formal_sol_gamma_matrices + stat_equil), prd_scatter_rho for every
    PRD line, the host pulls of rho that Ng takes, the subset solve; and
    one whole prd_redistribute call."""
    phase('PRD stage breakdown: falc_h6mg, default scheme')
    nLines = len(ctx._prd_lines())
    stages = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = stages.get(name, 0.0) + (time.perf_counter()
                                                 - t0) / reps
        return out
    for _ in range(reps):
        timed('mali_step', lambda: (ctx.formal_sol_gamma_matrices(),
                                    ctx.stat_equil()))
        rhos = timed('prd_scatter_rho', lambda: [ctx._scatter_rho(li)
                                                 for li in range(nLines)])
        timed('ng_host_pulls', lambda: [r.cpu().numpy() for r in rhos])
        timed('subset_solve', ctx._prd_subset_fs)
        timed('prd_redistribute', ctx.prd_redistribute)
    print(f'stage breakdown (ms, mean of {reps}; {nLines} PRD lines, '
          f'{len(ctx._prdSubIdxs)} subset rows): '
          + ', '.join(f'{k} {v * 1e3:.3f}' for k, v in stages.items()))


def falc500():
    from lightweaver_tpu_torch.problems import falc_interpolated, h6ca_context
    phase('FALC-500: 50 formal_sol_gamma_matrices iterations, best of 3')
    ctx = h6ca_context(falc_interpolated(500), 5, device='cuda')
    cfg = ctx.cfg
    for _ in range(2):
        ctx.formal_sol_gamma_matrices()
    torch.cuda.synchronize()
    nIter, best = 50, np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(nIter):
            u = ctx.formal_sol_gamma_matrices()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    if not (np.isfinite(float(u.dJMax)) and torch.isfinite(ctx.J).all()):
        raise AssertionError('non-finite J on FALC-500')
    gridPoints = cfg.Nlam * cfg.Nmu * 2 * cfg.Nk
    print(f'Nlam={cfg.Nlam} Nmu={cfg.Nmu} Nk={cfg.Nk}: '
          f'{best / nIter * 1e3:.3f} ms/iter, '
          f'{gridPoints * nIter / best:.4e} gridpoint-updates/s '
          '(host clock, synchronised per block)')

    # per-stage breakdown, host clock with a synchronise after each stage
    it = ctx._iter_fn
    params = ctx._params
    stages = {'gather': 0.0, 'formal_solve': 0.0, 'gamma_rates': 0.0}
    reps = 5
    for _ in range(reps):
        t0 = time.perf_counter()
        scaJ = params['bgSca'] * params['J']
        chi, src = it.gather(params, scaJ)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rays = it.formal_solve(params, chi, src)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        it.gamma_rates(params, *rays[:3], src, rays[3])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[k] += dt / reps
    print('stage breakdown (ms, mean of 5): '
          + ', '.join(f'{k} {v * 1e3:.3f}' for k, v in stages.items()))


def falc500_schemes():
    """FALC-500 under each kernel scheme: best of 3 blocks of 20
    iterations and the stage breakdown (host clock, synchronised after
    each stage, mean of 5)."""
    from lightweaver_tpu_torch.problems import falc_interpolated, h6ca_context
    for scheme in (PALLAS, FUSED):
        phase(f'FALC-500 under {scheme}: 20 iterations, best of 3')
        ctx = h6ca_context(falc_interpolated(500), 5, device='cuda')
        ctx.set_fs_iter_scheme(scheme)
        for _ in range(2):
            ctx.formal_sol_gamma_matrices()
        torch.cuda.synchronize()
        nIter, best = 20, np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(nIter):
                u = ctx.formal_sol_gamma_matrices()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        if not (np.isfinite(float(u.dJMax)) and torch.isfinite(ctx.J).all()):
            raise AssertionError(f'non-finite J on FALC-500 ({scheme})')
        cfg = ctx.cfg
        gridPoints = cfg.Nlam * cfg.Nmu * 2 * cfg.Nk
        print(f'{best / nIter * 1e3:.3f} ms/iter, '
              f'{gridPoints * nIter / best:.4e} gridpoint-updates/s '
              '(host clock, synchronised per block)')

        it, params = ctx._iter_fn, ctx._params
        reps = 5
        stages = {}

        def timed(name, fn):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            stages[name] = stages.get(name, 0.0) + (time.perf_counter()
                                                     - t0) / reps
            return out
        for _ in range(reps):
            scaJ = params['bgSca'] * params['J']
            if scheme == PALLAS:
                chi, src = timed('gather', lambda: it.gather(params, scaJ))
                rays = timed('formal_solve',
                             lambda: it.formal_solve(params, chi, src))
                lt = timed('line_kernel_stage', lambda: it.line_kernel_stage(
                    params, *rays[:3], src, params['pack']))
                timed('gamma_rates_rest', lambda: it.gamma_rates(
                    params, rays[0], rays[1], rays[2], src, rays[3], lt))
            else:
                I, Psi, IeffB, mom, srcRowsA = timed(
                    'fused_stage', lambda: it.fused_stage(params, scaJ,
                                                          params['pack']))
                timed('gamma_rates', lambda: it.gamma_rates(
                    params, I, Psi, IeffB, None, mom, None, srcRowsA))
        print('stage breakdown (ms, mean of 5): '
              + ', '.join(f'{k} {v * 1e3:.3f}' for k, v in stages.items()))
        del ctx, it, params
        torch.cuda.empty_cache()


KERNELS = {
    'sweep': ('lightweaver_tpu_torch/csrc/sweep.cu',
              'lightweaver_tpu/ops/pallas_sweep.py:196'),
    'gamma': ('lightweaver_tpu_torch/csrc/gamma.cu',
              'lightweaver_tpu/ops/pallas_gamma.py:152'),
    'fused': ('lightweaver_tpu_torch/csrc/fused.cu',
              'lightweaver_tpu/ops/pallas_fused.py:122'),
    'probe_elementwise': ('lightweaver_tpu_torch/csrc/probe.cu',
                          'scripts/pallas_probe.py:23'),
    'probe_recurrence': ('lightweaver_tpu_torch/csrc/probe.cu',
                         'scripts/pallas_probe.py:47'),
}


def main():
    tStart = time.perf_counter()
    smi = environment()
    build_kernels()
    probes = probe_check()
    kernel_check()
    scheme_kernel_check()
    main_path()
    scheme_paths()
    prdKern = prd_kernel_check()
    launches = prd_paths()
    falc500()
    falc500_schemes()
    # the kernels' record: this slice's path (PRD) and its kernel inputs
    records = {name: dict(prdKern[name], launches=launches[name])
               for name in ('sweep', 'gamma', 'fused')}
    records.update(probes)
    print(f'chip_smoke wall time: {time.perf_counter() - tStart:.1f} s '
          '(kernel builds included)')
    print(smi)
    print(json.dumps({'kernels': [{
        'name': name, 'route': 'cuda', 'source': KERNELS[name][0],
        'replaces': KERNELS[name][1], 'launches': r['launches'],
        'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
        'plain_ms': r['plain_ms']} for name, r in records.items()]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
