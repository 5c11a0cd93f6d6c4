"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero and prints no
result):

1. Environment: torch and CUDA versions, the card's name and power limit.
2. Kernel: build the depth-sweep kernel (csrc/sweep.cu) from source and
   compare it with its plain PyTorch version on the card, in f64, at the
   main path's shapes (Nlam=1046, Nmu=5, Nk=82 and 500), inputs from a
   numpy seed; times of both.
3. Main path: falc_h6ca (FAL-C, H 6-level + Ca II active, 5 rays) on the
   card through Context and iterate_ctx_se, against the compiled
   reference's golden run (tests/golden/falc_h6ca_ref.npz); the sweep
   kernel's launch count over that run.
4. FALC-500 (the same setup interpolated to 500 depths, bench.py's
   problem): 50 formal_sol_gamma_matrices iterations, best of 3, and a
   per-stage breakdown.

The last three lines are the card's name and power limit as nvidia-smi
prints them, the kernels' JSON record and the ok line.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
NITER_REF_SLACK = 2
GOLDEN_RTOL = 1e-7
# nvcc contracts multiply-adds into FMAs, the plain version's separate
# torch ops do not; the difference compounds along the depth chain
KERNEL_TOL = 1e-9


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


def kernel_check():
    from lightweaver_tpu_torch.ops import sweep
    from lightweaver_tpu_torch.problems import random_rays
    phase('sweep kernel: build and compare with the plain version (f64)')
    t0 = time.perf_counter()
    sweep.load_library()
    print(f'built csrc/sweep.cu in {time.perf_counter() - t0:.1f} s; '
          f'nvcc flags: {" ".join(sweep.NVCC_FLAGS)}')
    for line in sweep.build_log.splitlines():
        if 'registers' in line or 'spill' in line or 'error' in line:
            print(f'  ptxas: {line.strip()}')
    names = ('I', 'Psi', 'IeffBase', 'J', 'PsiBar', 'IBar', 'IeffSrcBar')
    result = {}
    for Nk in (82, 500):
        c = {k: torch.tensor(v, dtype=torch.float64, device='cuda')
             for k, v in random_rays(1046, 5, Nk, seed=Nk).items()}
        plain = sweep.formal_solve_sweep_plain(**c)
        kern = sweep.formal_solve_sweep(**c)
        torch.cuda.synchronize()
        outs = {n: (a, b) for n, a, b in zip(
            names, list(kern[:3]) + [kern[3][k] for k in names[3:]],
            list(plain[:3]) + [plain[3][k] for k in names[3:]])}
        worstRel = worstAbs = 0.0
        for n, (a, b) in outs.items():
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                raise AssertionError(f'non-finite {n} at Nk={Nk}')
            absErr = (a - b).abs().max().item()
            rel = absErr / b.abs().max().item()
            worstRel, worstAbs = max(worstRel, rel), max(worstAbs, absErr)
            print(f'  Nk={Nk} {n}: max|kernel-plain|/max|plain| = {rel:.3e}'
                  f'  (max abs {absErr:.3e})')
            if rel > KERNEL_TOL:
                raise AssertionError(f'kernel disagrees on {n} at Nk={Nk}: '
                                     f'{rel:.3e} > {KERNEL_TOL}')
        # turns: plain, kernel, kernel, plain
        p1 = cuda_ms(lambda: sweep.formal_solve_sweep_plain(**c), 3)
        k1 = cuda_ms(lambda: sweep.formal_solve_sweep(**c), 20)
        k2 = cuda_ms(lambda: sweep.formal_solve_sweep(**c), 20)
        p2 = cuda_ms(lambda: sweep.formal_solve_sweep_plain(**c), 3)
        print(f'  Nk={Nk}: kernel {k1:.4f} / {k2:.4f} ms, plain '
              f'{p1:.4f} / {p2:.4f} ms per call (1046 x 5 x 2 rays)')
        result[Nk] = dict(max_abs_err=worstAbs, max_rel_err=worstRel,
                          ms=min(k1, k2), plain_ms=min(p1, p2))
    return result


def main_path():
    from lightweaver_tpu_torch import iterate_ctx_se
    from lightweaver_tpu_torch.fal import Falc82
    from lightweaver_tpu_torch.ops import sweep
    from lightweaver_tpu_torch.problems import h6ca_context
    phase('main path: falc_h6ca on the card vs the golden reference')
    ref = np.load(ROOT / 'tests' / 'golden' / 'falc_h6ca_ref.npz')
    t0 = time.perf_counter()
    ctx = h6ca_context(Falc82(), 5, device='cuda')
    torch.cuda.synchronize()
    print(f'Context on {ctx.device}: Nlam={ctx.cfg.Nlam} Nmu={ctx.cfg.Nmu} '
          f'Nk={ctx.cfg.Nk}, built in {time.perf_counter() - t0:.2f} s')

    sweep.sweep_cuda.launches = 0
    t0 = time.perf_counter()
    nIter = iterate_ctx_se(ctx, NmaxIter=500, quiet=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sweep.sweep_cuda.launches

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
    print(f'sweep kernel launches: {launches} over {nIter} MALI iterations '
          '(one per formal_sol_gamma_matrices call)')
    if abs(nIter - nIterRef) > NITER_REF_SLACK:
        raise AssertionError(f'{nIter} iterations vs reference {nIterRef}')
    bad = {k: v for k, v in errs.items() if not v < GOLDEN_RTOL}
    if bad:
        raise AssertionError(f'golden mismatch above {GOLDEN_RTOL}: {bad}')
    if launches < nIter:
        raise AssertionError(f'sweep kernel launched {launches} times in '
                             f'{nIter} iterations')
    return launches


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


def main():
    smi = environment()
    kern = kernel_check()
    launches = main_path()
    falc500()
    k82 = kern[82]
    print(smi)
    print(json.dumps({'kernels': [{
        'name': 'sweep', 'route': 'cuda',
        'source': 'lightweaver_tpu_torch/csrc/sweep.cu',
        'replaces': 'lightweaver_tpu/ops/pallas_sweep.py:196',
        'launches': launches, 'max_abs_err': k82['max_abs_err'],
        'ms': k82['ms'], 'plain_ms': k82['plain_ms']}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
