"""Device time per call of the line Gamma, depth-sweep and fused kernels,
read from torch.profiler (the sum of the kernels' CUDA durations, not events
around Python loops), on the shapes of lightweaver_tpu_torch's main path.

    python3 scripts/torch_kernel_times.py [--root TREE] [--reps N]

``--root`` names the tree whose lightweaver_tpu_torch and chip_smoke.py
are imported (default: this checkout), so that two trees can be timed in
one call on one card: unpack the other tree with ``git archive`` into a
directory that .gitignore lists and run parent, change, change, parent.

Rows, each in float64 and float32:

- line Gamma: the whole line_kernel_stage of one MALI step of falc_h6ca
  (13 line groups), falc_h6mg after three MALI steps and one
  prd_redistribute (rho != 1, Mg II's K = 4 group) and FALC-500; the
  kernel's device time and launches per call, and the stage's host time
  (synchronised, mean over ``--reps`` calls);
- fused: fused_lambda_step on the fused scheme's inputs of the same MALI
  steps (C = 2 slots on falc_h6ca and FALC-500, C = 3 with rho != 1 on
  falc_h6mg), device time and launches per call and the call's host time;
- sweep: formal_solve_sweep on 1046 x 5 x 2 random rays at Nk = 82 and
  500 (problems.random_rays) and on falc_h6mg's 416-row PRD subset.

The last line is one JSON object with every row.  Needs a CUDA device.
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

PALLAS = 'mali_full_precond_pallas'
FUSED = 'mali_full_precond_fused'
# substrings of the kernels' symbol names
GAMMA_KERNEL = 'gamma_kernel'
SWEEP_KERNEL = 'sweep_kernel'
FUSED_KERNEL = 'fused_kernel'


def device_ms(cs, name, fn, pattern, reps):
    """(device ms per call of the kernels whose name holds ``pattern``,
    their launches per call, host ms per call synchronised).  The launches
    per call come from chip_smoke's counter ``name`` of the tree; the
    device time is the mean over the complete calls whose launches the
    profiler recorded (it can drop the last device records of a short
    window), in launch order; a session with no complete call runs again
    with twice the calls, up to four times."""
    fn()
    torch.cuda.synchronize()
    cs.reset_counts()
    fn()
    torch.cuda.synchronize()
    perCall = cs.read_counts()[name]
    calls = reps
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ks = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and pattern in e.name),
                    key=lambda e: e.time_range.start)
        complete = len(ks) // perCall
        if complete:
            break
        calls *= 2
    else:
        raise RuntimeError(f'the profiler recorded no complete call of '
                           f'{pattern}')
    us = sum(e.time_range.elapsed_us() for e in ks[:complete * perCall])
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / reps * 1e3
    return us / complete / 1e3, perCall, host


def line_rows(cs, dtype, reps):
    """The line kernel stage and the fused kernel of one MALI step on the
    three problems."""
    from lightweaver_tpu_torch.context import build_iteration_fn
    from lightweaver_tpu_torch.fal import Falc82
    from lightweaver_tpu_torch.ops import fused
    from lightweaver_tpu_torch.problems import falc_interpolated, h6ca_context
    rows = []
    f32 = '_f32' if dtype == torch.float32 else ''

    def stage(label, ctx, params, src, rays, scaJ):
        it = build_iteration_fn(dataclasses.replace(ctx.cfg,
                                                    fsIterScheme=PALLAS))
        pack = it.pack(params)
        ms, n, host = device_ms(
            cs, 'gamma' + f32,
            lambda: it.line_kernel_stage(params, *rays[:3], src, pack),
            GAMMA_KERNEL, reps)
        rows.append(dict(kernel='line_gamma', problem=label,
                         dtype=str(dtype), device_ms=ms, launches=n,
                         stage_host_ms=host))
        itF = build_iteration_fn(dataclasses.replace(ctx.cfg,
                                                     fsIterScheme=FUSED))
        args = itF.fused_inputs(params, scaJ, itF.pack(params))
        ms, n, host = device_ms(cs, 'fused' + f32,
                                lambda: fused.fused_lambda_step(*args),
                                FUSED_KERNEL, reps)
        rows.append(dict(kernel='fused', problem=f'{label}, C = '
                         f'{args[0].shape[0]}', dtype=str(dtype),
                         device_ms=ms, launches=n, call_host_ms=host))
    for label, atmos in (('falc_h6ca', Falc82), ('FALC-500',
                                                  lambda: falc_interpolated(
                                                      500))):
        ctx = h6ca_context(atmos(), 5, device='cuda', dtype=dtype)
        ctx.formal_sol_gamma_matrices()
        ctx.stat_equil()
        params = ctx.build_params()
        it = ctx._iter_fn
        scaJ = it.scaJ(params)
        chi, src = it.gather(params, scaJ)
        stage(label, ctx, params, src, it.formal_solve(params, chi, src),
              scaJ)
        del ctx, params, chi, src
    ctx, params, scaJ, src, rays = cs.prd_state(dtype)
    stage('falc_h6mg PRD', ctx, params, src, rays, scaJ)
    return rows, (ctx, params)


def sweep_rows(cs, prd, dtype, reps):
    from lightweaver_tpu_torch.context import build_prd_subset_fn
    from lightweaver_tpu_torch.ops import sweep
    from lightweaver_tpu_torch.problems import random_rays
    rows = []
    cases = []
    for Nk in (82, 500):
        r = random_rays(1046, 5, Nk, seed=Nk)
        cases.append((f'random rays 1046x5, Nk={Nk}', [
            torch.tensor(r[k], dtype=dtype, device='cuda') for k in
            ('chi', 'srcNum', 'height', 'muz', 'IupwD', 'IupwU', 'wmu')]))
    ctx, params = prd
    sub = ctx._prd_subset_idxs()
    lines = [(ai, ti) for ai, ti, _, _ in ctx._prd_lines()]
    cases.append((f'falc_h6mg PRD subset, {len(sub)} rows',
                  build_prd_subset_fn(ctx.cfg, sub, lines)
                  .sweep_inputs(params)))
    for label, args in cases:
        ms, n, host = device_ms(
            cs, 'sweep_f32' if dtype == torch.float32 else 'sweep',
            lambda: sweep.formal_solve_sweep(*args), SWEEP_KERNEL, reps)
        rows.append(dict(kernel='sweep', problem=label, dtype=str(dtype),
                         device_ms=ms, launches=n, call_host_ms=host))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument('--reps', type=int, default=20)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('no CUDA device')
    root = Path(opts.root).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f'tree {root}; card {smi}; torch {torch.__version__}', flush=True)
    rows = []
    for dtype in (torch.float64, torch.float32):
        lr, prd = line_rows(cs, dtype, opts.reps)
        rows += lr + sweep_rows(cs, prd, dtype, opts.reps)
        del prd
        torch.cuda.empty_cache()
    for r in rows:
        extra = (f'stage host {r["stage_host_ms"]:.3f} ms'
                 if 'stage_host_ms' in r else
                 f'call host {r["call_host_ms"]:.3f} ms')
        print(f'{r["kernel"]:10s} {r["dtype"]:13s} {r["problem"]:36s} '
              f'device {r["device_ms"]:.4f} ms/call, {r["launches"]:.0f} '
              f'launches/call, {extra}')
    print(json.dumps({'tree': str(root), 'card': smi, 'rows': rows}))


if __name__ == '__main__':
    main()
