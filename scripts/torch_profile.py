"""Device profile of lightweaver_tpu_torch's MALI iteration on one GPU.

    python3 scripts/torch_profile.py

For falc_h6ca (formal_sol_gamma_matrices + stat_equil, as the
convergence loop runs them) and FALC-500 (formal_sol_gamma_matrices, as
bench.py times them), after two warm-up iterations, five iterations run
under torch.profiler.  Per iteration it prints the host wall time, the
number of CUDA kernels launched, the device busy time (sum of kernel
durations) and the idle share 1 - busy/wall; then the kernels with the
most device time.  Needs a CUDA device; the profiler's own overhead
inflates the wall time, so take ms/iter from chip_smoke.py.
"""
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lightweaver_tpu_torch.fal import Falc82  # noqa: E402
from lightweaver_tpu_torch.problems import (falc_interpolated,  # noqa: E402
                                            h6ca_context)

ITERS = 5


def profile_problem(name, ctx, step, iters=ITERS):
    """Profile ``iters`` calls of step(ctx) after two warm-up calls (a step
    of tens of thousands of kernels takes fewer: the profiler's records
    cost host time); print the
    per-iteration numbers and the top kernels, and return {'wall_ms',
    'kernels', 'busy_ms', 'idle'} per iteration."""
    for _ in range(2):
        step(ctx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step(ctx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError('the profiler recorded no device events')
    byName = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        byName[e.name][0] += 1
        byName[e.name][1] += e.time_range.elapsed_us()
    busyUs = sum(v[1] for v in byName.values())
    wallUs = wall * 1e6
    print(f'== {name}: Nlam={ctx.cfg.Nlam} Nmu={ctx.cfg.Nmu} Nk={ctx.cfg.Nk}')
    print(f'per iteration: wall {wallUs / iters / 1e3:.3f} ms (profiled), '
          f'{len(kernels) / iters:.0f} kernels, device busy '
          f'{busyUs / iters / 1e3:.3f} ms, idle share '
          f'{1.0 - busyUs / wallUs:.3f}')
    top = sorted(byName.items(), key=lambda kv: -kv[1][1])[:8]
    for kname, (count, us) in top:
        print(f'  {us / iters / 1e3:8.3f} ms/iter  {count / iters:7.1f} '
              f'launches/iter  {kname[:90]}')
    return {'wall_ms': wallUs / iters / 1e3, 'kernels': len(kernels) / iters,
            'busy_ms': busyUs / iters / 1e3, 'idle': 1.0 - busyUs / wallUs}


def main():
    if not torch.cuda.is_available():
        sys.exit('no CUDA device')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f'card: {smi}; torch {torch.__version__}')

    def mali(ctx):
        ctx.formal_sol_gamma_matrices()
        ctx.stat_equil()
    profile_problem('falc_h6ca, formal_sol_gamma_matrices + stat_equil',
                    h6ca_context(Falc82(), 5, device='cuda'), mali)
    profile_problem('FALC-500, formal_sol_gamma_matrices',
                    h6ca_context(falc_interpolated(500), 5, device='cuda'),
                    lambda ctx: ctx.formal_sol_gamma_matrices())


if __name__ == '__main__':
    main()
