"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero and prints no
result):

1. Environment: torch and CUDA versions, the card's name and power limit;
   then the four kernel libraries are built from csrc/ at once, one nvcc
   each, with ptxas's registers and spills per instance (the float64 line
   Gamma kernel, whose K = 4 path is the widest, must not spill; the
   sweep and fused instances' registers and spills printed), and the
   float64 instructions of each float32 instance in its SASS (cuobjdump):
   J's double accumulator only.
2. Probes: the two toolchain probes (csrc/probe.cu) against their plain
   versions (2x + 1 exactly, the recurrence within 1e-6 in f32).
3. Sweep kernel: csrc/sweep.cu against its plain PyTorch version on the
   card, in f64, at the main path's shapes (Nlam=1046, Nmu=5, Nk=82 and
   500) and at 17 and 32 rays per direction (Nk=500), inputs from a numpy
   seed; times of both.
4. Scheme kernels: the line Gamma kernel (csrc/gamma.cu, one launch for
   every line group) and the fused lambda step (csrc/fused.cu) against
   their plain versions on the inputs of one iteration of falc_h6ca and of
   FALC-500; times, and the whole line_kernel_stage's host time.  Then the
   fused kernel on random slots at 17 rays per direction with each
   boundary kind at each end, and the line Gamma kernel on a random group
   of K = 6 lines.
5. Main path: falc_h6ca (FAL-C, H 6-level + Ca II active, 5 rays) on the
   card through Context and iterate_ctx_se, against the compiled
   reference's golden run (tests/golden/falc_h6ca_ref.npz); the sweep
   kernel's launch count over that run.
6. The same under each iteration scheme, 'mali_full_precond_pallas' and
   'mali_full_precond_fused', with the launch counts of their kernels.
   Then a callable upper boundary whose data grow 100x between two MALI
   steps of the mixed-precision problem (f64), under the default and
   fused schemes, on the card against the CPU.
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
9. The float32 state (dtype=torch.float32, J/Gamma/rates in float64):
   (a) the float32 instances against their plain versions, every output
   held to err(kernel f32, plain f64) <= 2 err(plain f32, plain f64) +
   1e-6 with plain f64 on the same inputs, and J to the float64 sum of
   the kernel's own float32 products (1e-13): the sweep on random rays at
   phase 3's shapes and on one falc_h6ca float32 iteration, fused on
   phase 4's random slots, line Gamma on the K = 6 group, falc_h6ca's 13
   groups, falc_h6mg's (K = 4, rho != 1) and FALC-500's, fused with C = 2
   (falc_h6ca, FALC-500) and C = 3 (falc_h6mg); float32 and float64
   instance times side by side.  (b) The mixed-precision problem (FAL-C decimated
   to 40 depths, 3 rays, Ca II active) converged under each scheme in
   fewer than 600 iterations.  (c) falc_h6ca at full width under each
   scheme, 300 iterations (the float32 state does not converge there, in
   the JAX package either; the f64 state converges in 211): the last dJ
   and dPops, the emergent spectrum
   against the golden file (rows brighter than 1e-3 of the peak within
   6.5e-2, median within 5e-3), the populations' largest error, and the
   float32 instances' launches.
10. FALC-500 (the same setup as falc_h6ca interpolated to 500 depths,
   bench.py's problem) under each scheme, float64 then float32: best of 3
   blocks of formal_sol_gamma_matrices iterations (50 for the default
   scheme, 20 for the others) and a per-stage breakdown.

Kernel times are device times from torch.profiler (the mean CUDA
duration of the kernel's launches, one per call, kernel_device_ms); the
plain versions' are CUDA events around their calls.  The kernels' JSON record holds phase
7's errors and times and phase 8's launch counts for the float64
instances (the PRD path), phase 9 (a)'s falc_h6ca errors and times and
(c)'s launch counts for the float32 ones, and the probes'; each with the
least time the card could take for its inputs (bound_ms) and, where one
PyTorch call computes the same function, that call's time.  The last three lines are the card's name and power
limit as nvidia-smi prints them, the kernels' JSON record and the ok
line.
"""
import dataclasses
import json
import re
import shutil
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
    """Mean time of ``fn`` over ``reps`` calls between two CUDA events
    (the plain versions' many kernels and the host gaps between them)."""
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


def kernel_device_ms(fn, pattern, reps=20, rounds=2):
    """Device time per launch of ``fn``'s kernel whose symbol holds
    ``pattern`` (one launch per call of ``fn``): torch.profiler's CUDA
    durations of that kernel over ``rounds`` x ``reps`` calls in one
    session after a warm-up call, averaged over each of ``rounds``
    consecutive runs of the launches it recorded.  The profiler can drop
    the last device records of a short window, so the mean is over the
    launches recorded, and a session that records fewer than ``rounds``
    runs again with twice the calls, up to four times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    calls = rounds * reps
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
        if len(ks) >= rounds:
            n = len(ks) // rounds
            return [sum(e.time_range.elapsed_us() for e in ks[i * n:(i + 1) * n])
                    / n / 1e3 for i in range(rounds)]
        print(f'  (the profiler recorded {len(ks)} of {calls} {pattern} '
              'launches; again with twice the calls)')
        calls *= 2
    raise AssertionError(f'the profiler recorded no {pattern} kernel')


# kernel symbols, as the profiler names them
SYMBOLS = {'sweep': 'sweep_kernel', 'gamma': 'line_gamma_kernel',
           'fused': 'fused_kernel'}


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
    """Kernel name -> (wrapper, its launch-count attribute): the float64
    and float32 instances of a wrapper keep separate counts."""
    from lightweaver_tpu_torch.ops import fused, gamma, probe, sweep
    return {'sweep': (sweep.sweep_cuda, 'launches'),
            'gamma': (gamma.line_gamma_rates_cuda, 'launches'),
            'fused': (fused.fused_cuda, 'launches'),
            'sweep_f32': (sweep.sweep_cuda, 'launches_f32'),
            'gamma_f32': (gamma.line_gamma_rates_cuda, 'launches_f32'),
            'fused_f32': (fused.fused_cuda, 'launches_f32'),
            'probe_elementwise': (probe.elementwise_cuda, 'launches'),
            'probe_recurrence': (probe.recurrence_cuda, 'launches')}


def reset_counts():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


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
    spills = ptxas_spills(_build.build_log('gamma'))
    f64 = {fn: v for fn, v in spills.items() if 'IdE' in fn}
    print(f'  line Gamma float64 instance: spill stores / loads (bytes) '
          f'{list(f64.values())}')
    if len(f64) != 1 or any(v != (0, 0) for v in f64.values()):
        raise AssertionError(f'the float64 line Gamma kernel spills: {f64}')
    for name in ('sweep', 'fused'):
        log = _build.build_log(name)
        regs, spills = ptxas_registers(log), ptxas_spills(log)
        for fn in sorted(regs):
            kind = 'float64' if 'IdE' in fn else 'float32'
            print(f'  {name} {kind} instance: {regs[fn]} registers, spill '
                  f'stores / loads {spills.get(fn, (0, 0))} bytes')
    sass_double_ops({n: mods[n] for n in ('sweep', 'gamma', 'fused')})


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_SPILL = re.compile(r'(\d+) bytes spill stores, (\d+) bytes spill loads')
_PTXAS_REGS = re.compile(r'Used (\d+) registers')


def ptxas_registers(log):
    """{kernel symbol: registers per thread} from ptxas -v's output."""
    out, fn = {}, None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            fn = m.group(1)
            continue
        m = _PTXAS_REGS.search(line)
        if m and fn is not None:
            out[fn] = int(m.group(1))
    return out


def ptxas_spills(log):
    """{kernel symbol: (spill store bytes, spill load bytes)} from
    ptxas -v's output."""
    out, fn = {}, None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            fn = m.group(1)
            continue
        m = _PTXAS_SPILL.search(line)
        if m and fn is not None:
            out[fn] = (int(m.group(1)), int(m.group(2)))
    return out


# float64 instructions a float32 instance may hold: J's double accumulator
# (DADD) and the conversions of its float products (F2F.F64.F32) in the
# sweep and fused kernels; none in the line Gamma kernel
F32_DOUBLE_OPS = {'sweep': {'DADD', 'F2F.F64.F32'}, 'gamma': set(),
                  'fused': {'DADD', 'F2F.F64.F32'}}
_SASS_FN = re.compile(r'Function : (\S+)')
_SASS_OP = re.compile(r'\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)')


def sass_double_ops(mods):
    """The float64 instructions in each float32 instance's SASS
    (cuobjdump -sass): fails on any outside F32_DOUBLE_OPS, so that no
    float ray step or partial is computed in float64."""
    from lightweaver_tpu_torch.ops import _build
    cuobjdump = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    for name in mods:
        sass = subprocess.run([cuobjdump, '-sass', _build.library_path(name)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        fn, ops = None, {}
        for line in sass.splitlines():
            m = _SASS_FN.search(line)
            if m:
                fn = m.group(1)
                ops[fn] = {}
                continue
            m = _SASS_OP.search(line)
            if fn is None or not m:
                continue
            op = m.group(1)
            if ((op.startswith('D') and not op.startswith('DEPBAR'))
                    or 'F64' in op or '64H' in op):
                ops[fn][op] = ops[fn].get(op, 0) + 1
        # mangled template arguments: IfE / IfLi<K> float, IdE / IdLi double
        f32 = {fn: c for fn, c in ops.items() if re.search(r'IfE|IfLi', fn)}
        if len(f32) != 1:
            raise AssertionError(f'{name}: float32 instances not found in the '
                                 f'SASS ({sorted(ops)})')
        for fn, c in sorted(f32.items()):
            print(f'  {name} float32 instance {fn[-40:]}: float64 '
                  f'instructions {c or "none"}')
            bad = set(c) - F32_DOUBLE_OPS[name]
            if bad:
                raise AssertionError(f'{name}: float64 instructions {bad} in '
                                     f'the float32 instance {fn}')


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
    # the one PyTorch call computing 2x + 1: ones + 2 x; the recurrence
    # has none
    ones = torch.ones_like(x)
    library = {'probe_elementwise': lambda: torch.add(ones, x, alpha=2.0),
               'probe_recurrence': None}
    # 2 operations per element; bytes: x in, o out / a, b in, o out
    bounds = {'probe_elementwise': bound(2 * nbytes([x]), 2 * x.numel(),
                                         torch.float32),
              'probe_recurrence': bound(3 * nbytes([a2]), 2 * a2.numel(),
                                        torch.float32)}
    for name, kern, plain in (
            ('probe_elementwise', lambda: probe.elementwise(x),
             lambda: probe.elementwise_plain(x)),
            ('probe_recurrence', lambda: probe.recurrence(a2, b2),
             lambda: probe.recurrence_plain(a2, b2))):
        p1, k1, k2, p2 = (cuda_ms(f, 20) for f in (plain, kern, kern, plain))
        libMs = None if library[name] is None else cuda_ms(library[name], 20)
        print(f'  {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / '
              f'{p2:.4f} ms, one PyTorch call '
              f'{"none" if libMs is None else f"{libMs:.4f} ms"} per call; '
              f'launches in the probe run {counts[name]}')
        if counts[name] < 1:
            raise AssertionError(f'{name} kernel did not launch')
        result[name] = dict(launches=counts[name], max_abs_err=absErr[name],
                            ms=min(k1, k2), plain_ms=min(p1, p2),
                            library_ms=libMs, **bounds[name])
    return result


def kernel_check():
    """The sweep kernel against its plain version on random rays at the
    main path's shapes; times."""
    from lightweaver_tpu_torch.ops import sweep
    from lightweaver_tpu_torch.problems import random_rays
    phase('sweep kernel: compare with the plain version (f64)')
    for Nmu, Nk in SWEEP_SHAPES:
        c = {k: torch.tensor(v, dtype=torch.float64, device='cuda')
             for k, v in random_rays(1046, Nmu, Nk, seed=Nk).items()}
        plain = sweep.formal_solve_sweep_plain(**c)
        kern = sweep.formal_solve_sweep(**c)
        torch.cuda.synchronize()
        label = f'Nmu={Nmu} Nk={Nk} sweep'
        rel, absErr = compare_outputs(label, RAY_NAMES, ray_outputs(kern),
                                      ray_outputs(plain), KERNEL_TOL)
        print(f'  {label}: max|kernel-plain|/max|plain| = {rel:.3e} '
              f'(bar {KERNEL_TOL}), max abs {absErr:.3e}')
        timed_pair(f'{label}, per call (1046 x {Nmu} x 2 rays, '
                   f'{sweep.rays_per_pass(Nmu)} warps a block)',
                   lambda: sweep.formal_solve_sweep(**c),
                   lambda: sweep.formal_solve_sweep_plain(**c),
                   SYMBOLS['sweep'], bnd=sweep_bound(list(c.values()), kern))
        del c, plain, kern


# (Nmu, Nk) of the random rays of the sweep checks: the main path's 5 rays
# at Nk = 82 and 500, and 17 and 32 rays per direction (two passes of 17
# warps, one of 32) at Nk = 500
SWEEP_SHAPES = ((5, 82), (5, 500), (17, 500), (32, 500))


def one_iteration_inputs(Nk, dtype=None):
    """The Context of falc_h6ca (Nk=82) or FALC-500 on the card after one
    MALI step, its params, scaJ, srcNum and this iteration's rays (default
    scheme)."""
    from lightweaver_tpu_torch.fal import Falc82
    from lightweaver_tpu_torch.problems import falc_interpolated, h6ca_context
    atmos = Falc82() if Nk == 82 else falc_interpolated(Nk)
    ctx = h6ca_context(atmos, 5, device='cuda', dtype=dtype)
    ctx.formal_sol_gamma_matrices()
    ctx.stat_equil()
    params = ctx.build_params()
    it = ctx._iter_fn
    scaJ = it.scaJ(params)
    chi, src = it.gather(params, scaJ)
    rays = it.formal_solve(params, chi, src)
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


def bound_text(bnd):
    return ('' if bnd is None else f'; bound {bnd["bound_ms"]:.4g} ms by '
            f'{bnd["bound_by"]}')


def timed_pair(label, kern, plain, symbol, reps=20, bnd=None):
    """Kernel and plain version in turns (plain, kernel, plain): the
    kernel's device time (kernel_device_ms of ``symbol``, two rounds), the
    plain version's events; the min of each pair."""
    p1 = cuda_ms(plain, 3)
    k1, k2 = kernel_device_ms(kern, symbol, reps)
    p2 = cuda_ms(plain, 3)
    print(f'  {label}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / '
          f'{p2:.4f} ms{bound_text(bnd)}')
    return min(k1, k2), min(p1, p2)


def line_call(ctx, params, src, rays):
    """The scheme's iteration function and the arguments of
    ops/gamma.py:line_gamma_rates for one iteration of ``ctx``."""
    from lightweaver_tpu_torch.context import build_iteration_fn
    itP = build_iteration_fn(dataclasses.replace(ctx.cfg,
                                                 fsIterScheme=PALLAS))
    return itP, itP.line_inputs(params, *rays[:3], src, itP.pack(params))


def stage_host_ms(itP, params, src, rays, table, reps=10):
    """The whole line_kernel_stage (host clock, synchronised, mean)."""
    def stage():
        return itP.line_kernel_stage(params, *rays[:3], src, table)
    stage()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        stage()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def check_line_kernel(label, ctx, params, src, rays):
    """The line Gamma kernel, one launch for every line group of one
    iteration, against its plain version group by group; the launch's
    device time and the whole line_kernel_stage's host time."""
    from lightweaver_tpu_torch.ops import gamma
    itP, args = line_call(ctx, params, src, rays)
    table = args[0]
    kern = table.views(*gamma.line_gamma_rates(*args))
    plain = table.views(*gamma.line_gamma_rates_plain(*args))
    torch.cuda.synchronize()
    worst = [0.0, 0.0]
    for gi, (g, k3, p3) in enumerate(zip(table.groups, kern, plain)):
        rel, absErr = compare_outputs(
            f'{label} atom {g.ai} group {list(g.members)}',
            ('G4', 'PPB', 'PairPPB'), k3, p3, GAMMA_TOL)
        worst = [max(worst[0], rel), max(worst[1], absErr)]
        rhoDev = (table.inputs(gi, args[1])[1] - 1.0).abs().max().item()
        if rhoDev > 0.0 or g.K > 3:
            print(f'  {label} atom {g.ai} group {list(g.members)} (K = '
                  f'{g.K}, max|rho-1| = {rhoDev:.3e}): '
                  f'max|kernel-plain|/max|plain| = {rel:.3e}')
    print(f'  {label} line Gamma, {len(table.groups)} groups in one launch '
          f'({table.nItems} blocks): max|kernel-plain|/max|plain| = '
          f'{worst[0]:.3e} (bar {GAMMA_TOL}), max abs {worst[1]:.3e}')
    bnd = gamma_bound(args)
    ms, plainMs = timed_pair(
        f'{label} line Gamma, all groups of one iteration',
        lambda: gamma.line_gamma_rates(*args),
        lambda: gamma.line_gamma_rates_plain(*args), SYMBOLS['gamma'],
        bnd=bnd)
    print(f'  {label} line_kernel_stage (the launch and its glue): '
          f'{stage_host_ms(itP, params, src, rays, table):.3f} ms host')
    return dict(max_abs_err=worst[1], max_rel_err=worst[0], ms=ms,
                plain_ms=plainMs, K=table.maxK, **bnd)


def fused_args(ctx, params, scaJ):
    """The arguments of ops/fused.py:fused_lambda_step for one iteration
    of ``ctx`` under the fused scheme."""
    from lightweaver_tpu_torch.context import build_iteration_fn
    itF = build_iteration_fn(dataclasses.replace(ctx.cfg, fsIterScheme=FUSED))
    return itF.fused_inputs(params, scaJ, itF.pack(params))


def random_fused_args(dtype, bcs, C=2, NL=1046, Nmu=17, Nk=82, seed=17):
    """Random slot-packed lines (problems.random_slots) with the boundary
    kinds ``bcs`` (upper, lower), as fused_lambda_step's arguments."""
    from lightweaver_tpu_torch.problems import random_boundaries, random_slots
    s = random_slots(C, NL, Nmu, Nk, seed)
    rows = random_boundaries(NL, Nmu, seed)

    def t_(x):
        return torch.tensor(x, dtype=dtype, device='cuda')
    return [t_(s[k]) for k in ('phiP', 'chiCo', 'etaCo', 'bgChi', 'bgEta',
                               'scaJ', 'height', 'muz', 'wmu')] + [
        (kind, None if kind == 'zero' else t_(rows[kind])) for kind in bcs]


# boundary kinds (upper, lower) of the random fused checks: each kind at
# each end
FUSED_BCS = (('zero', 'therm'), ('therm', 'data'), ('data', 'zero'))


def random_fused_check():
    """The fused kernel at 17 rays per direction (two passes of 17 warps),
    C = 2 random slots, each boundary kind at each end (f64)."""
    for bcs in FUSED_BCS:
        check_fused_args(f'random slots Nmu=17, BCs {bcs[0]}/{bcs[1]}',
                         random_fused_args(torch.float64, bcs))


def check_fused_args(label, args):
    """The fused kernel on ``args`` against its plain version; its time."""
    from lightweaver_tpu_torch.ops import fused
    plain = fused.fused_lambda_step_plain(*args)
    kern = fused.fused_lambda_step(*args)
    torch.cuda.synchronize()
    rel, absErr = compare_outputs(f'fused {label}', RAY_NAMES,
                                  ray_outputs(kern), ray_outputs(plain),
                                  KERNEL_TOL)
    C = args[0].shape[0]
    print(f'  {label} fused (C={C} slots): max|kernel-plain|/max|plain| = '
          f'{rel:.3e} (bar {KERNEL_TOL}), max abs {absErr:.3e}')
    bnd = fused_bound(args, kern)
    ms, plainMs = timed_pair(f'{label} fused, per call',
                             lambda: fused.fused_lambda_step(*args),
                             lambda: fused.fused_lambda_step_plain(*args),
                             SYMBOLS['fused'], bnd=bnd)
    return dict(max_abs_err=absErr, max_rel_err=rel, ms=ms, plain_ms=plainMs,
                C=C, **bnd)


def scheme_kernel_check():
    """The line Gamma kernel on every line group and the fused kernel, on
    the inputs of one iteration at Nk=82 and 500, against their plain
    versions; per-iteration times (all groups for the line kernel)."""
    phase('scheme kernels: line Gamma (csrc/gamma.cu) and fused lambda '
          'step (csrc/fused.cu) vs their plain versions (f64)')
    for Nk in (82, 500):
        ctx, params, scaJ, src, rays = one_iteration_inputs(Nk)
        check_line_kernel(f'Nk={Nk}', ctx, params, src, rays)
        check_fused_args(f'Nk={Nk}', fused_args(ctx, params, scaJ))
        del ctx, params, rays
        torch.cuda.empty_cache()
    random_fused_check()
    check_group_of_six(torch.float64)


def group_of_six_args(dtype):
    """A random group of K = 6 overlapping lines (past the kernel's
    templated sizes) on 300 of 1046 rows, 5 rays, Nk = 82, rho != 1, as
    ops/gamma.py:group_gamma_rates' arguments."""
    from lightweaver_tpu_torch.ops import gamma
    from lightweaver_tpu_torch.problems import random_line_group
    g = random_line_group(6, 1046, 5, 82, row0=100, Wu=300, seed=6)
    st = gamma.group_statics([type('T', (), {'i': i, 'j': j})
                              for i, j in g.pop('levels')])
    row0 = g.pop('row0')
    return [torch.tensor(g[k], dtype=dtype, device='cuda') for k in (
        'phi', 'rho', 'Psi', 'IeffBase', 'I', 'srcNum', 'chiCL', 'UCL',
        'etaC', 'n', 'coef', 'wphi', 'wmuHalf')] + [st, row0]


def check_group_of_six(dtype):
    """The line Gamma kernel on a random K = 6 group against its plain
    version: GAMMA_TOL in float64, the float32 rule in float32; times
    beside the bound of the one-group table the wrapper launches."""
    from lightweaver_tpu_torch.ops import gamma
    args = group_of_six_args(dtype)
    kern = gamma.group_gamma_rates(*args)
    plain = gamma.group_gamma_rates_plain(*args)
    torch.cuda.synchronize()
    (phi, rho, Psi, IeffB, I, src, chiCL, UCL, etaC, n, coef, wphi, wmuHalf,
     st, row0) = args
    table = gamma.LineTable([{'ai': 0, 'members': tuple(range(6)),
                              'row0': row0, 'phi': phi, 'coef': coef,
                              'wphi': wphi, 'statics': st}],
                            [n.shape[0]], phi.shape[3], phi.shape[4])
    bnd = gamma_bound([table, rho.reshape(-1), Psi, IeffB, I, src, chiCL,
                       UCL, etaC[None], n, wmuHalf])
    names = ('G4', 'PPB', 'PairPPB')
    if dtype == torch.float64:
        rel, absErr = compare_outputs('K = 6 group', names, kern, plain,
                                      GAMMA_TOL)
        print(f'  random K = 6 group (15 pairs) line Gamma: '
              f'max|kernel-plain|/max|plain| = {rel:.3e} (bar {GAMMA_TOL}), '
              f'max abs {absErr:.3e}')
        timed_pair('random K = 6 group line Gamma, per call',
                   lambda: gamma.group_gamma_rates(*args),
                   lambda: gamma.group_gamma_rates_plain(*args),
                   SYMBOLS['gamma'], bnd=bnd)
        return
    args64 = upcast(args)
    f32_rule('random K = 6 group line Gamma', names, kern, plain,
             gamma.group_gamma_rates_plain(*args64))
    timed_instances('random K = 6 group line Gamma, per call',
                    lambda: gamma.group_gamma_rates(*args),
                    lambda: gamma.group_gamma_rates_plain(*args),
                    lambda: gamma.group_gamma_rates(*args64), bnd,
                    SYMBOLS['gamma'])


def prd_kernel_check():
    """The three kernels on the inputs of one iteration of falc_h6mg after
    three MALI steps and one prd_redistribute (rho != 1): the line Gamma
    kernel on every group (Mg II's four-line group among them), the fused
    kernel with C = 3 rho-scaled slots, and the sweep on the PRD subset
    rows, each against its plain version; times."""
    from lightweaver_tpu_torch.context import build_prd_subset_fn
    from lightweaver_tpu_torch.ops import sweep
    phase('PRD kernel inputs: falc_h6mg after 3 MALI steps and one '
          'prd_redistribute (f64, rho != 1)')
    ctx, params, scaJ, src, rays = prd_state(torch.float64)
    result = {'gamma': check_line_kernel('PRD', ctx, params, src, rays),
              'fused': check_fused_args('PRD', fused_args(ctx, params, scaJ))}
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
    bnd = sweep_bound(args, kern)
    ms, plainMs = timed_pair('PRD subset sweep, per call',
                             lambda: sweep.formal_solve_sweep(*args),
                             lambda: sweep.formal_solve_sweep_plain(*args),
                             SYMBOLS['sweep'], bnd=bnd)
    result['sweep'] = dict(max_abs_err=absErr, max_rel_err=rel, ms=ms,
                           plain_ms=plainMs, **bnd)
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
    scheme's kernel ran: the line kernel once per iteration for all its
    groups, the fused kernel once per iteration and the sweep never."""
    for scheme in (PALLAS, FUSED):
        phase(f'scheme {scheme}: falc_h6ca on the card vs the golden '
              'reference')
        ctx, nIter, counts = converge_falc_h6ca(scheme)
        if scheme == PALLAS:
            if counts['gamma'] != nIter:
                raise AssertionError(
                    f'line kernel launched {counts["gamma"]} times in '
                    f'{nIter} iterations, not once per iteration')
        elif counts['fused'] < nIter or counts['sweep'] != 0:
            raise AssertionError(
                f'fused scheme launched fused {counts["fused"]} and '
                f'sweep {counts["sweep"]} times in {nIter} iterations')


# a callable BC's J and I on the card against the CPU: the slice tests'
# 1e-9 of each wavelength's maximum over depth (J) or angle (I)
BC_TOL = 1e-9


def callable_bc_check():
    """Two MALI steps of the mixed-precision problem (40 depths, 3 rays,
    Ca II active) in float64 with a callable upper boundary whose data
    (scale x B_nu(5000 K) per wavelength and ray) grow 100x between the
    steps, under the default and fused schemes ('data' boundary kind), on
    the card and on the CPU; J and I after each step within BC_TOL, and
    the second step's J moved by the brighter boundary."""
    from lightweaver_tpu_torch.atmosphere import BoundaryCondition
    from lightweaver_tpu_torch.problems import mixed_precision_context

    class ScaledPlanck(BoundaryCondition):
        scale = 1.0

        def compute_bc(self, atmos, spect):
            h, c, kB = 6.62607015e-34, 2.99792458e8, 1.380649e-23
            nu = c / (np.asarray(spect.wavelength) * 1e-9)
            B = 2 * h * nu ** 3 / c ** 2 / np.expm1(h * nu / (kB * 5000.0))
            return self.scale * np.repeat(B[:, None], atmos.Nrays, axis=1)
    phase('callable upper BC changing 100x between two MALI steps: the '
          'mixed-precision problem (f64) on the card vs the CPU')
    for scheme in ('mali_full_precond', FUSED):
        bc = ScaledPlanck()
        ctxs = [mixed_precision_context(device=d, dtype=torch.float64)
                for d in ('cpu', 'cuda')]
        for ctx in ctxs:
            ctx.atmos.upperBc = bc
            ctx.set_fs_iter_scheme(scheme)
        Js, errs = [], []
        reset_counts()
        for scale in (1.0, 100.0):
            bc.scale = scale
            for ctx in ctxs:
                ctx.formal_sol_gamma_matrices()
            torch.cuda.synchronize()
            for key in ('J', 'I'):
                ours = getattr(ctxs[1], key).cpu().numpy()
                ref = getattr(ctxs[0], key).numpy()
                errs.append(float((np.abs(ours - ref).max(axis=1)
                                   / np.abs(ref).max(axis=1)).max()))
            Js.append(ctxs[1].J.cpu().numpy())
        counts = read_counts()
        moved = float((np.abs(Js[1] - Js[0]).max(axis=1)
                       / np.abs(Js[0]).max(axis=1)).max())
        print(f'  {scheme}: J, I card vs CPU after step 1 {errs[0]:.3e}, '
              f'{errs[1]:.3e}, after step 2 {errs[2]:.3e}, {errs[3]:.3e} '
              f'(bar {BC_TOL}); J moved {moved:.3e} between the steps; '
              f'launches sweep {counts["sweep"]}, fused {counts["fused"]}')
        expected = ({'sweep': 2, 'fused': 0} if scheme != FUSED
                    else {'sweep': 0, 'fused': 2})
        if {k: counts[k] for k in expected} != expected:
            raise AssertionError(f'launches {counts}, expected {expected}')
        if not max(errs) < BC_TOL or not moved > 1e-2:
            raise AssertionError(f'callable BC under {scheme}: card vs CPU '
                                 f'{max(errs):.3e}, J moved {moved:.3e}')


def converge_h6mg(scheme, hprd=False):
    """falc_h6mg (PRD, or hybrid PRD with the outflow ramp) converged on
    the card under ``scheme`` with iterate_ctx_se(prd=True), held against
    its golden run; the launch counts show the path's kernels ran: the
    sweep once per MALI step (default, _pallas) and once per PRD
    sub-iteration (the subset solve, every scheme), the line kernel once
    per MALI step for all groups, the fused kernel once per MALI step.
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
    if scheme == PALLAS:
        print(f'line kernel: one launch per MALI step for {len(sizes)} '
              f'groups, K = {sizes}')
    expected = {
        'mali_full_precond': dict(sweep=nIter + nSub, gamma=0, fused=0),
        PALLAS: dict(sweep=nIter + nSub, gamma=nIter, fused=0),
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


def falc500(scheme, dtype, nIter):
    """FALC-500 under ``scheme`` in the working ``dtype``: best of 3 blocks
    of ``nIter`` formal_sol_gamma_matrices iterations, then the stage
    breakdown (host clock, synchronised after each stage, mean of 5)."""
    from lightweaver_tpu_torch.problems import falc_interpolated, h6ca_context
    name = {torch.float64: 'float64', F32: 'float32'}[dtype]
    phase(f'FALC-500 under {scheme}, {name}: {nIter} iterations, best of 3')
    ctx = h6ca_context(falc_interpolated(500), 5, device='cuda', dtype=dtype)
    ctx.set_fs_iter_scheme(scheme)
    for _ in range(2):
        ctx.formal_sol_gamma_matrices()
    torch.cuda.synchronize()
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(nIter):
            u = ctx.formal_sol_gamma_matrices()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    if not (np.isfinite(float(u.dJMax)) and torch.isfinite(ctx.J).all()):
        raise AssertionError(f'non-finite J on FALC-500 ({scheme}, {name})')
    cfg = ctx.cfg
    gridPoints = cfg.Nlam * cfg.Nmu * 2 * cfg.Nk
    print(f'Nlam={cfg.Nlam} Nmu={cfg.Nmu} Nk={cfg.Nk}, {name}: '
          f'{best / nIter * 1e3:.3f} ms/iter, '
          f'{gridPoints * nIter / best:.4e} gridpoint-updates/s '
          '(host clock, synchronised per block)')

    it, params = ctx._iter_fn, ctx._params
    reps = 5
    stages = {}

    def timed(stage, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[stage] = stages.get(stage, 0.0) + (time.perf_counter()
                                                   - t0) / reps
        return out
    for _ in range(reps):
        scaJ = it.scaJ(params)
        if scheme == FUSED:
            I, Psi, IeffB, mom, srcRowsA = timed(
                'fused_stage', lambda: it.fused_stage(params, scaJ,
                                                      params['pack']))
            timed('gamma_rates', lambda: it.gamma_rates(
                params, I, Psi, IeffB, None, mom, None, srcRowsA))
            continue
        chi, src = timed('gather', lambda: it.gather(params, scaJ))
        rays = timed('formal_solve', lambda: it.formal_solve(params, chi,
                                                             src))
        if scheme == PALLAS:
            lt = timed('line_kernel_stage', lambda: it.line_kernel_stage(
                params, *rays[:3], src, params['pack']))
            timed('gamma_rates_rest', lambda: it.gamma_rates(
                params, rays[0], rays[1], rays[2], src, rays[3], lt))
        else:
            timed('gamma_rates', lambda: it.gamma_rates(
                params, *rays[:3], src, rays[3]))
    print(f'stage breakdown (ms, mean of {reps}): '
          + ', '.join(f'{k} {v * 1e3:.3f}' for k, v in stages.items()))
    del ctx, it, params
    torch.cuda.empty_cache()


# ---- float32 instances -----------------------------------------------
F32 = torch.float32
# err(kernel f32, plain f64) <= F32_SLACK err(plain f32, plain f64)
# + F32_FLOOR on every output, plain f64 run on the same (float32)
# inputs: the kernel must be as close to the float64 answer as the float32
# plain version, whose sums run in another order
F32_SLACK, F32_FLOOR = 2.0, 1e-6
# J of a float32 instance against the float64 sum of its own float32
# products w I, in its order
J_OWN_TOL = 1e-13


def upcast(args):
    """float64 copies of the floating tensors of a kernel's arguments
    (boundary pairs (kind, rows) included)."""
    from lightweaver_tpu_torch.ops.gamma import LineTable

    def up(a):
        if torch.is_tensor(a):
            return a.double() if a.is_floating_point() else a
        if isinstance(a, LineTable):
            return a.to(torch.float64)
        if isinstance(a, tuple) and len(a) == 2 and isinstance(a[0], str):
            return (a[0], up(a[1]))
        return a
    return [up(a) for a in args]


def f32_rule(label, names, kern, plain, ref):
    """Each float32 kernel output against the float64 plain version, beside
    the float32 plain version's distance to it; returns the largest
    |kernel - plain f32|."""
    worstAbs, parts = 0.0, []
    for n, k, p, r in zip(names, kern, plain, ref):
        if not all(torch.isfinite(x).all() for x in (k, p, r)):
            raise AssertionError(f'non-finite {n} ({label})')
        if not r.any():
            if k.any():
                raise AssertionError(f'{n} should be zero ({label})')
            continue
        ek, ep = max_rel(k.double(), r), max_rel(p.double(), r)
        worstAbs = max(worstAbs, (k.double() - p.double()).abs().max().item())
        parts.append(f'{n} {ek:.2e}/{ep:.2e}')
        if not ek <= F32_SLACK * ep + F32_FLOOR:
            raise AssertionError(f'float32 kernel too far from float64 on {n} '
                                 f'({label}): {ek:.3e} > {F32_SLACK} x '
                                 f'{ep:.3e} + {F32_FLOOR}')
    print(f'  {label}: err(kernel f32, plain f64) / err(plain f32, plain '
          f'f64): ' + ', '.join(parts))
    return worstAbs


def j_own_products(label, out, wmu):
    """J of a float32 instance equals the float64 sum of its own float32
    products w I, mu ascending within a direction, then down + up."""
    I, J = out[0], out[3]['J']
    w = 0.5 * wmu
    own = [sum((w[m] * I[d, :, m]).double() for m in range(I.shape[2]))
           for d in range(2)]
    err = max_rel(J, own[0] + own[1])
    print(f'  {label}: J against the float64 sum of its float32 products '
          f'{err:.1e} (bar {J_OWN_TOL})')
    if J.dtype != torch.float64 or not err <= J_OWN_TOL:
        raise AssertionError(f'J is not the float64 sum of the float32 '
                             f'products ({label}): {err:.3e}')


def timed_instances(label, kern, plain, kern64, bnd, symbol, reps=20):
    """The float32 instance, its plain version and the float64 instance
    on the upcast inputs, in turns (plain, f32, f64, plain): the kernels'
    device times (kernel_device_ms, two rounds each), the plain version's
    events."""
    p1 = cuda_ms(plain, 3)
    k1, k2 = kernel_device_ms(kern, symbol, reps)
    d1, d2 = kernel_device_ms(kern64, symbol, reps)
    p2 = cuda_ms(plain, 3)
    print(f'  {label}: float32 kernel {k1:.4f} / {k2:.4f} ms, float64 '
          f'kernel {d1:.4f} / {d2:.4f} ms, float32 plain {p1:.4f} / '
          f'{p2:.4f} ms{bound_text(bnd)} (float32)')
    return min(k1, k2), min(p1, p2), min(d1, d2)


def check_sweep_f32(label, args):
    from lightweaver_tpu_torch.ops import sweep
    args64 = upcast(args)
    kern = sweep.formal_solve_sweep(*args)
    plain = sweep.formal_solve_sweep_plain(*args)
    ref = sweep.formal_solve_sweep_plain(*args64)
    torch.cuda.synchronize()
    absErr = f32_rule(f'{label} sweep', RAY_NAMES, ray_outputs(kern),
                      ray_outputs(plain), ray_outputs(ref))
    j_own_products(f'{label} sweep', kern, args[6])
    bnd = sweep_bound(args, kern)
    ms, plainMs, ms64 = timed_instances(
        f'{label} sweep, per call', lambda: sweep.formal_solve_sweep(*args),
        lambda: sweep.formal_solve_sweep_plain(*args),
        lambda: sweep.formal_solve_sweep(*args64), bnd, SYMBOLS['sweep'])
    return dict(max_abs_err=absErr, ms=ms, plain_ms=plainMs, f64_ms=ms64,
                **bnd)


def check_line_f32(label, ctx, params, src, rays):
    from lightweaver_tpu_torch.ops import gamma
    itP, args = line_call(ctx, params, src, rays)
    table = args[0]
    args64 = upcast(args)
    kern = table.views(*gamma.line_gamma_rates(*args))
    plain = table.views(*gamma.line_gamma_rates_plain(*args))
    ref = table.views(*gamma.line_gamma_rates_plain(*args64))
    torch.cuda.synchronize()
    worst = 0.0
    for gi, (g, k3, p3, r3) in enumerate(zip(table.groups, kern, plain,
                                             ref)):
        rhoDev = (table.inputs(gi, args[1])[1] - 1.0).abs().max().item()
        worst = max(worst, f32_rule(
            f'{label} group of K = {g.K} at row {g.row0} (max|rho-1| = '
            f'{rhoDev:.2e})', ('G4', 'PPB', 'PairPPB'), k3, p3, r3))
    bnd = gamma_bound(args)
    ms, plainMs, ms64 = timed_instances(
        f'{label} line Gamma, all {len(table.groups)} groups of one '
        'iteration in one launch', lambda: gamma.line_gamma_rates(*args),
        lambda: gamma.line_gamma_rates_plain(*args),
        lambda: gamma.line_gamma_rates(*args64), bnd, SYMBOLS['gamma'])
    print(f'  {label} line_kernel_stage (float32): '
          f'{stage_host_ms(itP, params, src, rays, table):.3f} ms host')
    return dict(max_abs_err=worst, ms=ms, plain_ms=plainMs, f64_ms=ms64,
                K=table.maxK, **bnd)


def check_fused_f32_args(label, args):
    from lightweaver_tpu_torch.ops import fused
    args64 = upcast(args)
    kern = fused.fused_lambda_step(*args)
    plain = fused.fused_lambda_step_plain(*args)
    ref = fused.fused_lambda_step_plain(*args64)
    torch.cuda.synchronize()
    C = args[0].shape[0]
    absErr = f32_rule(f'{label} fused (C = {C})', RAY_NAMES,
                      ray_outputs(kern), ray_outputs(plain),
                      ray_outputs(ref))
    j_own_products(f'{label} fused', kern, args[8])
    bnd = fused_bound(args, kern)
    ms, plainMs, ms64 = timed_instances(
        f'{label} fused, per call', lambda: fused.fused_lambda_step(*args),
        lambda: fused.fused_lambda_step_plain(*args),
        lambda: fused.fused_lambda_step(*args64), bnd, SYMBOLS['fused'])
    return dict(max_abs_err=absErr, ms=ms, plain_ms=plainMs, f64_ms=ms64,
                C=C, **bnd)


def prd_state(dtype):
    """falc_h6mg on the card after three MALI steps and one
    prd_redistribute (rho != 1): the Context, its params, scaJ, srcNum and
    the rays of one iteration (default scheme)."""
    from lightweaver_tpu_torch.problems import h6mg_context
    ctx = h6mg_context(device='cuda', dtype=dtype)
    for _ in range(3):
        ctx.formal_sol_gamma_matrices()
        ctx.stat_equil()
    ctx.prd_redistribute()
    rhoDev = max((r - 1.0).abs().max().item() for row in ctx.rhoPrd
                 for r in row if r is not None)
    print(f'  falc_h6mg ({dtype}): max|rho-1| over the PRD lines = '
          f'{rhoDev:.3e}')
    if not rhoDev > 0.1:
        raise AssertionError('rho stayed at 1 after prd_redistribute')
    params = ctx.build_params()
    it = ctx._iter_fn
    scaJ = it.scaJ(params)
    chi, src = it.gather(params, scaJ)
    return ctx, params, scaJ, src, it.formal_solve(params, chi, src)


def f32_kernel_check():
    """(a) The float32 instances against their plain versions, each output
    by the rule of f32_rule: the sweep on random rays at Nk = 82 and 500
    and on one falc_h6ca float32 iteration's inputs, line Gamma on its 13
    groups, on falc_h6mg's (the K = 4 Mg II group, rho != 1) and on
    FALC-500's, fused with C = 2 on falc_h6ca and FALC-500 and C = 3 on
    falc_h6mg; float32 and float64 instance times side by side.  Returns
    falc_h6ca's records."""
    from lightweaver_tpu_torch.fal import Falc82
    from lightweaver_tpu_torch.problems import h6ca_context, random_rays
    phase('float32 instances vs their plain versions (bar: err(kernel '
          f'f32, plain f64) <= {F32_SLACK} err(plain f32, plain f64) + '
          f'{F32_FLOOR})')
    for Nmu, Nk in SWEEP_SHAPES:
        rays = random_rays(1046, Nmu, Nk, seed=Nk)
        check_sweep_f32(f'Nmu={Nmu} Nk={Nk} random rays', [
            torch.tensor(rays[k], dtype=F32, device='cuda') for k in
            ('chi', 'srcNum', 'height', 'muz', 'IupwD', 'IupwU', 'wmu')])
    for bcs in FUSED_BCS:
        check_fused_f32_args(f'random slots Nmu=17, BCs {bcs[0]}/{bcs[1]}',
                             random_fused_args(F32, bcs))
    check_group_of_six(F32)
    ctx = h6ca_context(Falc82(), 5, device='cuda', dtype=F32)
    ctx.formal_sol_gamma_matrices()
    ctx.stat_equil()
    params = ctx.build_params()
    it = ctx._iter_fn
    scaJ = it.scaJ(params)
    chi, src = it.gather(params, scaJ)
    args = it.sweep_inputs(params, chi, src)
    records = {'sweep_f32': check_sweep_f32('falc_h6ca', args)}
    rays = it.formal_solve(params, chi, src)
    records['gamma_f32'] = check_line_f32('falc_h6ca', ctx, params, src,
                                          rays)
    records['fused_f32'] = check_fused_f32_args(
        'falc_h6ca', fused_args(ctx, params, scaJ))
    ctx, params, scaJ, src, rays = prd_state(F32)
    K = check_line_f32('falc_h6mg PRD', ctx, params, src, rays)['K']
    C = check_fused_f32_args('falc_h6mg PRD',
                             fused_args(ctx, params, scaJ))['C']
    del ctx, params, rays
    torch.cuda.empty_cache()
    ctx, params, scaJ, src, rays = one_iteration_inputs(500, F32)
    check_line_f32('FALC-500', ctx, params, src, rays)
    check_fused_f32_args('FALC-500', fused_args(ctx, params, scaJ))
    if K != 4 or C != 3 or records['fused_f32']['C'] != 2:
        raise AssertionError(f'expected K = 4 and C = 3 on falc_h6mg, C = 2 '
                             f'on falc_h6ca; got {K}, {C}, '
                             f'{records["fused_f32"]["C"]}')
    del ctx, params, rays, chi, src, args
    torch.cuda.empty_cache()
    return records


def converge_mixed(scheme):
    """(b) The mixed-precision problem (tests/test_mixed_precision.py's) in
    float32 under ``scheme`` through iterate_ctx_se; fewer than 600
    iterations required (the JAX float32 state: 408 on the CPU)."""
    from lightweaver_tpu_torch.problems import mixed_precision_context
    ctx = mixed_precision_context(device='cuda', dtype=F32)
    ctx.set_fs_iter_scheme(scheme)
    nIter, updates, wall, counts = run_counted(ctx, 600)
    print(f'  mixed-precision problem under {scheme}: {nIter} iterations '
          f'(bar < 600), last dJ {float(updates[0].dJMax):.3e}, dPops '
          f'{updates[1].dPopsMax:.3e}, {wall:.2f} s; float32 launches '
          + ', '.join(f'{k} {counts[k]}' for k in F32_NAMES))
    if not nIter < 600:
        raise AssertionError(f'the mixed-precision problem did not converge '
                             f'under {scheme} in {nIter} iterations')
    if not torch.isfinite(ctx.I).all():
        raise AssertionError('non-finite emergent intensity')


F32_NAMES = ('sweep_f32', 'gamma_f32', 'fused_f32')


def run_counted(ctx, NmaxIter):
    """iterate_ctx_se on ``ctx`` with the launch counts set to 0 before and
    read after; returns (formal_sol_gamma_matrices calls, the last J and
    populations updates, wall s, counts)."""
    from lightweaver_tpu_torch import iterate_ctx_se
    fsgm, calls = ctx.formal_sol_gamma_matrices, []

    def counted():
        calls.append(1)
        return fsgm()
    ctx.formal_sol_gamma_matrices = counted
    reset_counts()
    t0 = time.perf_counter()
    updates = iterate_ctx_se(ctx, NmaxIter=NmaxIter, quiet=True,
                             returnFinalConvergence=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    del ctx.formal_sol_gamma_matrices
    return len(calls), updates, wall, counts


# (c)'s bars on the emergent spectrum against the golden file: twice the
# JAX float32 state's distances on the CPU (3.26e-2 on the rows brighter
# than 1e-3 of the peak, median 2.46e-3: scripts/precision_floors.py's
# measure)
F32_BRIGHT_BAR, F32_MEDIAN_BAR = 6.5e-2, 5e-3
# (c)'s iterations: past the 211 in which the float64 state converges, so
# the float32 state sits at its noise floor
F32_FULL_ITERS = 300


def falc_h6ca_f32(scheme):
    """(c) falc_h6ca at full width with a float32 state under ``scheme``,
    iterate_ctx_se with NmaxIter = F32_FULL_ITERS; the float32 state does
    not converge there (nor does the JAX package's), so the checks are its
    envelope: finite, and the emergent spectrum within the bars above.
    Returns the launch counts of the run."""
    from lightweaver_tpu_torch.fal import Falc82
    from lightweaver_tpu_torch.problems import h6ca_context
    ref = np.load(ROOT / 'tests' / 'golden' / 'falc_h6ca_ref.npz')
    ctx = h6ca_context(Falc82(), 5, device='cuda', dtype=F32)
    ctx.set_fs_iter_scheme(scheme)
    nIter, updates, wall, counts = run_counted(ctx, F32_FULL_ITERS)
    I = ctx.I.double().cpu().numpy()[:, -1]
    Iref = ref['out_I'][:, -1]
    rel = np.abs(I - Iref) / np.maximum(np.abs(Iref), 1e-300)
    bright = Iref > 1e-3 * Iref.max()
    popsErr = max(relerr(ctx.popsState[ia]['n'].cpu(),
                         ref[f'out_pops_a{ia}']) for ia in range(2))
    dJ, dPops = float(updates[0].dJMax), updates[1].dPopsMax
    converged = dJ < 5e-3 and dPops < 1e-3 and nIter < F32_FULL_ITERS
    print(f'  falc_h6ca float32 under {scheme}: {nIter} iterations, '
          f'converged {converged}, last dJ {dJ:.3e}, dPops {dPops:.3e}; '
          f'{wall:.2f} s, {wall / nIter * 1e3:.3f} ms/iter')
    print(f'    emergent I (mu = last ray) vs golden: bright rows max '
          f'{rel[bright].max():.3e} (bar {F32_BRIGHT_BAR}), median '
          f'{np.median(rel):.3e} (bar {F32_MEDIAN_BAR}); pops max rel '
          f'{popsErr:.3e}; float32 launches '
          + ', '.join(f'{k} {counts[k]}' for k in F32_NAMES)
          + ', float64 launches '
          + ', '.join(f'{k} {counts[k]}' for k in ('sweep', 'gamma',
                                                   'fused')))
    if not (np.isfinite(I).all() and all(
            torch.isfinite(st['n']).all() for st in ctx.popsState)):
        raise AssertionError(f'non-finite float32 state under {scheme}')
    if not (rel[bright].max() <= F32_BRIGHT_BAR
            and np.median(rel) <= F32_MEDIAN_BAR):
        raise AssertionError(f'float32 spectrum outside its envelope under '
                             f'{scheme}')
    expected = {'mali_full_precond': ('sweep_f32',),
                PALLAS: ('sweep_f32', 'gamma_f32'),
                FUSED: ('fused_f32',)}[scheme]
    if (any(counts[k] < nIter for k in expected)
            or any(counts[k] for k in ('sweep', 'gamma', 'fused'))):
        raise AssertionError(f'launches under {scheme}: {counts}')
    return counts


# ---- the least time the card could take for a kernel's work -----------
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
# peak rates outside the tensor cores, float32 and float64, from NVIDIA's
# H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# floating-point operations per (ray, depth) point of the Bezier-3 step
# and its moments, counted from csrc/bezier3.cuh and sweep.cu: two
# Steffen derivatives (~13 each), control points and dtau (~10), the
# Bezier weights (~30 with the exp), b, psiN, bNL and the recurrence
# (~20), Psi and IeffBase (~5), the moment pass (~8)
SWEEP_FLOPS = 100
# per member, row, ray and depth of the line Gamma kernel: Vij, Vji, Uji,
# chi and eta (~9), Ieff (~3), the level sums (~4 per member) and the
# four accumulations (~16), PPB (~3)
GAMMA_FLOPS = 31


def nbytes(xs):
    seen, total = set(), 0
    for x in xs:
        if torch.is_tensor(x) and id(x) not in seen:
            seen.add(id(x))
            total += x.numel() * x.element_size()
    return total


def bound(nBytes, flops, dtype):
    """bound_ms and bound_by: the larger of the bytes over the memory rate
    and the operations over the peak rate of their type."""
    tBytes = nBytes / HBM_BYTES_PER_S
    tOps = flops / PEAK_FLOPS[dtype]
    return {'bound_ms': max(tBytes, tOps) * 1e3,
            'bound_by': 'bytes' if tBytes >= tOps else 'operations'}


def sweep_bound(args, out):
    """Every input read once and every output written once."""
    chi = args[0]
    return bound(nbytes(list(args) + list(out[:3]) + list(out[3].values())),
                 SWEEP_FLOPS * chi.numel(), chi.dtype)


def gamma_bound(args):
    """One call of line_gamma_rates: the ray tensors on the rows some group
    covers, each active atom's continuum chi/U rows of its groups'
    levels on those groups' rows and etaC there, the populations, each
    group's phi, rho, coef and wphi; G4, PPB and PairPPB out."""
    table, rho, Psi = args[:3]
    Nlam, Nmu, Nk = Psi.shape[1], table.Nmu, table.Nk
    item = Psi.element_size()
    rows = torch.zeros(Nlam, dtype=torch.bool)
    levRows = torch.zeros((table.nLev, Nlam), dtype=torch.bool)
    etaRows = torch.zeros((table.nAtoms, Nlam), dtype=torch.bool)
    flops = 0
    for g in table.groups:
        win = slice(g.row0, g.row0 + g.Wu)
        rows[win] = True
        etaRows[g.ai, win] = True
        for ij in g.statics.levels:
            for lv in ij:
                levRows[g.levOff + lv, win] = True
        P = g.K * (g.K - 1) // 2
        flops += ((GAMMA_FLOPS + 4 * g.K) * g.K + 4 * P) \
            * g.Wu * 2 * Nmu * Nk
    total = item * (4 * 2 * int(rows.sum()) * Nmu * Nk
                    + 2 * int(levRows.sum()) * Nk + int(etaRows.sum()) * Nk
                    + sum(table.sizes)) + nbytes(
        [table.phi, rho, args[9], table.coef, table.wphi, args[10]])
    return bound(total, flops, Psi.dtype)


def fused_bound(args, out):
    """phiP, the coefficient and background rows and the boundaries in;
    the rays and moments out; the sweep's operations plus the assembly of
    chi and srcNum from C slots (two multiply-adds each per slot), once
    per (ray, depth)."""
    phiP = args[0]
    C = phiP.shape[0]
    ins = list(args[:9]) + [rows for _, rows in args[9:]]
    return bound(nbytes(ins + list(out[:3]) + list(out[3].values())),
                 (SWEEP_FLOPS + 4 * C) * phiP[0].numel(), phiP.dtype)


# name -> (source, the pallas_call of the TPU kernel it replaces)
KERNELS = {
    'sweep': ('lightweaver_tpu_torch/csrc/sweep.cu',
              'lightweaver_tpu/ops/pallas_sweep.py:297'),
    'gamma': ('lightweaver_tpu_torch/csrc/gamma.cu',
              'lightweaver_tpu/ops/pallas_gamma.py:249'),
    'fused': ('lightweaver_tpu_torch/csrc/fused.cu',
              'lightweaver_tpu/ops/pallas_fused.py:240'),
    'sweep_f32': ('lightweaver_tpu_torch/csrc/sweep.cu',
                  'lightweaver_tpu/ops/pallas_sweep.py:297'),
    'gamma_f32': ('lightweaver_tpu_torch/csrc/gamma.cu',
                  'lightweaver_tpu/ops/pallas_gamma.py:249'),
    'fused_f32': ('lightweaver_tpu_torch/csrc/fused.cu',
                  'lightweaver_tpu/ops/pallas_fused.py:240'),
    'probe_elementwise': ('lightweaver_tpu_torch/csrc/probe.cu',
                          'scripts/pallas_probe.py:28'),
    'probe_recurrence': ('lightweaver_tpu_torch/csrc/probe.cu',
                         'scripts/pallas_probe.py:57'),
}
SCHEMES = ('mali_full_precond', PALLAS, FUSED)


def main():
    tStart = time.perf_counter()
    smi = environment()
    build_kernels()
    probes = probe_check()
    kernel_check()
    scheme_kernel_check()
    main_path()
    scheme_paths()
    callable_bc_check()
    prdKern = prd_kernel_check()
    launches = prd_paths()
    f32Kern = f32_kernel_check()
    phase('mixed-precision problem (40 depths, 3 rays, Ca II active) in '
          'float32 under each scheme')
    for scheme in SCHEMES:
        converge_mixed(scheme)
    phase('falc_h6ca at full width in float32 under each scheme, '
          f'NmaxIter = {F32_FULL_ITERS}')
    f32Launches = dict.fromkeys(F32_NAMES, 0)
    for scheme in SCHEMES:
        counts = falc_h6ca_f32(scheme)
        for k in F32_NAMES:
            f32Launches[k] += counts[k]
    for scheme, nIter in zip(SCHEMES, (50, 20, 20)):
        for dtype in (torch.float64, F32):
            falc500(scheme, dtype, nIter)
    # the kernels' record: the float64 instances on the PRD path (phase 8's
    # launches, phase 7's inputs), the float32 ones on falc_h6ca's float32
    # path (phase (c)'s launches, phase (a)'s inputs), the probes
    records = {name: dict(prdKern[name], launches=launches[name])
               for name in ('sweep', 'gamma', 'fused')}
    records.update({name: dict(f32Kern[name], launches=f32Launches[name])
                    for name in F32_NAMES})
    records.update(probes)
    print(f'chip_smoke wall time: {time.perf_counter() - tStart:.1f} s '
          '(kernel builds included)')
    print(smi)
    print(json.dumps({'kernels': [{
        'name': name, 'route': 'cuda', 'source': KERNELS[name][0],
        'replaces': KERNELS[name][1], 'launches': r['launches'],
        'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
        'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
        'bound_by': r['bound_by'], 'library_ms': r.get('library_ms')}
        for name, r in records.items()]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
