"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero and prints no
result):

1. Environment: torch and CUDA versions, the card's name and power limit;
   then the five kernel libraries are built from csrc/ at once, one nvcc
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
   'mali_full_precond_fused', for SCHEME_STEPS = 20 MALI steps against
   the default scheme's state after as many (GOLDEN_RTOL; converged
   against golden until phase 16 needed the time, 40 steps until phase
   17 did), with the launch
   counts of their kernels.
   Then a callable upper boundary whose data grow 100x between two MALI
   steps of the mixed-precision problem (f64), under the default and
   fused schemes, on the card against the CPU.
7. PRD kernel inputs: falc_h6mg (FAL-C, H 6-level + Mg II active, 5
   rays, Ly-alpha, Ly-beta and Mg II h & k in PRD) after three MALI
   steps and one prd_redistribute, so rho != 1: the line Gamma kernel on
   every group (Mg II's four-line group among them), the fused kernel
   with its three rho-scaled slots and the sweep on the PRD subset rows,
   each against its plain version; times.  (b) The PRD scattering kernel
   (csrc/prd_scatter.cu) at the hybrid-PRD column batch's shapes: each
   of the four PRD lines' integral inputs (windows of 101 / 51 / 250 /
   219 rows) tiled over PRD_BATCH_COLUMNS = 512 columns (41,984 depths),
   each column's qWave and J scaled by its own factor: rho against the
   plain version (PRD_SCATTER_TOL = 1e-12 of its maximum), the kernel's
   device time, the plain version's and the least time
   (lwbench/harness/prd_work.py), launches, ptxas registers and spills.
   (c) The PRD subset kernel (csrc/prd_subset.cu) at the same batch's
   shapes: the hybrid-PRD subset solve's held terms and lines of
   falc_h6mg with a 10 km/s outflow (428 rows, four PRD lines) tiled over
   PRD_BATCH_COLUMNS columns: against the sweep kernel on the plain
   assembly (PRD_SUBSET_TOL = 0: the same bits) and against the plain
   version (KERNEL_TOL), the kernel's device time beside the plain
   version's and the least time, ptxas registers and spills, the float32
   instance's time.
8. falc_h6mg PRD converged under the default scheme through
   iterate_ctx_se(prd=True), and its hybrid-PRD variant (0-5 km/s
   outflow), against their golden runs
   (tests/golden/falc_h6mg_{prd,hprd}_ref.npz), with iterations, PRD
   sub-iterations, wall time and launch counts (a sweep per MALI step, a
   PRD subset kernel per sub-iteration); the kernel schemes for
   PRD_SCHEME_STEPS = 10 MALI steps against the default scheme's state
   after as many (populations and rho within GOLDEN_RTOL; converged
   against golden until phase 13 needed the time, 40 steps until phase
   17 did, 20 until phase 18), and they must refuse
   hybrid PRD.  Then a stage breakdown of one PRD iteration.
9. The population-update options, in float64.  (a) falc_multi_ng
   (BASELINE config 2: FAL-C, H 6-level + Ca II + Na I active, Mg II
   passive, 5 rays, Ng(2, 5, 50) on the populations): its inputs against
   the golden file; the sweep, line Gamma (three atoms' groups, Na I
   D1/D2 one K = 2 group) and fused kernels against their plain versions
   on one iteration's inputs after 3 MALI steps, with times and bounds;
   converged under the default scheme against its golden run
   (tests/golden/falc_multi_ng_ref.npz: 221 iterations, populations
   within 1e-6, J and I within 3e-6), the dJ and dPops histories beside
   the golden file's with the iterations Ng extrapolated, and launch
   counts; the kernel schemes for NG_SCHEME_STEPS = 60 MALI steps (two
   Ng extrapolations) against the default scheme's populations after as
   many (1e-6); Ng(2, 5, 10) must raise ExplodingMatrixError.  (b) On phase 5's
   converged falc_h6ca: the finite-difference dC/dne against
   falc_h6ca_nr_inputs.npz (1e-10) and one raw Newton-Raphson charge-
   conservation step against the compiled reference's
   (falc_h6ca_nr_ref.npz: populations within 1e-7, ne within 1e-9); then
   falc_h6ca with conserveCharge=True for 3 MALI steps whose stat_equil
   runs the NR step, card against CPU.  (c) falc_ca_timedep (Ca II active, 546
   wavelengths): 6 backward-Euler steps of 0.2 s under each scheme
   against the golden run (populations per step within 1e-6, J within
   1e-7).  (d) The escape-probability start of the 30-depth Ca II problem
   on the card against the CPU (1e-10), and the iterations to converge
   from it (and from LTE until phase 17 needed the time).
10. The float32 state (dtype=torch.float32, J/Gamma/rates in float64):
   (a) the float32 instances against their plain versions, every output
   held to err(kernel f32, plain f64) <= 2 err(plain f32, plain f64) +
   1e-6 with plain f64 on the same inputs, and J to the float64 sum of
   the kernel's own float32 products (1e-13): the sweep on random rays at
   phase 3's shapes and on one falc_h6ca float32 iteration, fused on
   phase 4's random slots, line Gamma on the K = 6 group, falc_h6ca's 13
   groups, falc_h6mg's (K = 4, rho != 1) and FALC-500's, fused with C = 2
   (falc_h6ca, FALC-500) and C = 3 (falc_h6mg); float32 and float64
   instance times side by side.  (b) The mixed-precision problem (FAL-C decimated
   to 40 depths, 3 rays, Ca II active) converged under the default
   scheme in fewer than 600 iterations, and 40 MALI steps of it under
   each kernel scheme, finite and contracting (converged under each
   until phase 17 needed the time).  (c) falc_h6ca at full width under
   each scheme, F32_FULL_ITERS = 60 iterations (230 until phase 17
   needed the time; the float32 state does not converge in 500, in the
   JAX package either; the f64 state converges in 211): the last dJ
   and dPops, the emergent spectrum
   against the golden file (rows brighter than 1e-3 of the peak within
   6.5e-2, median within 5e-3), the populations' largest error, and the
   float32 instances' launches.
11. (Until phase 17 needed the time: FALC-500 under each scheme and
   precision with stage breakdowns; its ms/iter now comes from phase 17
   (g)'s benchmark.)
12. Spectrum synthesis, in float64 unless stated.  (a) Right after phase
   5, the README program's last call on its converged falc_h6ca:
   compute_rays(np.linspace(392.5, 394.5, 1001), mus=[1.0]) on the card
   (one sweep launch), against the same state's compute_rays on the CPU
   (1e-9 of the spectrum's maximum), with its ms.  After phase 9: (b) the
   sweep kernel's instance of each 1D solver (linear, Bezier-3, BESSER)
   in each precision against its plain version, on one falc_h6ca
   iteration's inputs and (linear, BESSER) on FALC-500 random rays:
   float64 within 1e-9, float32 by phase 10's rule, with times and
   bounds.  (c) falc_h6ca under the BESSER and the linear solver,
   LINEAR_STEPS = 60 MALI steps each, finite and contracting (converged
   in the JAX package's 214 and 349 iterations, scripts/
   jax_solver_iterations.py, until phases 18 and 17 needed the time),
   and 40 MALI steps of
   the mixed-precision problem in float32 under each (finite,
   contracting); each run launches its solver's instance only.  (d)
   BASELINE config 4 (falc_h6ca in a 0.1 T field, gamma = pi/3, chi =
   pi/6) converged under the fused scheme (golden falc_h6ca_stokes: 211
   iterations, populations
   within 1e-7), its polarised profiles (1e-5) and single_stokes_fs(
   updateJ=True) (I 1e-6, Q/U/V 1e-3, amplitude-normalised) against the
   golden run, with the single_stokes_fs ms; compute_rays(stokes=True)
   over Ca II 854.2 nm, card against CPU (1e-9).  (e) falc_h6ca pickled at
   MALI step 12, loaded on the card and resumed, against an
   uninterrupted 30-step run (5e-12).
13. The 1.5D column batch (parallel.ColumnBatch, problems.column_batch:
   FAL-C columns with T x uniform(0.95, 1.05), H 6-level + Ca II
   active, 5 rays).  (a) One iteration's inputs of 64 columns: the
   sweep, line Gamma and fused kernels (f64, f32) over every column in
   one launch against their plain versions (KERNEL_TOL / GAMMA_TOL, the
   float32 rule), with times and bounds, and the first, middle and last
   columns of each sweep and fused launch bit for bit their own
   single-column launches.  (b) BASELINE config 5's 1.5D leg: BATCH_C =
   128 columns (512 until phase 17 needed the time, 256 until phase 18)
   through
   ColumnBatch.iterate(NmaxIter=400); every column converges; the
   slowest column re-run as a single card Context for 60 iterations
   against the batch's state after as many (populations 1e-9; three
   columns for their nIterCol iterations until phase 16 needed the
   time); ms per batch step, column-iterations per second against
   the single Context's, peak memory, one sweep launch per MALI step and the
   sweep's time at the batch shape.  (c) BATCH_SCHEME_STEPS = 10 steps
   of that batch (from LTE; 20 until phase 17 needed the time) under
   each scheme, populations within 1e-9 of the default's,
   one launch per stage per step, a stage breakdown and the line Gamma
   and fused kernels' times at the batch shape; then 10 float32 steps,
   finite and contracting, and the three kernels' float32 instances'
   times and bounds at the batch shape.  (d) 32 columns with H 6-level active,
   Ly-alpha and Ly-beta in PRD, hybrid PRD, accelerateScattering and
   0-5 km/s outflows spread over the columns: 20 MALI steps with
   prd_redistribute(maxIter=3), two columns against single card
   Contexts (rho and populations 1e-8).
14. 2D (problems.slab_2d: FAL-C with a +-5% temperature perturbation and
   a 1 km/s shear flow along x, H 6-level + Ca II with Ca II active), in
   float64 unless stated; the plane sweep is csrc/sweep2d.cu (the JAX
   package leaves it to XLA), and every run must launch it and no other
   csrc/ kernel.
   (a) The golden 2D problem (30 x 8, callable x boundaries, 6 rays)
   converged through iterate_ctx_se under piecewise_linear_2d with the
   compat x-lower boundary (tests/golden/falc2d_ca_ref.npz: 154
   iterations, populations, J and I within 1e-8), and 40 MALI steps
   under piecewise_besser_2d, finite and contracting (converged against
   falc2d_ca_besser_ref.npz, 218 iterations, 1e-9, until phase 17 needed
   the time); ms per iteration.  (b) BASELINE config 5's 2D leg: 82 x 256 periodic (40 km
   columns), 12 rays, BESSER, 6 MALI steps from LTE with stat_equil after
   each (20 until phase 16 needed the time): finite, dJ contracting; ms per step, peak memory, the stage
   breakdown and the profile of one step (kernels per step, idle share:
   scripts/torch_profile.py; two steps until phase 18 needed the time);
   the same slab rolled by 64 columns: J and
   the populations after 3 steps equal the unrolled ones, rolled (1e-10;
   populations relative to each level's maximum).  The 2D kernel on the
   slab's inputs, float64 and float32 (a float32 slab, one MALI step):
   for each direction the gathered chi and srcNum, the ray group and the
   boundary data that formal_solve_2d hands sweep_rays_2d, the kernel
   against sweep_rays_2d_plain (I, Psi and IeffBase within 1e-12 of each
   output's maximum in float64, by phase 10's rule in float32), the
   kernel's device time and the plain loop's per call, and the launches
   of the slab's own MALI steps.  (c) On the golden
   atmosphere: 3 float32 MALI steps, card against CPU by phase 10's rule;
   single_stokes_fs on the slab in phase 12's field and
   compute_rays(mus=[0.7, 1.0]), card against CPU (1e-9 of each
   wavelength's maximum), with their ms.
15. The Context options, each on the card with no CPU fallback and
   checked against the CPU or the card's own other path.  (a) falc_h6mg
   with hybrid PRD in float32 (0-5 km/s outflow): 10 MALI steps with
   prd_redistribute(maxIter=3), ms per outer iteration, the float32
   sweep's launches on the full grid and the float32 PRD subset kernel's
   on the subset rows (both above 0); from that state one MALI iteration and one prd_redistribute,
   card against CPU by phase 10's rule against a float64 twin.  (b)
   falc_h6ca with dense Gamma, float64 and float32, 3 MALI steps deep:
   dense against factored (1e-12 and 3e-5 of each array's maximum,
   tests/test_gamma_modes.py's bars).  (c) depthData on falc_h6ca under
   each scheme: chi, eta and I per wavelength across the schemes and
   against the CPU (1e-10); compute_radiative_losses on the card's
   capture against the CPU's.  (d) A counting backgroundProvider,
   initSol=InitialSolution.Zero and a detailed Ca II atom beside H 6
   active: two MALI steps each with stat_equil between, card against
   CPU.
16. Distribution (parallel/): ranks in processes of their own
   (multiprocessing's spawn), every rank on this card, joined by gloo
   (NCCL refuses two ranks on one device); a rank that fails or outlives
   DIST_DEADLINE fails the phase, and the ranks end before the parent
   prints its last lines.  (a) Phase 13's 256 columns on a (2, 1) mesh,
   128 per rank, 10 steps from LTE: populations and J within 1e-9 of
   phase 13 (c)'s default scheme after as many steps, ms per batch step
   beside it, one sweep launch per rank and step.  (b) Phase 14's 82 x
   256 slab x-sharded over the two ranks (Context(mesh=)), 3 BESSER MALI
   steps with stat_equil: J within 1e-10 of each wavelength's maximum
   against phase 14's after as many, ms per step, the all_gathers per
   step, no csrc/ kernel.  (c) 8 falc_h6ca columns on a (1, 2)
   wavelength mesh under the default scheme (each scheme until phase 18,
   which runs them all on a wavelength mesh, needed the time), 5 steps
   (stat_equil from the
   fourth): the Gamma of each step within 1e-10 of the unsharded batch's
   step from the same state (J and populations).  (d) NCCL at world size 1
   (initialize_multihost(num_processes=1, backend='nccl')): its
   all_reduce, all_gather and broadcast on CUDA tensors, and a 64-column
   batch on the (1, 1) mesh equal to the unmeshed one.
17. The MALI loop on the device (Context.iterate_on_device), float64.
   (a) falc_h6ca at full width under the default scheme to convergence:
   the JAX package's iterate_on_device count on the CPU (211:
   scripts/jax_on_device_iterations.py) and, at the golden run's count,
   the populations within 1e-7 of golden; ms per MALI step, host reads
   (at most one per iteration) and launches.  (b) tests/
   test_on_device_loop.py's 25-depth H 6 + Ca II problem with Ng(2, 5, 8):
   the host Ng loop's count and populations (1e-7), fewer iterations than
   without Ng.  (c) Its H 6 PRD (30 depths, 10 sub-iterations to 2e-4)
   and hybrid-PRD (24 depths, 8 km/s outflow, 6 to 1e-3) setups with
   accelerateScattering against iterate_ctx_se(prd=True): iterations
   within 2, populations 5e-3, rho 1e-3.  (d) falc_h6ca under each
   scheme, 10 steps of the host loop and of iterate_on_device with zero
   tolerances (20 until phase 18 needed the time): populations within
   1e-9.  (e) One on-device body per
   scheme with Ng (falc_h6ca) and with PRD (falc_h6mg), and hybrid PRD
   under the default scheme, under torch.cuda.set_sync_debug_mode(
   'error').  (f) For (d)'s runs: ms per MALI step, host reads and
   kernel launches per step of each loop, the synchronising operations
   per step (sync-warn mode), and under the default scheme
   scripts/torch_profile.py's kernels and idle share over 2 steps of
   each (5 until phase 18 needed the time).  (g) benchmark(Niter=10) on
   FALC-500 (precisions, Gamma accumulation, schemes): the FALC-500
   ms/iter.
18. The rest of the distribution, two gloo ranks on this card as in
   phase 16.  (a) falc_h6mg's atoms (H 6 and Mg II active) on 8 FAL-C
   columns on a (1, 2) wavelength mesh: 5 rounds of a MALI step,
   stat_equil and prd_redistribute(maxIter=3) under each scheme and
   hybrid PRD under the default one, each round in lockstep with one
   rank's batch from the same state (rho per row, J per wavelength, the
   populations per level: 1e-9); kernel 1 on the largest block's PRD rows
   against its plain version, with its time, bound and launches per
   block.  (b) The 82 x 256 slab (linear 2D solver) x-sharded: 8 MALI
   steps with Ng(2, 5, 8), update_deps after T x 1.01 and a MALI step,
   state_dict, compute_rays on a Ca II K window at mu = 1 and
   single_stokes_fs in a field, against the same calls on one rank
   (the populations 1e-9 per level; the radiation of the seventh step,
   the last before Ng's extrapolation, 1e-9 per wavelength, and after it
   1e-7), ms of each and the Stokes sweep's peak memory per rank.
   (c) An 82 x 32 slab with H 6 active: charge conservation, PRD and
   hybrid PRD, 2 rounds each, against one rank (1e-9).  (d)
   iterate_on_device on the 82 x 32 slab in lockstep with the host loop
   (5 steps, 1e-9), and one on-device body under NCCL at world size 1
   with set_sync_debug_mode('error').

Kernel times are device times from torch.profiler (the mean CUDA
duration of the kernel's launches, one per call, kernel_device_ms); the
plain versions' are CUDA events around their calls.  The kernels' JSON record holds phase
7's errors and times and phase 8's launch counts for the float64
instances (the PRD path; 7 (b)'s for the PRD scattering kernel, its times
and bound summed over the four lines; 7 (c)'s for the PRD subset kernel), phase 10 (a)'s falc_h6ca errors and times and
(c)'s launch counts for the float32 ones, phase 12 (b)'s falc_h6ca errors
and times and (c)'s launch counts for the sweep's linear and BESSER
instances, phase 14 (b)'s slab errors, times and launches for the 2D
kernel's float64 and float32 instances, and the probes'; phase 15's, phase 17's ((a), (c) and
(d)'s on-device runs) and phase 18 (a)'s sweep launches on the
wavelength blocks are added to each instance's count; each
with the
least time the card could take for its inputs (bound_ms) and, where one
PyTorch call computes the same function, that call's time.  The last four
lines are the total wall time, the card's name and power limit as
nvidia-smi prints them, the kernels' JSON record and the ok line.
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


T_START = time.perf_counter()


def phase(name):
    """Print a phase's heading with the seconds since the script started."""
    print(f'== {name} [t = {time.perf_counter() - T_START:.1f} s]',
          flush=True)


def relerr(ours, ref):
    ours = np.asarray(ours)
    ref = np.asarray(ref)
    return float((np.abs(ours - ref) / np.abs(ref).clip(1e-300)).max())


def golden(name):
    """The golden file tests/golden/<name>.npz."""
    return np.load(ROOT / 'tests' / 'golden' / f'{name}.npz')


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
           'fused': 'fused_kernel', 'sweep2d': 'sweep2d_kernel',
           'prd_scatter': 'prd_scatter_kernel',
           'prd_subset': 'prd_subset_kernel'}


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
    """Kernel name -> (wrapper, its launch-count attribute): each instance
    of a wrapper (float64 and float32; the sweep's three solvers) keeps
    its own count."""
    from lightweaver_tpu_torch.ops import formal_solver2d, fused, gamma
    from lightweaver_tpu_torch.ops import prd, prd_subset, probe, sweep
    out = {'sweep': (sweep.sweep_cuda, 'launches'),
           'gamma': (gamma.line_gamma_rates_cuda, 'launches'),
           'fused': (fused.fused_cuda, 'launches'),
           'sweep_f32': (sweep.sweep_cuda, 'launches_f32'),
           'gamma_f32': (gamma.line_gamma_rates_cuda, 'launches_f32'),
           'fused_f32': (fused.fused_cuda, 'launches_f32'),
           'probe_elementwise': (probe.elementwise_cuda, 'launches'),
           'probe_recurrence': (probe.recurrence_cuda, 'launches'),
           'sweep2d': (formal_solver2d.sweep2d_cuda, 'launches'),
           'sweep2d_f32': (formal_solver2d.sweep2d_cuda, 'launches_f32'),
           'prd_scatter': (prd.prd_scatter_cuda, 'launches'),
           'prd_subset': (prd_subset.prd_subset_cuda, 'launches'),
           'prd_subset_f32': (prd_subset.prd_subset_cuda, 'launches_f32')}
    # the sweep's linear and BESSER instances
    for solver in ('piecewise_linear_1d', 'piecewise_besser_1d'):
        for dtype in (torch.float64, torch.float32):
            out[sweep_name(solver, dtype)] = (
                sweep.sweep_cuda, sweep.launch_attr(solver, dtype))
    return out


def reset_counts():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def build_kernels():
    """Build the five libraries at once (one nvcc each, in threads: the
    compiler runs outside the interpreter lock) and print ptxas's
    registers and spills, also for a cached build.  The 2D sweep's
    instances build at their first use (ops/formal_solver2d.py:
    instance_flags)."""
    from lightweaver_tpu_torch.ops import _build, fused, gamma, prd, probe
    from lightweaver_tpu_torch.ops import prd_subset, sweep
    phase('build the CUDA kernels from csrc/ (nvcc, sm_90a)')
    mods = {'probe': probe, 'sweep': sweep, 'gamma': gamma, 'fused': fused,
            'prd_scatter': prd, 'prd_subset': prd_subset}
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
            print(f'  {name} {instance_of(fn)} instance: {regs[fn]} '
                  f'registers, spill stores / loads '
                  f'{spills.get(fn, (0, 0))} bytes')
    sass_double_ops({n: mods[n] for n in ('sweep', 'gamma', 'fused')})


_MANGLED_ARGS = re.compile(r'I([df])(?:E|Li(\d+)E)')


def instance_of(fn):
    """'float64' or 'float32' from a kernel's mangled template arguments
    (<double> IdE, <double, solver> IdLi<code>E), with the sweep's solver
    (csrc/bezier3.cuh:Solver)."""
    m = _MANGLED_ARGS.search(fn)
    kind = {'d': 'float64', 'f': 'float32'}[m.group(1)]
    if m.group(2) is None:
        return kind
    return f'{short(SOLVERS[int(m.group(2))])} {kind}'


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
# float32 instances per library: the sweep's three solvers
F32_INSTANCES = {'sweep': 3, 'gamma': 1, 'fused': 1}
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
        if len(f32) != F32_INSTANCES[name]:
            raise AssertionError(f'{name}: float32 instances not found in the '
                                 f'SASS ({sorted(ops)})')
        for fn, c in sorted(f32.items()):
            print(f'  {name} {instance_of(fn)} instance: float64 '
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
    # the float32 instance on the same rows: its time and bound
    args32 = [a.float() if torch.is_tensor(a) and a.is_floating_point()
              else a for a in args]
    bnd32 = sweep_bound(args32, sweep.formal_solve_sweep(*args32))
    ms32 = min(kernel_device_ms(lambda: sweep.formal_solve_sweep(*args32),
                                SYMBOLS['sweep']))
    print(f'  PRD subset sweep, float32 instance: kernel {ms32:.4f} ms'
          f'{bound_text(bnd32)}')
    del params, rays, args, args32, plain, kern
    result['prd_scatter'] = prd_scatter_check(ctx)
    del ctx
    torch.cuda.empty_cache()
    result['prd_subset'] = prd_subset_check()
    return result


# phase 7 (b): the hybrid-PRD column batch's depths, PRD_BATCH_COLUMNS
# columns of falc_h6mg's 82 (its four PRD windows are the batch's)
PRD_BATCH_COLUMNS = 512
# max |kernel - plain| / max |plain| of rho (tests/test_torch_prd_kernel.py)
PRD_SCATTER_TOL = 1e-12


def prd_line_inputs(ctx, li, C, seed):
    """The arguments of PRD line li's scattering integral on the falc_h6mg
    Context ``ctx`` (context.scatter_rho's call of prd_scatter_rho), tiled
    over C columns, each column's qWave and J scaled by its own factor in
    U(0.95, 1.05)."""
    from lightweaver_tpu_torch import context
    from lightweaver_tpu_torch.ops import prd
    got = []

    def capture(*args):
        got.append(args)
        return prd.prd_scatter_rho(*args)
    orig, context.prd_scatter_rho = context.prd_scatter_rho, capture
    try:
        ctx._scatter_rho(li)
    finally:
        context.prd_scatter_rho = orig
    qWave, aDamp, Jw, gammaPre, Jbar = got[0]
    rng = np.random.default_rng(seed)
    Nk = qWave.shape[1]

    def scale():
        return torch.tensor(rng.uniform(0.95, 1.05, C), dtype=torch.float64,
                            device=qWave.device).repeat_interleave(Nk)
    return ((qWave.repeat(1, C) * scale()).contiguous(), aDamp.repeat(C),
            (Jw.repeat(1, C) * scale()).contiguous(), gammaPre.repeat(C),
            Jbar.repeat(C))


def prd_scatter_check(ctx):
    """Phase 7 (b): the PRD scattering kernel against its plain version at
    the hybrid-PRD column batch's shapes, line by line, with times, the
    least time and launches; returns the record of the four lines (one
    sub-iteration's integrals: times and bounds summed)."""
    from lightweaver_tpu_torch.ops import _build, prd
    from lwbench.harness import prd_work
    phase(f'PRD scattering kernel: falc_h6mg\'s PRD lines over '
          f'{PRD_BATCH_COLUMNS} columns (f64)')
    log = _build.build_log('prd_scatter')
    print(f'  ptxas: {list(ptxas_registers(log).values())} registers, '
          f'spill stores / loads {list(ptxas_spills(log).values())} bytes')
    rec = dict(max_abs_err=0.0, max_rel_err=0.0, ms=0.0, plain_ms=0.0,
               bound_ms=0.0)
    n0 = prd.prd_scatter_cuda.launches
    for li, (ai, ti, a, t) in enumerate(ctx._prd_lines()):
        args = prd_line_inputs(ctx, li, PRD_BATCH_COLUMNS, seed=li)
        W, Nk = args[0].shape
        plain = prd.prd_scatter_rho_plain(*args)
        kern = prd.prd_scatter_rho(*args)
        torch.cuda.synchronize()
        absErr = (kern - plain).abs().max().item()
        rel = absErr / plain.abs().max().item()
        work = prd_work.scatter_work([W], Nk)
        bnd = {'bound_ms': work['least_s'] * 1e3,
               'bound_by': work['bound_by']}
        # the plain version once more (0.1-0.5 s a call), the kernel in two
        # profiled rounds
        plainMs = cuda_ms(lambda: prd.prd_scatter_rho_plain(*args), 1)
        k1, k2 = kernel_device_ms(lambda: prd.prd_scatter_cuda(*args),
                                  SYMBOLS['prd_scatter'], reps=10)
        ms = min(k1, k2)
        print(f'  line {li} (levels {t.i}-{t.j} of atom {ai}, W = {W}, Nk = '
              f'{Nk}), per call: kernel {k1:.4f} / {k2:.4f} ms, plain '
              f'{plainMs:.2f} ms{bound_text(bnd)}')
        print(f'    max|kernel-plain|/max|plain| = {rel:.3e} (bar '
              f'{PRD_SCATTER_TOL}), max abs {absErr:.3e}; plain / kernel '
              f'{plainMs / ms:.1f}x, {100 * bnd["bound_ms"] / ms:.2f} % of '
              'the least time')
        if not (rel <= PRD_SCATTER_TOL and torch.isfinite(kern).all()):
            raise AssertionError(f'PRD scattering kernel, line {li}: '
                                 f'{rel} > {PRD_SCATTER_TOL}')
        rec['max_abs_err'] = max(rec['max_abs_err'], absErr)
        rec['max_rel_err'] = max(rec['max_rel_err'], rel)
        rec['ms'] += ms
        rec['plain_ms'] += plainMs
        rec['bound_ms'] += bnd['bound_ms']
        rec['bound_by'] = bnd['bound_by']
        del args, plain, kern
    print(f'  the four lines (one sub-iteration): kernel {rec["ms"]:.3f} ms, '
          f'plain {rec["plain_ms"]:.1f} ms, least {rec["bound_ms"]:.4f} ms '
          f'by {rec["bound_by"]}; {prd.prd_scatter_cuda.launches - n0} '
          'launches')
    return rec


def converge_falc_h6ca(scheme, nSteps=None, ref=None, snap=None):
    """falc_h6ca converged on the card under ``scheme``, held against the
    golden run, or with ``nSteps`` for that many MALI steps and held
    against the default scheme's snapshot ``ref`` after as many
    (GOLDEN_RTOL); ``snap`` = (steps, list) stores the state after that
    many steps.  Returns (Context, iterations, launch counts of the
    run)."""
    from lightweaver_tpu_torch import iterate_ctx_se
    from lightweaver_tpu_torch.fal import Falc82
    from lightweaver_tpu_torch.problems import h6ca_context
    ref = golden('falc_h6ca_ref') if nSteps is None else ref
    t0 = time.perf_counter()
    ctx = h6ca_context(Falc82(), 5, device='cuda')
    if scheme is not None:
        ctx.set_fs_iter_scheme(scheme)
    torch.cuda.synchronize()
    print(f'Context on {ctx.device}: Nlam={ctx.cfg.Nlam} Nmu={ctx.cfg.Nmu} '
          f'Nk={ctx.cfg.Nk}, scheme {ctx.cfg.fsIterScheme}, built in '
          f'{time.perf_counter() - t0:.2f} s')

    if snap is not None:
        snapshot_after(ctx, *snap)
    reset_counts()
    t0 = time.perf_counter()
    nIter = iterate_ctx_se(ctx, NmaxIter=nSteps or 500, quiet=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if snap is not None:
        del ctx.formal_sol_gamma_matrices
    if nSteps is not None:
        print(f'{nIter} MALI steps, {wall:.2f} s, {wall / nIter * 1e3:.3f} '
              'ms/iter; kernel launches '
              + ', '.join(f'{k} {v}' for k, v in counts.items() if v))
        against_default(f'falc_h6ca under {scheme}', ctx, ref, GOLDEN_RTOL)
        return ctx, nIter, counts

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


# the kernel schemes' falc_h6ca runs: this many MALI steps against the
# default scheme's state after as many (converged against golden until
# phase 16 needed the time)
SCHEME_STEPS = 20


def main_path():
    """falc_h6ca under the default scheme; returns the converged Context
    (the charge-conservation phase steps it on) and its state after
    SCHEME_STEPS steps."""
    phase('main path: falc_h6ca on the card vs the golden reference')
    snap = []
    ctx, nIter, counts = converge_falc_h6ca(None, snap=(SCHEME_STEPS, snap))
    if counts['sweep'] < nIter:
        raise AssertionError(f'sweep kernel launched {counts["sweep"]} '
                             f'times in {nIter} iterations')
    return ctx, snap[0]


def scheme_paths(ref):
    """falc_h6ca under each kernel scheme for SCHEME_STEPS MALI steps
    against the default scheme's state ``ref`` after as many; the launch
    counts show that the scheme's kernel ran: the line kernel once per
    iteration for all its groups, the fused kernel once per iteration and
    the sweep never."""
    for scheme in (PALLAS, FUSED):
        phase(f'scheme {scheme}: falc_h6ca on the card, {SCHEME_STEPS} MALI '
              'steps vs the default scheme')
        ctx, nIter, counts = converge_falc_h6ca(scheme, SCHEME_STEPS, ref)
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


# the kernel schemes' falc_h6mg PRD and falc_multi_ng runs: this many
# MALI steps against the default scheme's state after as many (its run
# converges against the golden file), to the golden bars; converged runs
# under each scheme until the column batch's phase needed the time (PRD:
# 40 steps until phase 17 did, 20 until phase 18); falc_multi_ng's steps
# hold its two Ng extrapolations
PRD_SCHEME_STEPS, NG_SCHEME_STEPS = 10, 60


def snapshot(ctx):
    """The populations and each PRD line's rho of ``ctx``, on the host."""
    return ([st['n'].cpu() for st in ctx.popsState],
            {(ai, ti): ctx.rhoPrd[ai][ti].cpu()
             for ai, ti, _, _ in ctx._prd_lines()})


def snapshot_after(ctx, nSteps, store):
    """Wrap ctx.formal_sol_gamma_matrices so that ``store`` gets the state
    at the end of MALI step ``nSteps`` (before step nSteps + 1);
    ``del ctx.formal_sol_gamma_matrices`` removes the wrapper."""
    fsgm, calls = ctx.formal_sol_gamma_matrices, []

    def wrapped(*args, **kwargs):
        if len(calls) == nSteps:
            store.append(snapshot(ctx))
        calls.append(1)
        return fsgm(*args, **kwargs)
    ctx.formal_sol_gamma_matrices = wrapped


def against_default(label, ctx, ref, bar):
    """The populations and rho of ``ctx`` against the default scheme's
    snapshot ``ref`` after as many steps; raises past ``bar``."""
    pops, rho = snapshot(ctx)
    errs = {f'pops_a{ai}': relerr(p, r) for ai, (p, r) in
            enumerate(zip(pops, ref[0]))}
    errs.update({f'rho_a{ai}t{ti}': relerr(r, ref[1][(ai, ti)])
                 for (ai, ti), r in rho.items()})
    print(f'{label} against the default scheme after as many steps: '
          + ', '.join(f'{k} {v:.3e}' for k, v in errs.items())
          + f' (bar {bar})')
    bad = {k: v for k, v in errs.items() if not v < bar}
    if bad:
        raise AssertionError(f'{label} differs from the default scheme: '
                             f'{bad}')


def converge_h6mg(scheme, hprd=False, nSteps=None, ref=None, snap=None):
    """falc_h6mg (PRD, or hybrid PRD with the outflow ramp) on the card
    under ``scheme`` with iterate_ctx_se(prd=True): converged and held
    against its golden run, or with ``nSteps`` for that many MALI steps
    and held against the default scheme's snapshot ``ref`` after as many
    (GOLDEN_RTOL); ``snap`` = (steps, list) stores the state after that
    many steps.  The launch counts show the path's kernels ran: the sweep
    once per MALI step (default, _pallas) and once per PRD sub-iteration
    (the subset solve, every scheme), the line kernel once per MALI step
    for all groups, the fused kernel once per MALI step.  Returns
    (Context, launch counts)."""
    from lightweaver_tpu_torch import iterate_ctx_se
    from lightweaver_tpu_torch.ops import gamma
    from lightweaver_tpu_torch.problems import h6mg_context
    name = 'hprd' if hprd else 'prd'
    phase(f'falc_h6mg {name.upper()} under {scheme}: '
          + (f'{nSteps} MALI steps on the card vs the default scheme'
             if nSteps else 'converged on the card vs the golden reference'))
    ref = golden(f'falc_h6mg_{name}_ref') if nSteps is None else ref
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

    if snap is not None:
        snapshot_after(ctx, *snap)
    reset_counts()
    t0 = time.perf_counter()
    nIter = iterate_ctx_se(ctx, NmaxIter=nSteps or 500, prd=True,
                           quiet=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    del ctx.prd_redistribute
    if snap is not None:
        del ctx.formal_sol_gamma_matrices
    nSub = sum(subIters)
    if nSteps is not None:
        print(f'{nIter} MALI steps, {wall:.2f} s, {wall / nIter * 1e3:.3f} '
              f'ms/iter, {nSub} PRD sub-iterations; kernel launches '
              + ', '.join(f'{k} {v}' for k, v in counts.items()))
        against_default(f'falc_h6mg under {scheme}', ctx, ref, GOLDEN_RTOL)
    else:
        converged_h6mg_checks(ctx, ref, hprd, nIter, wall, nSub, counts)
    sizes = [len(g) for a in ctx.activeAtoms for g in gamma.line_groups(a)]
    if scheme == PALLAS:
        print(f'line kernel: one launch per MALI step for {len(sizes)} '
              f'groups, K = {sizes}')
    expected = {
        'mali_full_precond': dict(sweep=nIter, gamma=0, fused=0),
        PALLAS: dict(sweep=nIter, gamma=nIter, fused=0),
        FUSED: dict(sweep=0, gamma=0, fused=nIter)}[scheme]
    # one scattering integral per PRD line and sub-iteration, one subset
    # kernel per sub-iteration (csrc/prd_subset.cu)
    expected['prd_scatter'] = len(ctx._prd_lines()) * nSub
    expected['prd_subset'] = nSub
    got = {k: counts[k] for k in expected}
    if got != expected or nSub < 1:
        raise AssertionError(f'launches {got}, expected {expected}')
    return ctx, counts


def converged_h6mg_checks(ctx, ref, hprd, nIter, wall, nSub, counts):
    """A converged falc_h6mg run against its golden file."""
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


def prd_paths():
    """falc_h6mg PRD converged under the default scheme, the kernel
    schemes for PRD_SCHEME_STEPS MALI steps against it, then hybrid PRD
    converged under the default scheme (the kernel schemes refuse it);
    then the stage breakdown of one PRD iteration on the default scheme's
    converged Context."""
    launches = dict.fromkeys(('sweep', 'gamma', 'fused', 'prd_scatter',
                              'prd_subset'), 0)
    snap = []
    breakdownCtx, counts = converge_h6mg(
        'mali_full_precond', snap=(PRD_SCHEME_STEPS, snap))
    for k in launches:
        launches[k] += counts[k]
    runs = [(PALLAS, False, PRD_SCHEME_STEPS),
            (FUSED, False, PRD_SCHEME_STEPS),
            ('mali_full_precond', True, None)]
    for scheme, hprd, nSteps in runs:
        ctx, counts = converge_h6mg(scheme, hprd, nSteps, snap[0])
        for k in launches:
            launches[k] += counts[k]
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


def stage_breakdown(it, params, scheme, reps=5):
    """The MALI step's stages under ``scheme`` on ``params`` (host clock,
    synchronised after each stage, mean of ``reps``), printed and returned
    in seconds."""
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
    return stages


# ---- the population-update options (float64) ---------------------------
# falc_multi_ng's bars against its golden run, the JAX package's (Ng's
# extrapolations compound rounding differences: pops ~1e-7, J/I ~3e-7)
NG_POPS_RTOL, NG_JI_RTOL = 1e-6, 3e-6
# BASELINE config 2's Ng, and the delay at which it explodes
NG_OPTIONS, NG_EARLY = (2, 5, 50), (2, 5, 10)
# the golden falc_h6ca_nr step: dC/dne, populations, ne; NR in
# stat_equil on the card against the CPU (the stat-eq and NR solves
# amplify the kernels' ~1e-12 differences of Gamma)
NR_DC_RTOL, NR_POPS_RTOL, NR_NE_RTOL = 1e-10, 1e-7, 1e-9
NR_CARD_TOL = 1e-8
# the golden falc_ca_timedep protocol: dt, steps, sub-iterations per step;
# populations per step and the final J
TD_PROTOCOL, TD_POPS_RTOL, TD_J_RTOL = (0.2, 6, 2), 1e-6, 1e-7
# the escape-probability start on the card against the CPU (the same host
# code: bit for bit expected)
ESCAPE_TOL = 1e-10


def multi_ng(ngOptions, scheme=None):
    """falc_multi_ng on the card with Ng(*ngOptions) under ``scheme``."""
    from lightweaver_tpu_torch.ops.ng import NgOptions
    from lightweaver_tpu_torch.problems import multi_ng_context
    ctx = multi_ng_context(NgOptions(*ngOptions), device='cuda')
    if scheme is not None:
        ctx.set_fs_iter_scheme(scheme)
    return ctx


def multi_ng_kernel_check():
    """(a) falc_multi_ng's inputs against the golden file; then the three
    kernels on the inputs of one iteration after 3 MALI steps with
    stat_equil (line Gamma over the three atoms' groups, Na I D1/D2 a
    K = 2 group; fused with the three atoms' slots; the sweep on the full
    grid), each against its plain version; times and bounds."""
    from lightweaver_tpu_torch.ops import sweep
    from lightweaver_tpu_torch.ops.gamma import line_groups
    phase('falc_multi_ng (BASELINE config 2: H 6 + Ca II + Na I active, '
          'Mg II passive, Ng(2, 5, 50)): inputs and kernels vs their plain '
          'versions after 3 MALI steps (f64)')
    inputs = golden('falc_multi_ng_inputs')
    ctx = multi_ng(NG_OPTIONS)
    errs = {'wavelength': relerr(ctx.spect.wavelength, inputs['wavelength']),
            'bg_chi': relerr(ctx.bgChi.cpu(), inputs['bg_chi'])}
    for ia in range(3):
        errs[f'atom{ia}_C'] = relerr(ctx.C[ia], inputs[f'atom{ia}_C'])
        errs[f'atom{ia}_n0'] = relerr(ctx.popsState[ia]['n'].cpu(),
                                      inputs[f'atom{ia}_n0'])
    print('  inputs vs golden (max relative): '
          + ', '.join(f'{k} {v:.1e}' for k, v in errs.items()))
    if not max(errs.values()) < 1e-10:
        raise AssertionError(f'falc_multi_ng inputs differ: {errs}')
    for _ in range(3):
        ctx.formal_sol_gamma_matrices()
        ctx.stat_equil()
    params = ctx.build_params()
    it = ctx._iter_fn
    scaJ = it.scaJ(params)
    chi, src = it.gather(params, scaJ)
    args = it.sweep_inputs(params, chi, src)
    plain = sweep.formal_solve_sweep_plain(*args)
    rays = sweep.formal_solve_sweep(*args)
    torch.cuda.synchronize()
    rel, absErr = compare_outputs('falc_multi_ng sweep', RAY_NAMES,
                                  ray_outputs(rays), ray_outputs(plain),
                                  KERNEL_TOL)
    print(f'  falc_multi_ng sweep (Nlam={ctx.cfg.Nlam}): max|kernel-plain|/'
          f'max|plain| = {rel:.3e} (bar {KERNEL_TOL}), max abs {absErr:.3e}')
    timed_pair('falc_multi_ng sweep, per call',
               lambda: sweep.formal_solve_sweep(*args),
               lambda: sweep.formal_solve_sweep_plain(*args),
               SYMBOLS['sweep'], bnd=sweep_bound(args, rays))
    check_line_kernel('falc_multi_ng', ctx, params, src, rays)
    C = check_fused_args('falc_multi_ng', fused_args(ctx, params, scaJ))['C']
    sizes = [[len(g) for g in line_groups(a)] for a in ctx.activeAtoms]
    naD = (0, 1) in [tuple(g) for g in line_groups(ctx.activeAtoms[2])]
    print(f'  line group sizes per atom {sizes}, Na I D1/D2 one K = 2 '
          f'group: {naD}; fused slots C = {C}')
    if not naD:
        raise AssertionError('Na I D1/D2 are not one line group')
    del ctx, params, rays, chi, src, args, plain
    torch.cuda.empty_cache()


def converge_multi_ng(scheme, nSteps=None, snap=None):
    """(a) falc_multi_ng on the card under ``scheme`` through
    iterate_ctx_se: converged, against its golden run (iterations within
    NITER_REF_SLACK of 221, populations within NG_POPS_RTOL, J and I
    within NG_JI_RTOL; the dJ and dPops histories beside the golden
    file's, with the iterations Ng extrapolated), or with ``nSteps`` for
    that many MALI steps against the default scheme's populations after
    as many (``snap``, NG_POPS_RTOL); launch counts.  Returns the counts
    and the populations after NG_SCHEME_STEPS steps."""
    phase(f'falc_multi_ng under {scheme}: '
          + (f'{nSteps} MALI steps on the card vs the default scheme'
             if nSteps else 'converged on the card vs the golden reference'))
    from lightweaver_tpu_torch import iterate_ctx_se
    ref = golden('falc_multi_ng_ref')
    ctx = multi_ng(NG_OPTIONS, scheme)
    fsgm, se = ctx.formal_sol_gamma_matrices, ctx.stat_equil
    dJ, dPops, accel, snaps = [], [], [], []

    def fs():
        if len(dJ) == NG_SCHEME_STEPS:
            snaps.append(snapshot(ctx))
        upd = fsgm()
        dJ.append(upd.dJMax)
        return upd

    def stat():
        upd = se()
        dPops.append(upd.dPopsMax)
        if upd.ngAccelerated:
            accel.append(len(dJ))
        return upd
    ctx.formal_sol_gamma_matrices, ctx.stat_equil = fs, stat
    reset_counts()
    t0 = time.perf_counter()
    nIter = iterate_ctx_se(ctx, NmaxIter=nSteps or 500, quiet=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    del ctx.formal_sol_gamma_matrices, ctx.stat_equil
    dJ = [float(x) for x in dJ]
    expected = {'mali_full_precond': dict(sweep=nIter, gamma=0, fused=0),
                PALLAS: dict(sweep=nIter, gamma=nIter, fused=0),
                FUSED: dict(sweep=0, gamma=0, fused=nIter)}[scheme]
    got = {k: counts[k] for k in expected}
    if got != expected:
        raise AssertionError(f'launches {got}, expected {expected}')
    if nSteps is not None:
        print(f'{nIter} MALI steps, {wall:.2f} s, {wall / nIter * 1e3:.3f} '
              f'ms/iter; Ng extrapolated at iterations {accel}; kernel '
              'launches ' + ', '.join(f'{k} {v}' for k, v in counts.items()))
        against_default(f'falc_multi_ng under {scheme}', ctx, snap,
                        NG_POPS_RTOL)
        if not accel:
            raise AssertionError('Ng did not extrapolate')
        return counts, None

    errs = {f'pops_a{ia}': relerr(ctx.popsState[ia]['n'].cpu(),
                                  ref[f'out_pops_a{ia}']) for ia in range(3)}
    errs['J'] = relerr(ctx.J.cpu(), ref['out_J'])
    errs['I'] = relerr(ctx.I.cpu(), ref['out_I'])
    nIterRef = int(ref['out_niter'][0])
    print(f'converged in {nIter} iterations (reference {nIterRef}); '
          f'{wall:.2f} s, {wall / nIter * 1e3:.3f} ms/iter '
          '(formal_sol_gamma_matrices + stat_equil with Ng, host clock)')
    print('max relative error vs golden: '
          + ', '.join(f'{k} {v:.3e}' for k, v in errs.items()))
    print(f'Ng extrapolated at iterations {accel}')
    refDJ, refDPops = ref['out_dJ_hist'], ref['out_dPops_hist']
    n = min(nIter, len(refDJ))
    dJRel = np.abs(np.array(dJ[:n]) / refDJ[:n] - 1.0)
    print(f'dJ history vs golden out_dJ_hist: max relative difference '
          f'{dJRel[:50].max():.2e} over iterations 1-50 (before Ng), '
          f'{dJRel.max():.2e} over 1-{n}')
    print('  iteration: dJ (golden), dPops (golden)')
    for i in list(range(0, n, 20)) + [n - 1]:
        dp = dPops[i - 3] if i >= 3 else float('nan')
        print(f'  {i + 1}: {dJ[i]:.4e} ({refDJ[i]:.4e}), {dp:.4e} '
              f'({refDPops[i]:.4e})')
    print('kernel launches over the run: '
          + ', '.join(f'{k} {v}' for k, v in counts.items())
          + f' ({nIter} formal_sol_gamma_matrices calls)')
    if abs(nIter - nIterRef) > NITER_REF_SLACK:
        raise AssertionError(f'{nIter} iterations vs reference {nIterRef}')
    bars = {k: NG_POPS_RTOL if k.startswith('pops') else NG_JI_RTOL
            for k in errs}
    bad = {k: v for k, v in errs.items() if not v < bars[k]}
    if bad or not accel:
        raise AssertionError(f'golden mismatch: {bad}; Ng extrapolations '
                             f'{accel}')
    return counts, snaps[0]


def multi_ng_early_ng_raises():
    """(a) Ng at Ndelay = 10 extrapolates falc_multi_ng's pre-asymptotic
    iterates to negative populations and the solve goes singular, in the
    compiled reference and the JAX package: ExplodingMatrixError."""
    from lightweaver_tpu_torch import ExplodingMatrixError, iterate_ctx_se
    phase('falc_multi_ng with Ng(2, 5, 10) under the default scheme: '
          'ExplodingMatrixError expected')
    ctx = multi_ng(NG_EARLY)
    calls = []
    fsgm = ctx.formal_sol_gamma_matrices

    def counted():
        calls.append(1)
        return fsgm()
    ctx.formal_sol_gamma_matrices = counted
    try:
        iterate_ctx_se(ctx, NmaxIter=500, quiet=True)
    except ExplodingMatrixError as e:
        print(f'  ExplodingMatrixError at MALI step {len(calls)}: {e}')
        return
    raise AssertionError('Ng(2, 5, 10) on falc_multi_ng did not raise')


def nr_check(ctx):
    """(b) On the main path's converged falc_h6ca: the finite-difference
    dC/dne against falc_h6ca_nr_inputs.npz, then one raw Newton-Raphson
    step (nr_post_update(stepLimit=False)) against the compiled
    reference's (falc_h6ca_nr_ref.npz).  Then charge conservation as a
    user runs it: falc_h6ca with conserveCharge=True on the card and on
    the CPU, 3 Lambda iterations and 3 MALI steps whose stat_equil runs
    the (step-limited) NR step; populations, ne and nStar card against
    CPU (NR_CARD_TOL), one sweep launch per MALI step."""
    from lightweaver_tpu_torch import Context, Falc82
    from lightweaver_tpu_torch.problems import h6ca_context
    phase('charge conservation: one raw Newton-Raphson step on the '
          'converged falc_h6ca (f64) vs the golden step, then NR in '
          'stat_equil card vs CPU')
    inputs, ref = golden('falc_h6ca_nr_inputs'), golden('falc_h6ca_nr_ref')
    dCs = ctx._fd_dC(ctx.cfg.activeAtoms, [0, 1], 1.0)
    errs = {f'dC_a{ia}': relerr(dCs[ia].cpu(), inputs[f'atom{ia}_dC'])
            for ia in range(2)}
    ne0 = ctx.atmos.ne.copy()
    t0 = time.perf_counter()
    dNe = ctx.nr_post_update(fdCollisionRates=True, stepLimit=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for ia in range(2):
        errs[f'pops_a{ia}'] = relerr(ctx.popsState[ia]['n'].cpu(),
                                     ref[f'out_nr_pops_a{ia}'])
    errs['ne'] = relerr(ctx.atmos.ne, ref['out_nr_ne'])
    print(f'  raw NR step in {wall * 1e3:.1f} ms (host clock, the dC/dne '
          f'included): dNeMax {dNe:.4e}, ne moved up to '
          f'{np.abs(ctx.atmos.ne / ne0 - 1.0).max():.3e}')
    print('  max relative error vs golden: '
          + ', '.join(f'{k} {v:.3e}' for k, v in errs.items()))
    bars = {k: NR_DC_RTOL if k.startswith('dC') else
            NR_POPS_RTOL if k.startswith('pops') else NR_NE_RTOL
            for k in errs}
    bad = {k: v for k, v in errs.items() if not v < bars[k]}
    if bad:
        raise AssertionError(f'NR step vs golden: {bad}')

    ctxs = []
    for d in ('cpu', 'cuda'):
        base = h6ca_context(Falc82(), 5, device='cpu')
        ctxs.append(Context(base.atmos, base.spect, base.eqPops,
                            conserveCharge=True, device=d))
    reset_counts()
    t0 = time.perf_counter()
    dNes = []
    for it in range(6):
        for c in ctxs:
            c.formal_sol_gamma_matrices()
        if it >= 3:
            dNes.append([c.stat_equil().dNeMax for c in ctxs])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    cpu, gpu = ctxs
    errs = {'ne': relerr(gpu.atmos.ne, cpu.atmos.ne)}
    for ia in range(2):
        errs[f'pops_a{ia}'] = relerr(gpu.popsState[ia]['n'].cpu(),
                                     cpu.popsState[ia]['n'])
        errs[f'nStar_a{ia}'] = relerr(gpu.popsState[ia]['nStar'].cpu(),
                                      cpu.popsState[ia]['nStar'])
    print('  conserveCharge=True, 3 MALI steps with NR: dNeMax card / CPU '
          + ', '.join(f'{g:.4e} / {c:.4e}' for c, g in dNes)
          + '; card vs CPU ' + ', '.join(f'{k} {v:.2e}'
                                          for k, v in errs.items())
          + f' (bar {NR_CARD_TOL}); {wall:.2f} s for both; launches sweep '
          f'{counts["sweep"]}')
    if not max(errs.values()) < NR_CARD_TOL or counts['sweep'] != 6:
        raise AssertionError(f'NR in stat_equil: card vs CPU {errs}, '
                             f'launches {counts}')


def timedep_check(scheme):
    """(c) The golden backward-Euler protocol (falc_ca_timedep: Ca II
    active, 546 wavelengths) on the card under ``scheme``: 3 Lambda
    iterations, then 6 steps of dt = 0.2 s with 2 sub-iterations each;
    populations at the end of each step and the final J against the
    compiled reference's; one kernel launch per MALI step."""
    from lightweaver_tpu_torch.problems import timedep_context
    ref = golden('falc_ca_timedep_ref')
    dt, nStep, nSub = TD_PROTOCOL
    ctx = timedep_context(device='cuda')
    ctx.set_fs_iter_scheme(scheme)
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(3):
        ctx.formal_sol_gamma_matrices()
    errs = []
    for step in range(nStep):
        prev = [st['n'] for st in ctx.popsState]
        for _ in range(nSub):
            ctx.formal_sol_gamma_matrices()
            ctx.time_dep_update(dt, prev)
        errs.append(relerr(ctx.popsState[0]['n'].cpu(),
                           ref[f'out_td_step{step}_a0']))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    jErr = relerr(ctx.J.cpu(), ref['out_J'])
    nFs = 3 + nStep * nSub
    print(f'  {scheme}: populations per step vs golden '
          + ', '.join(f'{e:.2e}' for e in errs)
          + f' (bar {TD_POPS_RTOL}); J {jErr:.2e} (bar {TD_J_RTOL}); '
          f'{wall:.2f} s for {nFs} MALI steps; launches '
          + ', '.join(f'{k} {counts[k]}' for k in ('sweep', 'gamma',
                                                   'fused')))
    if not (max(errs) < TD_POPS_RTOL and jErr < TD_J_RTOL):
        raise AssertionError(f'falc_ca_timedep under {scheme} vs golden')
    expected = {'mali_full_precond': dict(sweep=nFs, gamma=0, fused=0),
                PALLAS: dict(sweep=nFs, gamma=nFs, fused=0),
                FUSED: dict(sweep=0, gamma=0, fused=nFs)}[scheme]
    got = {k: counts[k] for k in expected}
    if got != expected:
        raise AssertionError(f'launches {got}, expected {expected}')


def escape_inputs():
    """tests/test_escape_probability.py's problem: FAL-C decimated to 30
    depths, 3 rays, H 6-level + Ca II with Ca II active."""
    from lightweaver_tpu_torch import CaII_atom, H_6_atom, RadiativeSet
    from lightweaver_tpu_torch.problems import falc_decimated
    atmos = falc_decimated(30)
    atmos.quadrature(3)
    rs = RadiativeSet([H_6_atom(), CaII_atom()])
    rs.set_active('Ca')
    spect = rs.compute_wavelength_grid()
    return atmos, spect, rs.compute_eq_pops(atmos)


def escape_check():
    """(d) The escape-probability start on the card against the CPU's
    (ESCAPE_TOL), then iterate_ctx_se on the card from it: the iteration
    count, and the sweep launched once per MALI step (the LTE start's
    convergence beside it until phase 17 needed the time: 203
    iterations against 202, PERF.md section 5)."""
    from lightweaver_tpu_torch import Context, InitialSolution
    phase('escape-probability start (30 depths, Ca II active, f64): card '
          'vs CPU, then converged from it')
    t0 = time.perf_counter()
    starts = [Context(*escape_inputs(), device=d,
                      initSol=InitialSolution.EscapeProbability)
              for d in ('cpu', 'cuda')]
    build = time.perf_counter() - t0
    err = relerr(starts[1].popsState[0]['n'].cpu(),
                 starts[0].popsState[0]['n'])
    lte = Context(*escape_inputs(), device='cuda')
    depart = (starts[1].popsState[0]['n'] / lte.popsState[0]['n']
              - 1.0).abs().max().item()
    print(f'  start populations card vs CPU: {err:.3e} (bar {ESCAPE_TOL}); '
          f'max |n/nLTE - 1| {depart:.3e}; both starts built in '
          f'{build:.2f} s')
    if not err < ESCAPE_TOL or not depart > 0.05:
        raise AssertionError(f'escape start: card vs CPU {err:.3e}, '
                             f'departure from LTE {depart:.3e}')
    iters = {}
    for name, ctx in (('escape', starts[1]),):
        nIter, updates, wall, counts = run_counted(ctx, 400)
        iters[name] = nIter
        print(f'  from the {name} start: {nIter} iterations, last dJ '
              f'{float(updates[0].dJMax):.3e}, dPops '
              f'{updates[1].dPopsMax:.3e}, {wall:.2f} s; launches sweep '
              f'{counts["sweep"]}')
        if nIter >= 400 or counts['sweep'] != nIter:
            raise AssertionError(f'from the {name} start: {nIter} '
                                 f'iterations, launches {counts}')


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


def check_sweep_f32(label, args, solver='piecewise_bezier3_1d'):
    from lightweaver_tpu_torch.ops import sweep
    args64 = upcast(args)
    kern = sweep.formal_solve_sweep(*args, solver=solver)
    plain = sweep.formal_solve_sweep_plain(*args, solver=solver)
    ref = sweep.formal_solve_sweep_plain(*args64, solver=solver)
    torch.cuda.synchronize()
    absErr = f32_rule(f'{label} sweep', RAY_NAMES, ray_outputs(kern),
                      ray_outputs(plain), ray_outputs(ref))
    j_own_products(f'{label} sweep', kern, args[6])
    bnd = sweep_bound(args, kern)
    ms, plainMs, ms64 = timed_instances(
        f'{label} sweep, per call',
        lambda: sweep.formal_solve_sweep(*args, solver=solver),
        lambda: sweep.formal_solve_sweep_plain(*args, solver=solver),
        lambda: sweep.formal_solve_sweep(*args64, solver=solver), bnd,
        SYMBOLS['sweep'])
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


# max |kernel - other| / max |other| of the PRD subset kernel's outputs
# against the sweep kernel on the plain assembly: none, the assembly
# rounded as the plain version's and the same warp scan
# (tests/test_torch_prd_subset_kernel.py); against the plain version
# KERNEL_TOL, the sweep kernel's bar
PRD_SUBSET_TOL = 0.0


def prd_subset_inputs(C, dtype=torch.float64, seed=5, device='cuda'):
    """prd_subset_sweep's arguments at the hybrid-PRD column batch's
    shapes: falc_h6mg in hybrid PRD (a 10 km/s ramp) after three MALI
    steps and a prd_redistribute, its subset solve's held terms and this
    sub-iteration's lines (context.py:build_prd_subset_fn), tiled over C
    columns, each column's chiFix, etaFix and scaJ scaled by its own
    factor in U(0.95, 1.05)."""
    from lightweaver_tpu_torch import H_6_atom, MgII_atom, RadiativeSet
    from lightweaver_tpu_torch.context import Context
    from lightweaver_tpu_torch.problems import Falc82, vlos_ramp
    atmos = vlos_ramp(Falc82(), 1e4)
    atmos.quadrature(5)
    rs = RadiativeSet([H_6_atom(), MgII_atom()])
    rs.set_active('H', 'Mg')
    ctx = Context(atmos, rs.compute_wavelength_grid(),
                  rs.compute_eq_pops(atmos), hprd=True, device=device)
    for _ in range(3):
        ctx.formal_sol_gamma_matrices()
        ctx.stat_equil()
    ctx.prd_redistribute()
    fs = ctx._prd_subset_fn()
    params = ctx.build_params()
    chiFix, etaFix, scaJ, lines, height, muz, wmu, upper, lower, solver = \
        fs.kernel_args(params, fs.subset_terms(params))
    rng = np.random.default_rng(seed)
    Nk = ctx.cfg.Nk

    def scale():
        return torch.tensor(rng.uniform(0.95, 1.05, C), dtype=torch.float64,
                            device=device).repeat_interleave(Nk)

    def tile(x, f=None):
        if x is None:
            return None
        y = x.repeat(*([1] * (x.dim() - 1)), C)
        if f is not None:
            y = y * f
        return (y.to(dtype) if y.is_floating_point() else y).contiguous()

    def bc(b):
        kind, rows = b
        if kind == 'data':
            rows = rows[..., None].expand(*rows.shape, C)
        elif kind == 'therm':
            rows = rows[:, None, :].expand(rows.shape[0], C, 2)
        return kind, None if rows is None else rows.to(dtype).contiguous()
    lines = [L._replace(Vij=tile(L.Vij), nj=tile(L.nj), rho=tile(L.rho),
                        i0=tile(L.i0), frac=tile(L.frac)) for L in lines]
    return (tile(chiFix, scale()), tile(etaFix, scale()), tile(scaJ, scale()),
            lines, height.to(dtype).repeat(C, 1).contiguous(), muz.to(dtype),
            wmu.to(dtype), bc(upper), bc(lower), solver)


def prd_subset_check():
    """Phase 7 (c): the PRD subset kernel (csrc/prd_subset.cu) against the
    sweep kernel on the plain assembly and against the plain version at
    the hybrid-PRD column batch's shapes (PRD_BATCH_COLUMNS columns of
    falc_h6mg in hybrid PRD), with the kernel's and the plain version's
    times, the least time (bytes read and written once at 3.35 TB/s),
    ptxas' registers and spills, the launches, and the float32
    instance's time."""
    from lightweaver_tpu_torch.ops import _build, prd_subset
    from lightweaver_tpu_torch.ops import sweep
    phase(f'PRD subset kernel: falc_h6mg hybrid PRD\'s subset rows over '
          f'{PRD_BATCH_COLUMNS} columns (f64)')
    log = _build.build_log('prd_subset')
    regs, spills = ptxas_registers(log), ptxas_spills(log)
    for fn in sorted(regs):
        print(f'  ptxas {instance_of(fn)}: {regs[fn]} registers, spill '
              f'stores / loads {spills.get(fn, (0, 0))} bytes')
    args = prd_subset_inputs(PRD_BATCH_COLUMNS)
    chiFix, lines = args[0], args[3]
    n0 = prd_subset.prd_subset_cuda.launches
    kern = prd_subset.prd_subset_sweep(*args)
    torch.cuda.synchronize()
    if prd_subset.prd_subset_cuda.launches != n0 + 1:
        raise AssertionError('the PRD subset solve did not launch its kernel')
    names = ('I', 'J', 'PsiBar', 'IeffSrcBar')

    def outs(I, m):
        return [I] + [m[k] for k in names[1:]]
    sw = sweep.formal_solve_sweep(*prd_subset.sweep_args(*args[:9]))
    plain = prd_subset.prd_subset_sweep_plain(*args)
    relSw, _ = compare_outputs('PRD subset vs sweep kernel', names,
                               outs(*kern), outs(sw[0], sw[3]),
                               PRD_SUBSET_TOL)
    rel, absErr = compare_outputs('PRD subset vs plain', names, outs(*kern),
                                  outs(*plain), KERNEL_TOL)
    cover = torch.zeros(chiFix.shape[1], dtype=torch.int64)
    for L in lines:
        cover[L.s0:L.s0 + L.Vij.shape[1]] += 1
    print(f'  {chiFix.shape[1]} subset rows x {chiFix.shape[2]} rays x '
          f'{chiFix.shape[3]} depths, {len(lines)} PRD lines (rows covered '
          f'by two: {int((cover == 2).sum())}): max|kernel-sweep|/max|sweep| '
          f'= {relSw:.3e} (bar {PRD_SUBSET_TOL}), max|kernel-plain|/'
          f'max|plain| = {rel:.3e} (bar {KERNEL_TOL}), max abs {absErr:.3e}')
    del sw, plain
    ins = [x for x in args if torch.is_tensor(x)] + [
        x for L in lines for x in (L.Vij, L.rho, L.i0, L.frac, L.nj)] + [
        b[1] for b in args[7:9]]
    I, m = kern
    bnd = bound(nbytes(ins + [I] + [m[k] for k in names[1:]]),
                SWEEP_FLOPS * chiFix.numel(), chiFix.dtype)
    ms, plainMs = timed_pair('PRD subset kernel, per call',
                             lambda: prd_subset.prd_subset_sweep(*args),
                             lambda: prd_subset.prd_subset_sweep_plain(*args),
                             SYMBOLS['prd_subset'], reps=5, bnd=bnd)
    share = 100 * bnd['bound_ms'] / ms
    print(f'  plain / kernel {plainMs / ms:.1f}x, {share:.2f} % of the '
          'least time')
    del kern, I, m
    args32 = prd_subset_inputs(PRD_BATCH_COLUMNS, torch.float32)
    ms32 = min(kernel_device_ms(lambda: prd_subset.prd_subset_sweep(*args32),
                                SYMBOLS['prd_subset'], reps=5))
    I32, m32 = prd_subset.prd_subset_sweep(*args32)
    bnd32 = bound(nbytes([x for x in args32 if torch.is_tensor(x)] + [
        x for L in args32[3] for x in (L.Vij, L.rho, L.i0, L.frac, L.nj)]
        + [b[1] for b in args32[7:9]] + [I32] + list(m32.values())),
        SWEEP_FLOPS * I32.numel(), torch.float32)
    print(f'  float32 instance: kernel {ms32:.4f} ms{bound_text(bnd32)}')
    del args, args32, I32, m32
    torch.cuda.empty_cache()
    return dict(max_abs_err=absErr, max_rel_err=rel, ms=ms,
                plain_ms=plainMs, ms_f32=ms32, **bnd)


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


def converge_mixed(scheme, nSteps=None):
    """(b) The mixed-precision problem (tests/test_mixed_precision.py's) in
    float32 under ``scheme`` through iterate_ctx_se; fewer than 600
    iterations required (the JAX float32 state: 408 on the CPU).  With
    ``nSteps`` (the kernel schemes, since phase 17 needed the time) that
    many MALI steps, finite and contracting (the last dJ below the fifth
    step's)."""
    from lightweaver_tpu_torch.problems import mixed_precision_context
    ctx = mixed_precision_context(device='cuda', dtype=F32)
    ctx.set_fs_iter_scheme(scheme)
    if nSteps is not None:
        dJ, fsgm = [], ctx.formal_sol_gamma_matrices

        def tracked():
            u = fsgm()
            dJ.append(float(u.dJMax))
            return u
        ctx.formal_sol_gamma_matrices = tracked
    nIter, updates, wall, counts = run_counted(ctx, nSteps or 600)
    print(f'  mixed-precision problem under {scheme}: {nIter} iterations '
          f'(bar {"< 600" if nSteps is None else "contracting"}), last dJ '
          f'{float(updates[0].dJMax):.3e}, dPops '
          f'{updates[1].dPopsMax:.3e}, {wall:.2f} s; float32 launches '
          + ', '.join(f'{k} {counts[k]}' for k in F32_NAMES))
    if nSteps is None and not nIter < 600:
        raise AssertionError(f'the mixed-precision problem did not converge '
                             f'under {scheme} in {nIter} iterations')
    if nSteps is not None and not (np.isfinite(dJ).all()
                                   and dJ[-1] < dJ[4]):
        raise AssertionError(f'{scheme} float32: dJ {dJ}')
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
# (c)'s iterations (230, past the 211 in which the float64 state
# converges, until phase 17 needed the time; the emergent spectrum is
# inside its envelope long before either)
F32_FULL_ITERS = 60


def falc_h6ca_f32(scheme):
    """(c) falc_h6ca at full width with a float32 state under ``scheme``,
    iterate_ctx_se with NmaxIter = F32_FULL_ITERS; the float32 state does
    not converge there (nor does the JAX package's), so the checks are its
    envelope: finite, and the emergent spectrum within the bars above.
    Returns the launch counts of the run."""
    from lightweaver_tpu_torch.fal import Falc82
    from lightweaver_tpu_torch.problems import h6ca_context
    ref = golden('falc_h6ca_ref')
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


# ---- spectrum synthesis (phase 12) -------------------------------------
SOLVERS = ('piecewise_linear_1d', 'piecewise_bezier3_1d',
           'piecewise_besser_1d')
BEZIER3 = 'piecewise_bezier3_1d'
# falc_h6ca's iterations to converge under each 1D solver with the JAX
# package on the CPU in float64 (scripts/jax_solver_iterations.py)
JAX_SOLVER_ITERS = {'piecewise_linear_1d': 349, 'piecewise_bezier3_1d': 211,
                    'piecewise_besser_1d': 214}
# compute_rays on the card against the same state on the CPU: the sweep
# kernel against its plain version along one ray per wavelength
RAYS_TOL = 1e-9
# BASELINE config 4 against its golden run, amplitude-normalised: the bars
# of tests/test_vs_reference_golden.py:181-255 (profiles stored float32)
STOKES_PROFILE_TOL, STOKES_I_TOL, STOKES_QUV_TOL = 1e-5, 1e-6, 1e-3
# the Stokes solve (torch ops) on the card against the CPU
STOKES_CARD_TOL = 1e-9
# a pickled and resumed run against the uninterrupted one
# (tests/test_pickle_context.py's bar)
PICKLE_RTOL = 5e-12


def sweep_name(solver, dtype):
    """The kernels' record name of the sweep instance for ``solver`` and
    ``dtype``: sweep, sweep_f32, sweep_linear, sweep_besser_f32, ..."""
    from lightweaver_tpu_torch.ops.sweep import launch_attr
    return 'sweep' + launch_attr(solver, dtype)[len('launches'):]


def short(solver):
    return solver.split('_')[1]


def amperr(ours, ref):
    """max |ours - ref| / max |ref| (signed Stokes profiles cross zero)."""
    ours = np.asarray(ours, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def cpu_twin(ctx):
    """A Context on the CPU from ``ctx``'s state dict."""
    from lightweaver_tpu_torch.context import Context
    state = ctx.state_dict()
    state['kwargs'] = dict(state['kwargs'], device='cpu')
    return Context.construct_from_state_dict_with(state)


def readme_rays(ctx):
    """(a) The README program's last call on phase 5's converged falc_h6ca:
    compute_rays over 1001 wavelengths of Ca II K at mu = 1 on the card
    (one launch of the sweep kernel: the ray Context's formal_sol),
    against the same state's compute_rays on the CPU."""
    phase('synthesis (a): the README program on the card: compute_rays('
          'np.linspace(392.5, 394.5, 1001), mus=[1.0]) on the converged '
          'falc_h6ca vs the same state on the CPU')
    lam = np.linspace(392.5, 394.5, 1001)
    reset_counts()
    t0 = time.perf_counter()
    I = ctx.compute_rays(wavelengths=lam, mus=[1.0])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    t0 = time.perf_counter()
    Iref = cpu_twin(ctx).compute_rays(wavelengths=lam, mus=[1.0])
    cpuMs = (time.perf_counter() - t0) * 1e3
    err = amperr(I, Iref)
    pointwise = float((np.abs(I - Iref) / np.abs(Iref)).max())
    print(f'  I {I.shape}: max |card - CPU| / max |CPU| {err:.3e} (bar '
          f'{RAYS_TOL}), pointwise {pointwise:.3e}; compute_rays {ms:.1f} ms '
          f'on the card (a new Context over the 1001 wavelengths and its '
          f'formal_sol; host clock), {cpuMs:.1f} ms on the CPU twin (its '
          f'build included); sweep launches {counts["sweep"]}, the core '
          f'at {lam[np.argmin(I[:, 0])]:.4f} nm')
    if I.shape != (1001, 1) or not np.isfinite(I).all():
        raise AssertionError(f'compute_rays gave {I.shape}, finite '
                             f'{np.isfinite(I).all()}')
    if counts['sweep'] != 1 or sum(counts.values()) != 1:
        raise AssertionError(f'compute_rays launched {counts}')
    if not err <= RAYS_TOL:
        raise AssertionError(f'compute_rays card vs CPU {err:.3e}')
    return ms


def check_solver_f64(label, solver, args):
    """The float64 instance of ``solver`` against its plain version
    (KERNEL_TOL), with times and the bound."""
    from lightweaver_tpu_torch.ops import sweep
    kern = sweep.formal_solve_sweep(*args, solver=solver)
    plain = sweep.formal_solve_sweep_plain(*args, solver=solver)
    torch.cuda.synchronize()
    rel, absErr = compare_outputs(f'{label} {short(solver)}', RAY_NAMES,
                                  ray_outputs(kern), ray_outputs(plain),
                                  KERNEL_TOL)
    print(f'  {label} {short(solver)} float64: max|kernel-plain|/max|plain| '
          f'= {rel:.3e} (bar {KERNEL_TOL}), max abs {absErr:.3e}')
    bnd = sweep_bound(args, kern)
    ms, plainMs = timed_pair(
        f'{label} {short(solver)} float64, per call',
        lambda: sweep.formal_solve_sweep(*args, solver=solver),
        lambda: sweep.formal_solve_sweep_plain(*args, solver=solver),
        SYMBOLS['sweep'], bnd=bnd)
    return dict(max_abs_err=absErr, ms=ms, plain_ms=plainMs, **bnd)


def solver_kernel_check():
    """(b) Every sweep instance (three solvers, two precisions) against its
    plain version: on falc_h6ca's inputs after one MALI step (the records
    of the kernels' JSON line) and, for the linear and BESSER solvers, on
    FALC-500 random rays (Bezier-3's: phases 3 and 10); float64 by
    KERNEL_TOL, float32 by the rule of f32_rule and J against its own
    products.  Returns falc_h6ca's records."""
    from lightweaver_tpu_torch.problems import random_rays
    phase('synthesis (b): the sweep kernel per solver and precision vs its '
          f'plain version (float64 bar {KERNEL_TOL}; float32: err(kernel '
          f'f32, plain f64) <= {F32_SLACK} err(plain f32, plain f64) + '
          f'{F32_FLOOR})')
    ctx, params, scaJ, src, _ = one_iteration_inputs(82)
    chi, src = ctx._iter_fn.gather(params, scaJ)
    args82 = list(ctx._iter_fn.sweep_inputs(params, chi, src))
    rays = random_rays(1046, 5, 500, seed=500)
    args500 = [torch.tensor(rays[k], dtype=torch.float64, device='cuda')
               for k in ('chi', 'srcNum', 'height', 'muz', 'IupwD', 'IupwU',
                         'wmu')]
    records = {}
    for solver in SOLVERS:
        cases = [('falc_h6ca', args82)]
        if solver != BEZIER3:
            cases.append(('FALC-500 random rays', args500))
        for label, args in cases:
            r64 = check_solver_f64(label, solver, args)
            r32 = check_sweep_f32(f'{label} {short(solver)}',
                                  [a.float() for a in args], solver)
            if label == 'falc_h6ca':
                records[sweep_name(solver, torch.float64)] = r64
                records[sweep_name(solver, F32)] = r32
    del ctx, params, chi, src, args82, args500
    torch.cuda.empty_cache()
    return records


def converge_solver(solver, nSteps=None):
    """(c) falc_h6ca converged on the card under ``solver`` (default
    scheme, float64): its iterations within NITER_REF_SLACK of the JAX
    package's (JAX_SOLVER_ITERS) and the emergent spectrum beside the
    golden (Bezier-3) one; every launch the solver's float64 instance.
    With ``nSteps``, that many MALI steps (stat_equil from the fourth),
    finite and contracting (the last dJ below the fifth step's).
    Returns the run's launches of it."""
    from lightweaver_tpu_torch import iterate_ctx_se
    from lightweaver_tpu_torch.fal import Falc82
    from lightweaver_tpu_torch.problems import h6ca_context
    phase(f'synthesis (c): falc_h6ca under {solver} (default scheme, f64): '
          + ('converged on the card' if nSteps is None
             else f'{nSteps} MALI steps on the card'))
    ctx = h6ca_context(Falc82(), 5, device='cuda')
    ctx.set_formal_solver(solver)
    reset_counts()
    t0 = time.perf_counter()
    dJ = []
    if nSteps is None:
        nIter = iterate_ctx_se(ctx, NmaxIter=500, quiet=True)
    else:
        for it in range(nSteps):
            dJ.append(float(ctx.formal_sol_gamma_matrices().dJMax))
            if it >= 3:
                ctx.stat_equil()
        nIter = nSteps
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    name = sweep_name(solver, torch.float64)
    ref = golden('falc_h6ca_ref')
    dI = relerr(ctx.I.cpu(), ref['out_I'])
    print(f'  {nIter} iterations (the JAX package on the CPU: '
          f'{JAX_SOLVER_ITERS[solver]}; Bezier-3: 211); {wall:.2f} s, '
          f'{wall / nIter * 1e3:.3f} ms/iter; emergent I vs the golden '
          f'Bezier-3 spectrum: max relative {dI:.3e}; launches '
          + ', '.join(f'{k} {v}' for k, v in counts.items() if v)
          + (f'; dJ {dJ[4]:.3e} at step 5, {dJ[-1]:.3e} at the last'
             if dJ else ''))
    if nSteps is None and abs(nIter - JAX_SOLVER_ITERS[solver]) \
            > NITER_REF_SLACK:
        raise AssertionError(f'{solver}: {nIter} iterations vs the JAX '
                             f'package\'s {JAX_SOLVER_ITERS[solver]}')
    if nSteps is not None and not (np.isfinite(dJ).all()
                                   and dJ[-1] < dJ[4]):
        raise AssertionError(f'{solver}: dJ {dJ}')
    others = {k: v for k, v in counts.items() if v and k != name}
    if counts[name] < nIter or others:
        raise AssertionError(f'{solver}: launches {counts}')
    if not torch.isfinite(ctx.I).all():
        raise AssertionError('non-finite emergent intensity')
    return counts[name]


# (c)'s float32 runs: MALI steps of the mixed-precision problem
F32_SOLVER_STEPS = 40
# (c)'s linear and BESSER falc_h6ca runs: MALI steps (converged in the
# JAX package's 349 and 214 iterations until phases 17 and 18 needed the
# time)
LINEAR_STEPS = 60


def solver_steps_f32(solver):
    """(c) The mixed-precision problem in float32 under ``solver`` (default
    scheme): F32_SOLVER_STEPS MALI steps with stat_equil from the fourth,
    finite and contracting (the last dJ below the fifth step's), every
    sweep launch the solver's float32 instance (its kernel against the
    plain version: (b)).  Returns the run's launches of it."""
    from lightweaver_tpu_torch.problems import mixed_precision_context
    ctx = mixed_precision_context(device='cuda', dtype=F32)
    ctx.set_formal_solver(solver)
    reset_counts()
    t0 = time.perf_counter()
    dJ = []
    for it in range(F32_SOLVER_STEPS):
        dJ.append(float(ctx.formal_sol_gamma_matrices().dJMax))
        if it >= 3:
            ctx.stat_equil()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    name = sweep_name(solver, F32)
    print(f'  mixed-precision problem in float32 under {solver}: '
          f'{F32_SOLVER_STEPS} MALI steps, dJ {dJ[4]:.3e} at step 5, '
          f'{dJ[-1]:.3e} at the last; {wall:.2f} s; launches '
          + ', '.join(f'{k} {v}' for k, v in counts.items() if v))
    if not (np.isfinite(dJ).all() and dJ[-1] < dJ[4]
            and torch.isfinite(ctx.I).all()):
        raise AssertionError(f'{solver} float32: dJ {dJ}')
    others = {k: v for k, v in counts.items() if v and k != name}
    if counts[name] != F32_SOLVER_STEPS or others:
        raise AssertionError(f'{solver} float32: launches {counts}')
    return counts[name]


def stokes_golden():
    """(d) BASELINE config 4 (falc_h6ca in a 0.1 T field at gamma = pi/3,
    chi = pi/6) converged on the card under the fused scheme, the fastest
    (iterations, populations: the field does not enter the MALI step), and
    its
    polarised profiles and full-Stokes solve (single_stokes_fs with
    updateJ) against the golden run, tests/test_vs_reference_golden.py's
    bars; the single_stokes_fs ms; then compute_rays(stokes=True) over Ca
    II 854.2 nm, card against the same state on the CPU."""
    from lightweaver_tpu_torch import iterate_ctx_se
    from lightweaver_tpu_torch.problems import stokes_context
    phase('synthesis (d): BASELINE config 4 (falc_h6ca, B = 0.1 T, gamma = '
          f'pi/3, chi = pi/6) converged on the card under {FUSED} vs the '
          'golden reference, single_stokes_fs, compute_rays(stokes=True)')
    ref = golden('falc_h6ca_stokes_ref')
    ctx = stokes_context(device='cuda')
    ctx.set_fs_iter_scheme(FUSED)
    reset_counts()
    t0 = time.perf_counter()
    nIter = iterate_ctx_se(ctx, NmaxIter=500, quiet=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    nIterRef = int(ref['out_niter'][0])
    pops = {ia: relerr(ctx.popsState[ia]['n'].cpu(), ref[f'out_pops_a{ia}'])
            for ia in range(2)}
    print(f'  converged in {nIter} iterations (reference {nIterRef}); '
          f'{wall:.2f} s; pops vs golden '
          + ', '.join(f'a{k} {v:.3e}' for k, v in pops.items())
          + f' (bar {GOLDEN_RTOL}); {FUSED} launches {counts["fused"]}')
    if abs(nIter - nIterRef) > NITER_REF_SLACK:
        raise AssertionError(f'{nIter} iterations vs reference {nIterRef}')
    if not all(v < GOLDEN_RTOL for v in pops.values()):
        raise AssertionError(f'BASELINE config 4 pops vs golden: {pops}')
    ctx.compute_polarised_profiles()
    worst, nLines = 0.0, 0
    for ai, a in enumerate(ctx.activeAtoms):
        for ti in range(len(a.trans)):
            p7 = ctx.phi7[ai][ti]
            if p7 is None:
                continue
            nLines += 1
            tag = f'a{ai}t{ti}'
            for name, key in (('phi', f'out_phi_pol_{tag}'),
                              ('phiQ', f'out_phiQ_{tag}'),
                              ('phiV', f'out_phiV_{tag}'),
                              ('psiQ', f'out_psiQ_{tag}')):
                e = amperr(p7[name].cpu(), ref[key])
                worst = max(worst, e)
                if not e < STOKES_PROFILE_TOL:
                    raise AssertionError(f'{name} {tag} vs golden {e:.3e}')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx.single_stokes_fs(recompute=True, updateJ=True)
    torch.cuda.synchronize()
    firstMs = (time.perf_counter() - t0) * 1e3
    errI = amperr(ctx.I.cpu(), ref['out_I_stokes'])
    errQuv = [amperr(ctx.Quv[n].cpu(), ref['out_Quv'][n]) for n in range(3)]
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        ctx.single_stokes_fs()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    print(f'  polarised profiles of {nLines} lines vs golden: worst '
          f'{worst:.3e} (bar {STOKES_PROFILE_TOL}); single_stokes_fs('
          f'recompute=True, updateJ=True): I {errI:.3e} (bar {STOKES_I_TOL}),'
          f' Q/U/V ' + ' / '.join(f'{e:.3e}' for e in errQuv)
          + f' (bar {STOKES_QUV_TOL}), amplitude-normalised; '
          f'{firstMs:.1f} ms with the profiles, single_stokes_fs() '
          f'{ms:.1f} ms (mean of {reps}; Nlam x Nmu = '
          f'{ctx.cfg.Nlam} x {ctx.cfg.Nmu} rays, {ctx.cfg.Nk} depths; host '
          'clock)')
    if nLines != 5 or not (errI < STOKES_I_TOL
                           and max(errQuv) < STOKES_QUV_TOL):
        raise AssertionError(f'Stokes vs golden: {nLines} lines, I {errI}, '
                             f'QUV {errQuv}')
    lam = np.linspace(853.9, 855.0, 161)
    t0 = time.perf_counter()
    iquv = ctx.compute_rays(wavelengths=lam, mus=[1.0], stokes=True)
    raysMs = (time.perf_counter() - t0) * 1e3
    ref4 = cpu_twin(ctx).compute_rays(wavelengths=lam, mus=[1.0],
                                      stokes=True)
    errs = [amperr(iquv[s], ref4[s]) for s in range(4)]
    print(f'  compute_rays(stokes=True) over 161 wavelengths at mu = 1: '
          f'{raysMs:.1f} ms; card vs CPU I/Q/U/V '
          + ' / '.join(f'{e:.3e}' for e in errs)
          + f' (bar {STOKES_CARD_TOL}); |V| max / I max '
          f'{np.abs(iquv[3]).max() / iquv[0].max():.3e}')
    if iquv.shape != (4, 161, 1) or not max(errs) <= STOKES_CARD_TOL:
        raise AssertionError(f'compute_rays(stokes=True): {iquv.shape}, '
                             f'{errs}')
    return ms


def pickle_check():
    """(e) falc_h6ca (f64, default scheme): 12 MALI steps, pickle, load on
    the card, 18 more; the populations and J against an uninterrupted
    30-step run (PICKLE_RTOL)."""
    import pickle

    from lightweaver_tpu_torch.fal import Falc82
    from lightweaver_tpu_torch.problems import h6ca_context
    phase('synthesis (e): falc_h6ca pickled at MALI step 12 and resumed on '
          'the card vs an uninterrupted run of 30 steps')

    def iterate(ctx, n, start=0):
        for it in range(start, start + n):
            ctx.formal_sol_gamma_matrices()
            if it >= 3:
                ctx.stat_equil()
    ref = h6ca_context(Falc82(), 5, device='cuda')
    iterate(ref, 30)
    half = h6ca_context(Falc82(), 5, device='cuda')
    iterate(half, 12)
    t0 = time.perf_counter()
    blob = pickle.dumps(half)
    resumed = pickle.loads(blob)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    same = (torch.equal(resumed.J, half.J)
            and all(torch.equal(a['n'], b['n']) for a, b in
                    zip(resumed.popsState, half.popsState)))
    iterate(resumed, 18, start=12)
    torch.cuda.synchronize()
    errs = [float(((a['n'] - b['n']).abs() / b['n'].abs()).max())
            for a, b in zip(resumed.popsState, ref.popsState)]
    errJ = float(((resumed.J - ref.J).abs() / ref.J.abs()
                  .clamp(min=1e-300)).max())
    print(f'  pickle {len(blob) / 1e6:.2f} MB, dumps + loads {ms:.1f} ms; '
          f'resumed on {resumed.device}, state equal {same}; after 30 '
          'steps pops ' + ', '.join(f'{e:.2e}' for e in errs)
          + f', J {errJ:.2e} (bar {PICKLE_RTOL})')
    if not (same and resumed.J.is_cuda and max(errs) <= PICKLE_RTOL
            and errJ <= PICKLE_RTOL):
        raise AssertionError('the pickled Context does not resume as the '
                             'uninterrupted run')


# ---- the 1.5D column batch (phase 13) ----------------------------------
# BASELINE config 5's 1.5D leg: FAL-C columns, H 6-level + Ca II active,
# 5 rays, 1046 wavelengths, float64, the default scheme
# (512 until phase 17 needed the time, 256 until phase 18)
BATCH_C = 128
# (a)'s batch: one iteration's inputs of this many of (b)'s columns
BATCH_KERNEL_C = 64
BATCH_SEED = 1
# (b)'s re-run columns against single Contexts; (c)'s schemes against the
# default one over BATCH_SCHEME_STEPS free-running steps (the stat-eq
# solve amplifies the schemes' ~1e-11 differences of Gamma 40-100x at
# every step, as tests/test_torch_slice.py's 1e-9 bar on the populations
# says: 1.25e-10 after 20 steps of 8 columns on the CPU); (d)'s PRD
# columns against single Contexts in lockstep
BATCH_SINGLE_TOL = 1e-9
# (b)'s columns re-run as single Contexts: the slowest, and this many
# less one chosen with the seed (3 until phase 16 needed the time), for
# this many iterations against the batch's state after as many (their
# nIterCol iterations, with the freeze, until phase 16 needed the time)
BATCH_SINGLE_COLUMNS = 1
BATCH_SINGLE_STEPS = 60
BATCH_SCHEME_TOL = 1e-9
BATCH_SCHEME_STEPS, BATCH_F32_STEPS = 10, 10
BATCH_PRD_C, BATCH_PRD_STEPS, BATCH_PRD_TOL = 32, 20, 1e-8


def column_slice(x, c, Nc):
    return x[..., c * Nc:(c + 1) * Nc]


def one_column_args(args, c, Nc, kind):
    """The single-column arguments (height [Nc], boundaries without the
    column axis) of column c of a batch's sweep or fused arguments."""
    if kind == 'sweep':
        chi, src, h, muz, Iu, Il, wmu = args
        return (column_slice(chi, c, Nc).contiguous(),
                column_slice(src, c, Nc).contiguous(), h[c].contiguous(),
                muz, Iu[..., c].contiguous(), Il[..., c].contiguous(), wmu)
    out = [column_slice(x, c, Nc).contiguous() for x in args[:6]]
    out += [args[6][c].contiguous(), args[7], args[8]]
    for bcKind, rows in args[9:]:
        out.append((bcKind, None if rows is None else (
            rows[..., c] if bcKind == 'data' else rows[:, c]).contiguous()))
    return out


def columns_bitwise(label, fn, args, C, Nc, kind):
    """Each of the first, middle and last columns of the batch launch
    equals the launch on that column alone, bit for bit."""
    out = ray_outputs(fn(*args))
    for c in sorted({0, C // 2, C - 1}):
        one = ray_outputs(fn(*one_column_args(args, c, Nc, kind)))
        for n, a, b in zip(RAY_NAMES, out, one):
            if not torch.equal(column_slice(a, c, Nc), b):
                raise AssertionError(f'{label}: column {c} of the batch '
                                     f'launch differs from its own launch '
                                     f'on {n}')
    print(f'  {label}: columns 0, {C // 2}, {C - 1} of the {C}-column '
          'launch equal their single-column launches bit for bit')


def batch_inputs(C, dtype):
    """A column batch of C columns on the card after one MALI step and
    stat_equil, its params, scaJ, srcNum and the rays of one step."""
    from lightweaver_tpu_torch.problems import column_batch
    b = column_batch(C, seed=BATCH_SEED, device='cuda', dtype=dtype)
    b.formal_sol_gamma_matrices()
    b.stat_equil()
    params = b.params
    it = b._iter_fn
    scaJ = it.scaJ(params)
    chi, src = it.gather(params, scaJ)
    return b, params, scaJ, chi, src


def batch_kernel_check():
    """(a) The kernels at the batch shape: one iteration's inputs of
    BATCH_KERNEL_C columns of (b)'s batch, each kernel against its plain
    version (float64 within KERNEL_TOL / GAMMA_TOL, float32 by phase 10's
    rule), with device times and bounds; each column of the sweep and
    fused launches bit for bit its own single-column launch."""
    from lightweaver_tpu_torch.ops import fused, sweep
    C = BATCH_KERNEL_C
    phase(f'column batch (a): the kernels at the batch shape, {C} columns '
          'of 82 depths in one launch, against their plain versions')
    b, params, scaJ, chi, src = batch_inputs(C, torch.float64)
    Nc = b.NkCol
    it = b._iter_fn
    args = it.sweep_inputs(params, chi, src)
    label = f'{C} columns f64'
    kern = sweep.formal_solve_sweep(*args)
    plain = sweep.formal_solve_sweep_plain(*args)
    torch.cuda.synchronize()
    rel, absErr = compare_outputs(label, RAY_NAMES, ray_outputs(kern),
                                  ray_outputs(plain), KERNEL_TOL)
    print(f'  {label} sweep: max|kernel-plain|/max|plain| = {rel:.3e} '
          f'(bar {KERNEL_TOL}), max abs {absErr:.3e}')
    timed_pair(f'{label} sweep, per call', lambda: sweep.formal_solve_sweep(
        *args), lambda: sweep.formal_solve_sweep_plain(*args),
        SYMBOLS['sweep'], bnd=sweep_bound(args, kern))
    columns_bitwise(f'{label} sweep', sweep.formal_solve_sweep, args, C, Nc,
                    'sweep')
    rays = it.formal_solve(params, chi, src)
    check_line_kernel(label, b, params, src, rays)
    fargs = fused_args(b, params, scaJ)
    check_fused_args(label, fargs)
    columns_bitwise(f'{label} fused', fused.fused_lambda_step, fargs, C, Nc,
                    'fused')
    del b, params, chi, src, rays, args, fargs, kern, plain
    torch.cuda.empty_cache()

    b, params, scaJ, chi, src = batch_inputs(C, F32)
    it = b._iter_fn
    label = f'{C} columns f32'
    args = it.sweep_inputs(params, chi, src)
    check_sweep_f32(label, args)
    columns_bitwise(f'{label} sweep', sweep.formal_solve_sweep, args, C, Nc,
                    'sweep')
    rays = it.formal_solve(params, chi, src)
    check_line_f32(label, b, params, src, rays)
    fargs = fused_args(b, params, scaJ)
    check_fused_f32_args(label, fargs)
    columns_bitwise(f'{label} fused', fused.fused_lambda_step, fargs, C, Nc,
                    'fused')
    del b, params, chi, src, rays, args, fargs
    torch.cuda.empty_cache()


def single_column_context(c, **kwargs):
    """A card Context of column c of the batch of problems.column_batch
    (seed BATCH_SEED), built from the same stacked arrays."""
    from lightweaver_tpu_torch import (Atmosphere, CaII_atom, H_6_atom,
                                       RadiativeSet)
    from lightweaver_tpu_torch.context import Context
    from lightweaver_tpu_torch.problems import stacked_falc
    models = kwargs.pop('models', lambda: [H_6_atom(), CaII_atom()])
    active = kwargs.pop('active', ('H', 'Ca'))
    vlos = kwargs.pop('vlos', None)
    C = kwargs.pop('C')
    h, T, v, vt, ne, nH = stacked_falc(C, seed=BATCH_SEED)
    if vlos is not None:
        v = vlos
    atmos = Atmosphere(height=h.copy(), temperature=T[c].copy(),
                       vlos=v[c].copy(), vturb=vt[c].copy(),
                       ne=ne[c].copy(), nHTot=nH[c].copy())
    atmos.quadrature(5)
    rs = RadiativeSet(models())
    rs.set_active(*active)
    spect = rs.compute_wavelength_grid()
    return Context(atmos, spect, rs.compute_eq_pops(atmos), device='cuda',
                   **kwargs)


def build_batch(C, **kwargs):
    """problems.column_batch(C) on the card; halves C while the card's
    memory does not hold the batch's set-up and first MALI step, and
    prints the memory that stopped it.  Returns the batch, its C and the
    set-up's seconds."""
    from lightweaver_tpu_torch.problems import column_batch
    while True:
        try:
            t0 = time.perf_counter()
            b = column_batch(C, seed=BATCH_SEED, device='cuda', **kwargs)
            torch.cuda.synchronize()
            return b, C, time.perf_counter() - t0
        except torch.cuda.OutOfMemoryError as e:
            print(f'  {C} columns do not fit: {str(e).splitlines()[0]}; '
                  f'peak {torch.cuda.max_memory_allocated() / 2**30:.2f} '
                  'GiB allocated; halving')
            torch.cuda.empty_cache()
            C //= 2


def restarted(b, scheme):
    """A ColumnBatch over ``b``'s flat Context put back at its LTE start
    (populations from eqPops, J = 0; the atmosphere is unchanged without
    charge conservation) under ``scheme``: the set-up (background,
    collisions, profiles of every column) is not repeated."""
    from lightweaver_tpu_torch.parallel import ColumnBatch
    fc = b.flatCtx
    for a, st in zip(fc.cfg.activeAtoms, fc.popsState):
        st['n'] = fc.cfg.state(fc.eqPops.atomicPops[a.model.element].n)
        st.pop('nLastSE', None)
    fc.J = torch.zeros_like(fc.J)
    fc.set_fs_iter_scheme(scheme)
    return ColumnBatch(flatCtx=fc, Ncol=b.Ncol)


def batch_converged():
    """(b) BASELINE config 5's 1.5D leg at full width: BATCH_C columns
    (problems.column_batch: FAL-C, 82 depths, temperature x uniform(0.95,
    1.05) per column, H 6-level + Ca II active, 5 rays, 1046 wavelengths,
    float64, default scheme) through ColumnBatch.iterate(NmaxIter=400);
    every column converges; BATCH_SINGLE_COLUMNS columns (the slowest,
    and the others chosen with the seed) re-run as single card Contexts
    for BATCH_SINGLE_STEPS iterations against the batch's state after as
    many (tests/test_column_batch.py:53-63's protocol, cut in depth),
    populations within BATCH_SINGLE_TOL; ms per batch step,
    column-iterations per second against the single Contexts', peak
    memory, the sweep's launches (one per MALI step) and its device time
    at the batch shape.  Returns the batch (converged)."""
    from lightweaver_tpu_torch.ops import sweep
    phase(f'column batch (b): BASELINE config 5 1.5D leg, {BATCH_C} '
          'FAL-C columns (H 6 + Ca II active, 5 rays, f64, default '
          'scheme), ColumnBatch.iterate(NmaxIter=400)')
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    b, C, setup = build_batch(BATCH_C)
    cfg = b.cfg
    print(f'  {C} columns: flat Context of Nk = {cfg.Nk} ({C} x '
          f'{b.NkCol}), Nlam = {cfg.Nlam}, Nmu = {cfg.Nmu}, ray tensor '
          f'{2 * cfg.Nlam * cfg.Nmu * cfg.Nk * 8 / 1e9:.2f} GB; set-up '
          f'{setup:.1f} s')
    steps, snap = [], []
    fsgm = b.formal_sol_gamma_matrices

    def counted(*a, **k):
        if len(steps) == BATCH_SINGLE_STEPS:
            snap.append(b.pops)
        steps.append(1)
        return fsgm(*a, **k)
    b.formal_sol_gamma_matrices = counted
    reset_counts()
    t0 = time.perf_counter()
    nIt = b.iterate(NmaxIter=400)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    del b.formal_sol_gamma_matrices
    peak = torch.cuda.max_memory_allocated()
    nSteps = len(steps)
    n = b.nIterCol
    print(f'  {int(b.converged.sum())} of {C} columns converged in {nIt} '
          f'batch steps; nIterCol min / median / max {n.min()} / '
          f'{int(np.median(n))} / {n.max()}')
    print(f'  {wall:.2f} s: {wall / nSteps * 1e3:.2f} ms per batch step '
          f'(MALI step + stat_equil, host clock), {C * nSteps / wall:.1f} '
          f'column-iterations/s, {C / wall:.2f} converged columns/s; peak '
          f'memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); '
          f'sweep launches {counts["sweep"]} in {nSteps} MALI steps')
    if not b.converged.all():
        raise AssertionError(f'{int((~b.converged).sum())} columns did not '
                             'converge in 400 iterations')
    if counts['sweep'] != nSteps or any(
            v for k, v in counts.items() if k != 'sweep'):
        raise AssertionError(f'launches {counts} in {nSteps} MALI steps')

    # the sweep kernel at the batch shape: the last step's inputs
    it, params = b._iter_fn, b.params
    chi, src = it.gather(params, it.scaJ(params))
    args = it.sweep_inputs(params, chi, src)
    out = sweep.formal_solve_sweep(*args)
    bnd = sweep_bound(args, out)
    k1, k2 = kernel_device_ms(lambda: sweep.formal_solve_sweep(*args),
                              SYMBOLS['sweep'], reps=10)
    print(f'  sweep kernel, {C} columns (1046 x 5 x 2 rays x {cfg.Nk} '
          f'depths): {k1:.3f} / {k2:.3f} ms per launch{bound_text(bnd)}')
    del chi, src, args, out

    rng = np.random.default_rng(BATCH_SEED)
    slow = int(np.argmax(n))
    others = rng.choice(np.delete(np.arange(C), slow),
                        BATCH_SINGLE_COLUMNS - 1, replace=False)
    pops = snap[0]
    singleMs = []
    for c in [slow] + sorted(int(x) for x in others):
        ctx = single_column_context(c, C=C)
        t0 = time.perf_counter()
        for k in range(BATCH_SINGLE_STEPS):
            ctx.formal_sol_gamma_matrices()
            if k >= 3:
                ctx.stat_equil()
        torch.cuda.synchronize()
        singleMs.append((time.perf_counter() - t0) / BATCH_SINGLE_STEPS
                        * 1e3)
        errs = [relerr(pops[ai][c], ctx.popsState[ai]['n'].cpu())
                for ai in range(len(pops))]
        print(f'  column {c} (converged in {n[c]} iterations) as a single '
              f'card Context, after {BATCH_SINGLE_STEPS} iterations: '
              'populations max rel ' + ', '.join(f'{e:.2e}' for e in errs)
              + f' (bar {BATCH_SINGLE_TOL}); {singleMs[-1]:.2f} ms/iter')
        if not max(errs) < BATCH_SINGLE_TOL:
            raise AssertionError(f'batch column {c} differs from its single '
                                 f'Context: {errs}')
    ms1 = float(np.median(singleMs))
    print(f'  single falc_h6ca-column Context: {ms1:.2f} ms/iter, '
          f'{1e3 / ms1:.1f} column-iterations/s; the batch '
          f'{C * nSteps / wall / (1e3 / ms1):.0f}x that')
    del pops, params, it
    torch.cuda.empty_cache()
    return b


def batch_schemes(converged):
    """(c) BATCH_SCHEME_STEPS MALI steps of (b)'s batch under the default,
    `_pallas` and `_fused` schemes (ColumnBatch.iterate, stat_equil from
    the fourth), populations of the kernel schemes within
    BATCH_SCHEME_TOL of the default's, one launch of each stage's kernel
    per step, the line Gamma and fused kernels' device times at the batch
    shape; then BATCH_F32_STEPS steps in float32, finite and
    contracting.  The float64 runs restart (b)'s batch from LTE.  Returns
    the default scheme's populations, J and ms per batch step (phase 16's
    reference)."""
    from lightweaver_tpu_torch.ops import fused, gamma
    C = converged.Ncol
    phase(f'column batch (c): {C} columns, {BATCH_SCHEME_STEPS} MALI steps '
          'under each scheme, then float32')
    ref = None
    expected = {'mali_full_precond': {'sweep': 1},
                PALLAS: {'sweep': 1, 'gamma': 1}, FUSED: {'fused': 1}}
    for scheme in SCHEMES:
        t0 = time.perf_counter()
        b = restarted(converged, scheme)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        b.iterate(NmaxIter=BATCH_SCHEME_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in read_counts().items() if v}
        pops = b.pops
        if ref is None:
            ref, err = pops, 0.0
            # phase 16 (a)'s reference: the default scheme's state
            default = {'pops': pops, 'J': b.J,
                       'ms': wall / BATCH_SCHEME_STEPS * 1e3}
        else:
            err = max(relerr(p, r) for p, r in zip(pops, ref))
        print(f'  {scheme}: {wall / BATCH_SCHEME_STEPS * 1e3:.2f} ms per '
              f'batch step (set-up {setup:.1f} s), launches '
              + ', '.join(f'{k} {v}' for k, v in counts.items())
              + f'; populations vs the default scheme {err:.2e} (bar '
              f'{BATCH_SCHEME_TOL})')
        want = {k: v * BATCH_SCHEME_STEPS for k, v in expected[scheme].items()}
        if counts != want:
            raise AssertionError(f'{scheme}: launches {counts}, expected '
                                 f'{want}')
        if not err < BATCH_SCHEME_TOL:
            raise AssertionError(f'{scheme} batch differs from the default '
                                 f'scheme: {err:.3e}')
        it, params = b._iter_fn, b.params
        print(f'  {scheme}, {C} columns: ', end='')
        stage_breakdown(it, params, scheme, reps=3)
        t0 = time.perf_counter()
        b.stat_equil()
        torch.cuda.synchronize()
        print(f'  stat_equil of {C} columns (flat solve, one host pull, '
              f'BatchedNg): {(time.perf_counter() - t0) * 1e3:.3f} ms')
        scaJ = it.scaJ(params)
        if scheme == PALLAS:
            chi, src = it.gather(params, scaJ)
            rays = it.formal_solve(params, chi, src)
            args = it.line_inputs(params, *rays[:3], src, params['pack'])
            k1, k2 = kernel_device_ms(lambda: gamma.line_gamma_rates(*args),
                                      SYMBOLS['gamma'], reps=10)
            print(f'  line Gamma kernel, {C} columns: {k1:.3f} / {k2:.3f} '
                  f'ms per launch{bound_text(gamma_bound(args))}')
            del chi, src, rays, args
        elif scheme == FUSED:
            args = it.fused_inputs(params, scaJ, params['pack'])
            out = fused.fused_lambda_step(*args)
            bnd = fused_bound(args, out)
            del out
            k1, k2 = kernel_device_ms(lambda: fused.fused_lambda_step(*args),
                                      SYMBOLS['fused'], reps=10)
            print(f'  fused kernel, {C} columns: {k1:.3f} / {k2:.3f} ms per '
                  f'launch{bound_text(bnd)}')
            del args
        del b, it, params, scaJ
        torch.cuda.empty_cache()
    del converged
    torch.cuda.empty_cache()

    b, _, setup = build_batch(C, dtype=F32)
    reset_counts()
    dJ = []
    t0 = time.perf_counter()
    for k in range(BATCH_F32_STEPS):
        dJ.append(b.formal_sol_gamma_matrices().dJMax)
        if k >= 3:
            b.stat_equil()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in read_counts().items() if v}
    finite = (np.isfinite(dJ).all() and np.isfinite(b.I).all()
              and all(np.isfinite(p).all() for p in b.pops))
    print(f'  float32: {wall / BATCH_F32_STEPS * 1e3:.2f} ms per batch step, '
          f'dJ {dJ[4]:.3e} at step 5, {dJ[-1]:.3e} at step '
          f'{BATCH_F32_STEPS}; launches '
          + ', '.join(f'{k} {v}' for k, v in counts.items()))
    if not (finite and dJ[-1] < dJ[4]):
        raise AssertionError(f'float32 batch: finite {finite}, dJ {dJ}')
    if counts != {'sweep_f32': BATCH_F32_STEPS}:
        raise AssertionError(f'float32 batch launches {counts}')
    batch_f32_kernels(b)
    del b
    torch.cuda.empty_cache()
    return default


def batch_f32_kernels(b):
    """The float32 instances of the sweep, line Gamma and fused kernels at
    the batch shape (BATCH_C columns), on the inputs of the float32
    batch's last step: device time per launch and the bound."""
    from lightweaver_tpu_torch.context import fused_pack, line_pack
    from lightweaver_tpu_torch.ops import fused, gamma, sweep
    it, params, C = b._iter_fn, b.params, b.Ncol
    scaJ = it.scaJ(params)
    chi, src = it.gather(params, scaJ)
    args = it.sweep_inputs(params, chi, src)
    rays = sweep.formal_solve_sweep(*args)
    bnd = sweep_bound(args, rays)
    k1, k2 = kernel_device_ms(lambda: sweep.formal_solve_sweep(*args),
                              SYMBOLS['sweep'], reps=10)
    print(f'  float32 sweep kernel, {C} columns: {k1:.3f} / {k2:.3f} ms per '
          f'launch{bound_text(bnd)}')
    del args
    table = line_pack(b.cfg, params)
    args = it.line_inputs(params, *rays[:3], src, table)
    k1, k2 = kernel_device_ms(lambda: gamma.line_gamma_rates(*args),
                              SYMBOLS['gamma'], reps=10)
    print(f'  float32 line Gamma kernel, {C} columns: {k1:.3f} / {k2:.3f} ms '
          f'per launch{bound_text(gamma_bound(args))}')
    del args, table, rays, chi, src
    torch.cuda.empty_cache()
    args = it.fused_inputs(params, scaJ, fused_pack(b.cfg, params))
    out = fused.fused_lambda_step(*args)
    bnd = fused_bound(args, out)
    del out
    k1, k2 = kernel_device_ms(lambda: fused.fused_lambda_step(*args),
                              SYMBOLS['fused'], reps=10)
    print(f'  float32 fused kernel, {C} columns: {k1:.3f} / {k2:.3f} ms per '
          f'launch{bound_text(bnd)}')
    del args
    torch.cuda.empty_cache()


def batch_prd():
    """(d) BATCH_PRD_C FAL-C columns with H 6-level active (Ly-alpha,
    Ly-beta in PRD), hybrid PRD, accelerateScattering and 0-5 km/s
    outflow ramps spread over the columns: BATCH_PRD_STEPS MALI steps
    with stat_equil and prd_redistribute(maxIter=3) from the fourth; two
    columns held against single card Contexts run in lockstep (rho and
    populations within BATCH_PRD_TOL)."""
    from lightweaver_tpu_torch import H_6_atom
    from lightweaver_tpu_torch.problems import (column_batch,
                                                column_vlos_ramps,
                                                stacked_falc)
    C = BATCH_PRD_C
    phase(f'column batch (d): {C} columns, H 6 active with Ly-alpha and '
          'Ly-beta in PRD, hybrid PRD, accelerateScattering, 0-5 km/s '
          f'outflows; {BATCH_PRD_STEPS} MALI steps with prd_redistribute')
    h = stacked_falc(C, seed=BATCH_SEED)[0]
    vlos = column_vlos_ramps(h, C)
    kw = dict(hprd=True, accelerateScattering=True)
    b = column_batch(C, models=lambda: [H_6_atom()], activeSpecies=('H',),
                     seed=BATCH_SEED, vlos=vlos, device='cuda', **kw)
    cols = [C // 3, C - 1]
    singles = [single_column_context(c, C=C, models=lambda: [H_6_atom()],
                                     active=('H',), vlos=vlos, **kw)
               for c in cols]
    lines = b.flatCtx._prd_lines()
    reset_counts()
    t0 = time.perf_counter()
    nSub = 0
    for k in range(BATCH_PRD_STEPS):
        b.formal_sol_gamma_matrices()
        if k >= 3:
            b.stat_equil()
            nSub += b.prd_redistribute(maxIter=3, tol=0.0).NprdSubIter
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in read_counts().items() if v}
    for ctx in singles:
        for k in range(BATCH_PRD_STEPS):
            ctx.formal_sol_gamma_matrices()
            if k >= 3:
                ctx.stat_equil()
                ctx.prd_redistribute(maxIter=3, tol=0.0)
    Nc = b.NkCol
    worst = 0.0
    for c, ctx in zip(cols, singles):
        errs = {f'pops_a{ai}': relerr(p[c], ctx.popsState[ai]['n'].cpu())
                for ai, p in enumerate(b.pops)}
        for ai, ti, a, t in lines:
            errs[f'rho {ti}'] = relerr(column_slice(
                b.params['rhoPrd'][ai][ti], c, Nc).cpu(),
                ctx.rhoPrd[ai][ti].cpu())
        worst = max(worst, max(errs.values()))
        print(f'  column {c} (vlos top {vlos[c, 0]:.0f} m/s) against a '
              'single card Context: ' + ', '.join(
                  f'{k} {v:.2e}' for k, v in errs.items()))
    rho = b.params['rhoPrd'][lines[0][0]][lines[0][1]]
    print(f'  {wall / BATCH_PRD_STEPS * 1e3:.2f} ms per batch step with '
          f'{nSub} PRD sub-iterations; max|rho - 1| '
          f'{(rho - 1).abs().max().item():.2f}; launches '
          + ', '.join(f'{k} {v}' for k, v in counts.items()))
    if not worst < BATCH_PRD_TOL:
        raise AssertionError(f'PRD batch differs from single Contexts: '
                             f'{worst:.3e} > {BATCH_PRD_TOL}')
    if (counts.get('sweep', 0) != BATCH_PRD_STEPS
            or counts.get('prd_subset', 0) != nSub):
        raise AssertionError(f'PRD batch launches {counts}: one sweep per '
                             'MALI step and one subset kernel per PRD '
                             'sub-iteration expected')
    del b, singles
    torch.cuda.empty_cache()


# ---- 2D (phase 14) -------------------------------------------------------
# (a) the golden 2D problem (problems.slab_2d(30, 8, periodic=False)):
# solver, golden file, the compat x-lower boundary, the bar of
# tests/test_vs_reference_golden.py
# (solver, golden file, compat x BC, bar, MALI steps: None to converge);
# BESSER converged against its golden run (218 iterations) until phase 17
# needed the time
GOLDEN_2D = (('piecewise_linear_2d', 'falc2d_ca_ref', True, 1e-8, None),
             ('piecewise_besser_2d', 'falc2d_ca_besser_ref', False, 1e-9, 40))
# (b) BASELINE config 5's 2D leg: Nz, Nx, rays per half-plane, MALI steps
# from LTE, and the roll check (columns, steps, bar on J pointwise and on
# the populations of each level relative to its maximum: the stat-eq solve
# takes the ring scans' rounding, which depends on the columns' order, to
# ~1e-9 in populations eight decades below their level's maximum)
SLAB_2D = (82, 256, 6)
# (20 steps until phase 16 needed the time)
SLAB_2D_STEPS = 6
SLAB_2D_ROLL = 64
SLAB_2D_ROLL_STEPS = 3
SLAB_2D_ROLL_TOL = 1e-10
# MALI steps under the profiler (each records ~56k kernels; 1 since
# phase 18 needed the time, were 2)
SLAB_2D_PROFILED = 1
# (c) card against CPU: float32 MALI steps; the synthesis calls' bar
F32_2D_STEPS = 3
CARD_CPU_2D_TOL = 1e-9


def no_kernel_launched(label, counts):
    """The x-sharded 2D path (parallel/xshard2d.py) sweeps in torch ops,
    its ring split over ranks: any launch of a csrc/ kernel is a path
    gone astray."""
    if any(counts.values()):
        raise AssertionError(f'{label} launched csrc/ kernels: '
                             f'{ {k: v for k, v in counts.items() if v} }')


def only_2d_sweep_launched(label, counts):
    """The 2D path's one csrc/ kernel is the plane sweep (csrc/sweep2d.cu;
    the JAX package leaves it to XLA): no launch of it, or a launch of
    another kernel, is a path gone astray."""
    other = {k: v for k, v in counts.items()
             if v and not k.startswith('sweep2d')}
    if other or not counts['sweep2d'] + counts['sweep2d_f32']:
        raise AssertionError(f'{label} launched csrc/ kernels '
                             f'{ {k: v for k, v in counts.items() if v} }; '
                             'the 2D sweep kernel alone was expected')


def golden_2d(solver, refName, compat, bar, nSteps=None):
    """(a) The golden 2D problem converged on the card through
    iterate_ctx_se: iterations within NITER_REF_SLACK of the reference's,
    populations, J and I within ``bar`` of its run; ms per iteration.
    With ``nSteps``, that many MALI steps (stat_equil from the fourth),
    finite and contracting (the last dJ below the fifth step's)."""
    from lightweaver_tpu_torch import iterate_ctx_se
    from lightweaver_tpu_torch.problems import slab_2d
    phase(f'2D (a): falc2d_ca under {solver}'
          + (' with the compat x-lower boundary' if compat else '')
          + (' converged on the card vs the golden run' if nSteps is None
             else f', {nSteps} MALI steps on the card'))
    ref = golden(refName)
    ctx = slab_2d(30, 8, periodic=False, device='cuda', formalSolver=solver,
                  refBugCompat=compat)
    reset_counts()
    t0 = time.perf_counter()
    if nSteps is not None:
        dJ = []
        for it in range(nSteps):
            dJ.append(float(ctx.formal_sol_gamma_matrices().dJMax))
            if it >= 3:
                ctx.stat_equil()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        only_2d_sweep_launched(solver, read_counts())
        print(f'  {nSteps} MALI steps, {wall / nSteps * 1e3:.3f} ms/iter; dJ '
              f'{dJ[4]:.3e} at step 5, {dJ[-1]:.3e} at the last')
        if not (np.isfinite(dJ).all() and dJ[-1] < dJ[4]
                and torch.isfinite(ctx.I).all()):
            raise AssertionError(f'{solver}: dJ {dJ}')
        return wall / nSteps * 1e3
    nIter = iterate_ctx_se(ctx, NmaxIter=500, quiet=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    only_2d_sweep_launched(solver, read_counts())
    nRef = int(ref['out_niter'][0])
    errs = {'pops': relerr(ctx.popsState[0]['n'].cpu(), ref['out_pops_a0']),
            'J': relerr(ctx.J.cpu(), ref['out_J']),
            'I': relerr(ctx.I.cpu().numpy().reshape(ref['out_I'].shape),
                        ref['out_I'])}
    print(f'  {nIter} iterations (reference {nRef}); {wall:.2f} s, '
          f'{wall / nIter * 1e3:.3f} ms/iter; vs golden: '
          + ', '.join(f'{k} {v:.3e}' for k, v in errs.items())
          + f' (bar {bar})')
    if abs(nIter - nRef) > NITER_REF_SLACK:
        raise AssertionError(f'{solver}: {nIter} iterations vs {nRef}')
    if not max(errs.values()) <= bar:
        raise AssertionError(f'{solver} vs golden: {errs}')
    return wall / nIter * 1e3


def slab_2d_steps(ctx, nSteps, snapAt=None):
    """nSteps MALI steps with stat_equil after each; their dJ, the seconds
    per step (synchronised), and (J, populations) after snapAt steps."""
    dJ, snap = [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(nSteps):
        dJ.append(float(ctx.formal_sol_gamma_matrices().dJMax))
        ctx.stat_equil()
        if snapAt is not None and k + 1 == snapAt:
            snap = (ctx.J.clone(), ctx.popsState[0]['n'].clone())
    torch.cuda.synchronize()
    return dJ, (time.perf_counter() - t0) / nSteps, snap


def slab_2d_real():
    """(b) BASELINE config 5's 2D leg on the card: problems.slab_2d(82,
    256, periodic=True, quadrature=6) under the BESSER 2D solver, the
    reference's default, SLAB_2D_STEPS MALI steps from LTE: finite, dJ
    contracting; ms per step, peak memory, the stage breakdown (the 2D
    formal solve against gamma_rates, host clock) and the profile (kernels
    per step, idle share: scripts/torch_profile.py); then the same slab
    rolled by SLAB_2D_ROLL columns against the unrolled one, rolled, after
    SLAB_2D_ROLL_STEPS steps.  Returns the numbers printed and J after
    SLAB_2D_ROLL_STEPS steps (phase 16 (b)'s reference)."""
    from lightweaver_tpu_torch.problems import slab_2d
    sys.path.insert(0, str(ROOT / 'scripts'))
    from torch_profile import profile_problem
    Nz, Nx, nq = SLAB_2D
    phase(f'2D (b): BASELINE config 5\'s 2D leg, slab_2d({Nz}, {Nx}, '
          f'periodic=True, quadrature={nq}) under piecewise_besser_2d, '
          f'{SLAB_2D_STEPS} MALI steps from LTE')
    solver = 'piecewise_besser_2d'
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctx = slab_2d(Nz, Nx, periodic=True, quadrature=nq, device='cuda',
                  formalSolver=solver)
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    cfg = ctx.cfg
    rayBytes = 2 * cfg.Nlam * cfg.Nmu * cfg.Nk * 8
    print(f'  Nlam {cfg.Nlam}, Nmu {cfg.Nmu}, Nz x Nx = {cfg.Nz} x {cfg.Nx} '
          f'= {cfg.Nk} points; a float64 ray tensor {rayBytes / 1e9:.2f} GB; '
          f'Context built in {build:.1f} s')
    reset_counts()
    dJ, sPerStep, snap = slab_2d_steps(ctx, SLAB_2D_STEPS, SLAB_2D_ROLL_STEPS)
    counts = read_counts()
    only_2d_sweep_launched('the 2D slab', counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = bool(torch.isfinite(ctx.I).all() and torch.isfinite(ctx.J).all()
                  and torch.isfinite(ctx.popsState[0]['n']).all())
    print(f'  {sPerStep * 1e3:.1f} ms per MALI step (stat_equil included, '
          f'mean of {SLAB_2D_STEPS}); peak memory {peak:.2f} GiB; dJ '
          + ' '.join(f'{d:.3g}' for d in dJ) + f'; finite {finite}')
    if not finite or not dJ[-1] < dJ[4]:
        raise AssertionError(f'the 2D slab: finite {finite}, dJ {dJ}')
    it = ctx._iter_fn
    params = ctx.build_params()
    stages = stage_breakdown(it, params, 'mali_full_precond', reps=3)

    def mali(c):
        c.formal_sol_gamma_matrices()
        c.stat_equil()
    prof = profile_problem(f'slab_2d({Nz}, {Nx}), {solver}, '
                           'formal_sol_gamma_matrices + stat_equil', ctx,
                           mali, iters=SLAB_2D_PROFILED)
    kernels = {'sweep2d': dict(slab_sweep2d_check(ctx),
                               launches=counts['sweep2d'])}
    del ctx, it, params
    torch.cuda.empty_cache()

    rolled = slab_2d(Nz, Nx, periodic=True, quadrature=nq, device='cuda',
                     formalSolver=solver, roll=SLAB_2D_ROLL)
    slab_2d_steps(rolled, SLAB_2D_ROLL_STEPS)

    def roll(x):
        return x.view(x.shape[0], Nz, Nx).roll(SLAB_2D_ROLL, dims=-1) \
            .reshape(x.shape)
    snapJ = snap[0].cpu().numpy()
    J0, n0 = (roll(x) for x in snap)
    errJ = float(((rolled.J - J0).abs() / J0.abs()).max())
    n = rolled.popsState[0]['n']
    errN = float(((n - n0).abs().amax(dim=1) / n0.abs().amax(dim=1)).max())
    print(f'  rolled by {SLAB_2D_ROLL} columns, after {SLAB_2D_ROLL_STEPS} '
          f'steps against the unrolled slab rolled: J {errJ:.3e}, '
          f'populations {errN:.3e} of each level\'s maximum (bar '
          f'{SLAB_2D_ROLL_TOL})')
    if not (errJ <= SLAB_2D_ROLL_TOL and errN <= SLAB_2D_ROLL_TOL):
        raise AssertionError(f'the 2D roll check: J {errJ}, pops {errN}')
    del rolled, snap, J0, n0
    torch.cuda.empty_cache()
    ctx32 = slab_2d(Nz, Nx, periodic=True, quadrature=nq, device='cuda',
                    dtype=F32, formalSolver=solver)
    reset_counts()
    ctx32.formal_sol_gamma_matrices()
    torch.cuda.synchronize()
    counts = read_counts()
    only_2d_sweep_launched('the float32 2D slab', counts)
    kernels['sweep2d_f32'] = dict(slab_sweep2d_check(ctx32),
                                  launches=counts['sweep2d_f32'])
    del ctx32
    torch.cuda.empty_cache()
    return {'ms_per_step': sPerStep * 1e3, 'peak_gib': peak, 'J3': snapJ,
            'stages_ms': {k: v * 1e3 for k, v in stages.items()},
            'profile': prof, 'kernels': kernels}


# the 2D kernel against its plain version on the slab's inputs (float64):
# the kernel rounds each operation as the torch ops do; only the ring
# scan associates otherwise
SWEEP2D_TOL = 1e-12
# floating-point operations per (ray, point) of the 2D plane step
# (csrc/sweep2d.cu's header)
SWEEP2D_FLOPS = 150
SWEEP2D_NAMES = ('I', 'Psi', 'IeffBase')
# the ray group's arrays that the 2D kernel reads
SWEEP2D_GROUP = ('axisZ', 'w', 'ds', 'dwAxisZ', 'dwW', 'dwDs', 'dwZero',
                 'fixed', 'flip')


def slab_sweep_calls(ctx):
    """[(args, kwargs)] of the sweep_rays_2d calls of one formal solution
    of the Context's state, one per direction: chi and srcNum from the
    gather, the ray group, the boundary data and the schemes as
    formal_solve_2d hands them over (its output tensors left out)."""
    from lightweaver_tpu_torch.ops import formal_solver2d as fs2d
    it = ctx._iter_fn
    params = ctx.build_params()
    chiTot, srcNum = it.gather(params, it.scaJ(params))
    calls, real = [], fs2d.sweep_rays_2d

    def keep(*args, **kw):
        calls.append((args, {k: v for k, v in kw.items() if k != 'out'}))
        return real(*args, **kw)
    fs2d.sweep_rays_2d = keep
    try:
        it.formal_solve(params, chiTot, srcNum)
    finally:
        fs2d.sweep_rays_2d = real
    torch.cuda.synchronize()
    return calls


def sweep2d_bound(args, kw, out):
    """chi, the source, the boundary data and the group's rows read once,
    I, Psi and IeffBase written once."""
    chi, group = args[0], args[1]
    ins = [chi, args[2], kw.get('S'), kw.get('srcNum'), kw.get('Ibc')]
    ins += [group[k] for k in SWEEP2D_GROUP]
    return bound(nbytes(ins + list(out)), SWEEP2D_FLOPS * chi.numel(),
                 chi.dtype)


def slab_sweep2d_check(ctx):
    """The 2D kernel on the slab's inputs (slab_sweep_calls), each
    direction: against sweep_rays_2d_plain (float64 within SWEEP2D_TOL of
    each output's maximum; float32 by f32_rule against the plain loop in
    float64 on the same inputs), the kernel's device time and the plain
    loop's per call (float32: also the float64 instance on the upcast
    inputs).  Returns the record, each time the mean over the
    directions."""
    from lightweaver_tpu_torch.ops import formal_solver2d as fs2d
    f32 = ctx.cfg.dtype == F32
    rows = []
    for d, (args, kw) in enumerate(slab_sweep_calls(ctx)):
        label = (f'2D kernel, direction {d}, {"float32" if f32 else "float64"}'
                 f' {list(args[0].shape)}')
        kern = fs2d.sweep2d_cuda(*args, **kw)
        plain = fs2d.sweep_rays_2d_plain(*args, **kw)
        torch.cuda.synchronize()
        bnd = sweep2d_bound(args, kw, kern)
        if f32:
            args64 = (args[0].double(), fs2d.group_as(args[1], torch.float64),
                      args[2].double())
            kw64 = {k: v.double() if torch.is_tensor(v) else v
                    for k, v in kw.items()}
            ref = fs2d.sweep_rays_2d_plain(*args64, **kw64)
            absErr = f32_rule(label, SWEEP2D_NAMES, kern, plain, ref)
            del ref
            ms, plainMs, ms64 = timed_instances(
                f'{label}, per call', lambda: fs2d.sweep2d_cuda(*args, **kw),
                lambda: fs2d.sweep_rays_2d_plain(*args, **kw),
                lambda: fs2d.sweep2d_cuda(*args64, **kw64), bnd,
                SYMBOLS['sweep2d'])
            del args64, kw64
        else:
            rel, absErr = compare_outputs(label, SWEEP2D_NAMES, kern, plain,
                                          SWEEP2D_TOL)
            print(f'  {label}: max|kernel-plain|/max|plain| = {rel:.3e} '
                  f'(bar {SWEEP2D_TOL}), max abs {absErr:.3e}')
            ms, plainMs = timed_pair(
                f'{label}, per call', lambda: fs2d.sweep2d_cuda(*args, **kw),
                lambda: fs2d.sweep_rays_2d_plain(*args, **kw),
                SYMBOLS['sweep2d'], bnd=bnd)
            ms64 = None
        rows.append(dict(max_abs_err=absErr, ms=ms, plain_ms=plainMs,
                         f64_ms=ms64, **bnd))
        del kern, plain
    torch.cuda.empty_cache()

    def mean(k):
        return float(np.mean([r[k] for r in rows]))
    record = dict(max_abs_err=max(r['max_abs_err'] for r in rows),
                  ms=mean('ms'), plain_ms=mean('plain_ms'),
                  bound_ms=mean('bound_ms'), bound_by=rows[0]['bound_by'])
    if f32:
        record['f64_ms'] = mean('f64_ms')
    return record


def params_to(params, device):
    """The port's params dict with every tensor moved to ``device`` (the
    iteration casts what the ray math reads to its working dtype)."""
    def move(x):
        if torch.is_tensor(x):
            return x.to(device)
        if isinstance(x, list):
            return [move(y) for y in x]
        return x
    return {k: move(v) for k, v in params.items()}


def card_cpu_2d():
    """(c) Card against CPU on the golden atmosphere: F32_2D_STEPS float32
    MALI steps in lockstep (the CPU Context's params into the card's
    float32 iteration, the CPU's and a float64 one on the card), each
    float32 result held to the float64 one by err(card f32) <= 2 err(CPU
    f32) + 32 float32 ulps of the maximum; then single_stokes_fs on the
    magnetised slab and compute_rays(mus=[0.7, 1.0]), card against its CPU
    twin within CARD_CPU_2D_TOL of each wavelength's maximum; the ms of
    each."""
    from lightweaver_tpu_torch.context import build_iteration_fn
    from lightweaver_tpu_torch.problems import magnetise, slab_2d
    phase('2D (c): card against CPU on falc2d_ca: float32 MALI steps, '
          'single_stokes_fs on the magnetised slab, compute_rays')
    bar = 32 * float(np.finfo(np.float32).eps)
    cpu = slab_2d(30, 8, periodic=False, device='cpu', dtype=F32)
    card = slab_2d(30, 8, periodic=False, device='cuda', dtype=F32)
    cfg64 = dataclasses.replace(card.cfg, dtype=torch.float64)
    it32, it64 = build_iteration_fn(card.cfg), build_iteration_fn(cfg64)
    worst = 0.0
    for step in range(F32_2D_STEPS):
        p = cpu.build_params()
        ref = cpu._iter_fn(p)
        out = it32(params_to(p, card.device))
        truth = it64(params_to(p, card.device))
        for key in ('J', 'I', 'Gamma'):
            o, r, t = (x[key][0] if key == 'Gamma' else x[key]
                       for x in (out, ref, truth))
            t = t.cpu().double()
            scale = float(t.abs().max())
            eCard = float((o.cpu().double() - t).abs().max()) / scale
            eCpu = float((r.cpu().double() - t).abs().max()) / scale
            worst = max(worst, eCard / (2.0 * eCpu + bar))
            if not eCard <= 2.0 * eCpu + bar:
                raise AssertionError(f'float32 {key} step {step}: card '
                                     f'{eCard:.3e}, CPU {eCpu:.3e}')
        cpu.formal_sol_gamma_matrices()
        cpu.stat_equil()
    print(f'  {F32_2D_STEPS} float32 steps: err(card f32, f64) / (2 err(CPU '
          f'f32, f64) + 32 ulps) at most {worst:.3f} over J, I, Gamma')

    ctx = slab_2d(30, 8, periodic=False, device='cuda')
    magnetise(ctx.atmos)
    for k in range(3):
        ctx.formal_sol_gamma_matrices()
        ctx.stat_equil()
    twin = cpu_twin(ctx)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx.single_stokes_fs()
    torch.cuda.synchronize()
    stokesMs = (time.perf_counter() - t0) * 1e3
    twin.single_stokes_fs()
    I, Quv = ctx.I.cpu().numpy(), ctx.Quv.cpu().numpy()
    Iref, Qref = twin.I.numpy(), twin.Quv.numpy()
    amp = np.abs(Iref).reshape(len(Iref), -1).max(axis=1)
    errS = max(float((np.abs(a - b).reshape(len(b), -1).max(axis=1)
                      / amp).max())
               for a, b in [(I, Iref)] + list(zip(Quv, Qref)))
    t0 = time.perf_counter()
    rays = ctx.compute_rays(mus=[0.7, 1.0])
    torch.cuda.synchronize()
    raysMs = (time.perf_counter() - t0) * 1e3
    only_2d_sweep_launched('2D synthesis', read_counts())
    raysRef = twin.compute_rays(mus=[0.7, 1.0])
    errR = float((np.abs(rays - raysRef).reshape(len(rays), -1).max(axis=1)
                  / np.abs(raysRef).reshape(len(rays), -1).max(axis=1)).max())
    print(f'  single_stokes_fs {I.shape} + Q/U/V (max |V| / max I '
          f'{np.abs(Quv[2]).max() / np.abs(I).max():.2e}): card vs CPU '
          f'{errS:.3e} of each wavelength\'s Stokes I maximum, {stokesMs:.1f}'
          f' ms on the card; compute_rays(mus=[0.7, 1.0]) {rays.shape}: '
          f'{errR:.3e}, {raysMs:.1f} ms (bar {CARD_CPU_2D_TOL})')
    if not (errS <= CARD_CPU_2D_TOL and errR <= CARD_CPU_2D_TOL
            and np.isfinite(rays).all()):
        raise AssertionError(f'2D synthesis card vs CPU: Stokes {errS}, '
                             f'compute_rays {errR}')
    return {'stokes_ms': stokesMs, 'rays_ms': raysMs}


# ---- phase 15: the Context options ----------------------------------------
OPTIONS_HPRD_STEPS = 10
# dense Gamma against factored, of each array's maximum
# (tests/test_gamma_modes.py's bars)
DENSE_TOL = {torch.float64: 1e-12, torch.float32: 3e-5}
# depthData's chi, eta and I across the schemes and against the CPU, per
# wavelength, and the radiative losses; the float64 card-against-CPU steps
# of (d) take KERNEL_TOL
DEPTH_TOL = 1e-10


def rows_err(ours, ref):
    """max |ours - ref| over the row's max |ref| per row of the first
    axis (wavelength), as numpy."""
    ours = np.asarray(ours.cpu() if torch.is_tensor(ours) else ours,
                      np.float64)
    ref = np.asarray(ref.cpu() if torch.is_tensor(ref) else ref, np.float64)
    ours, ref = ours.reshape(len(ref), -1), ref.reshape(len(ref), -1)
    return np.abs(ours - ref).max(axis=1) / np.abs(ref).max(axis=1)


def f32_card_rule(label, items):
    """Phase 10's rule on whole results: each (name, card f32, CPU f32,
    float64 on the same state, perRow) holds err(card, f64) <= F32_SLACK
    err(CPU, f64) + F32_FLOOR; per row (J, I, JRest: each wavelength over
    its maximum) against the larger of the row's CPU distance and the
    worst over the rows where the CPU's is within 10%.  Returns the
    largest err / bar."""
    worst = 0.0
    for name, card, cpu, truth, perRow in items:
        if perRow:
            eCard, eCpu = rows_err(card, truth), rows_err(cpu, truth)
            eCpu = np.maximum(eCpu, eCpu[eCpu < 0.1].max())
        else:
            truth = truth.double().cpu()
            eCard = np.array(max_rel(card.double().cpu(), truth))
            eCpu = np.array(max_rel(cpu.double().cpu(), truth))
        ratio = float((eCard / (F32_SLACK * eCpu + F32_FLOOR)).max())
        worst = max(worst, ratio)
        if not ratio <= 1.0 or not np.isfinite(eCard).all():
            raise AssertionError(f'{label}: float32 {name} card '
                                 f'{eCard.max():.3e} against CPU '
                                 f'{eCpu.max():.3e}')
    print(f'  {label}: err(card f32, f64) / ({F32_SLACK} err(CPU f32, f64) '
          f'+ {F32_FLOOR}) at most {worst:.3f}')
    return worst


def options_twin(ctx, device, dtype=None, scheme=None):
    """A Context on ``device`` (in ``dtype``, under ``scheme``) from
    ``ctx``'s state dict, with its rates, JRest and the crsw of its last
    step, so that its MALI step and prd_redistribute start from ctx's
    state."""
    from lightweaver_tpu_torch.context import Context
    state = ctx.state_dict()
    state['kwargs'] = dict(state['kwargs'], device=device,
                           **({} if dtype is None else {'dtype': dtype}))
    twin = Context.construct_from_state_dict_with(state)
    if scheme is not None:
        twin.set_fs_iter_scheme(scheme)

    def move(rows):
        return [[None if x is None else x.to(twin.device) for x in row]
                for row in rows]
    if ctx._Rij is not None:
        twin._Rij, twin._Rji = move(ctx._Rij), move(ctx._Rji)
    twin.JRest = None if ctx.JRest is None else ctx.JRest.to(twin.device)
    twin._crswVal = ctx._crswVal
    twin._params = twin.build_params()
    return twin


def options_hprd_f32():
    """(a) falc_h6mg with hybrid PRD in float32 (0-5 km/s outflow, the
    float32 sweep on the full grid and on the PRD subset rows): 10 MALI
    steps with stat_equil and prd_redistribute(maxIter=3) each, ms per
    outer iteration, sweep_f32 launches on the full grid and on the
    subset; then from that state one MALI iteration and one
    prd_redistribute, card against CPU by phase 10's rule with a float64
    card twin as the reference."""
    from lightweaver_tpu_torch.context import build_iteration_fn
    from lightweaver_tpu_torch.problems import h6mg_context
    phase('Context options (a): falc_h6mg hybrid PRD in float32, '
          f'{OPTIONS_HPRD_STEPS} MALI steps with prd_redistribute(maxIter=3)')
    ctx = h6mg_context(hprd=True, dtype=F32)
    reset_counts()
    full = sub = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(OPTIONS_HPRD_STEPS):
        c0 = read_counts()
        u = ctx.formal_sol_gamma_matrices()
        ctx.stat_equil()
        c1 = read_counts()
        ur = ctx.prd_redistribute(maxIter=3)
        full += c1['sweep_f32'] - c0['sweep_f32']
        sub += read_counts()['prd_subset_f32'] - c1['prd_subset_f32']
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / OPTIONS_HPRD_STEPS
    counts = read_counts()
    dJ, dRho = float(u.dJMax), max(ur.dRho)
    print(f'  {ms:.1f} ms per outer iteration; float32 launches: sweep '
          f'{full} on the full grid, PRD subset {sub} on its rows; last dJ '
          f'{dJ:.3e}, dRho {dRho:.3e}; JRest {ctx.JRest.dtype}')
    if not (full > 0 and sub > 0 and counts['sweep'] == 0
            and counts['prd_subset'] == 0
            and np.isfinite(dJ) and np.isfinite(dRho)
            and ctx.JRest.dtype == torch.float64):
        raise AssertionError(f'hybrid PRD in float32: launches {counts}, '
                             f'dJ {dJ}, dRho {dRho}')

    params = ctx.build_params()
    cpu = options_twin(ctx, 'cpu', F32)
    out = ctx._iter_fn(params)
    ref = build_iteration_fn(cpu.cfg)(params_to(params, 'cpu'))
    truth = build_iteration_fn(dataclasses.replace(
        ctx.cfg, dtype=torch.float64))(params)
    items = [(k, out[k], ref[k], truth[k], True) for k in ('J', 'I', 'JRest')]
    for ai in range(len(out['Gamma'])):
        items.append((f'Gamma {ai}', out['Gamma'][ai], ref['Gamma'][ai],
                      truth['Gamma'][ai], False))
        for key in ('Rij', 'Rji'):
            items += [(f'{key} {ai} {ti}', x, ref[key][ai][ti],
                       truth[key][ai][ti], False)
                      for ti, x in enumerate(out[key][ai])]
    f32_card_rule('one MALI iteration', items)

    card, card64 = options_twin(ctx, 'cuda', F32), options_twin(ctx, 'cuda')
    for c in (card, cpu, card64):
        c.prd_redistribute(maxIter=1)
    items = [('J', card.J, cpu.J, card64.J, True),
             ('JRest', card.JRest, cpu.JRest, card64.JRest, True)]
    for ai, ti, _, _ in card._prd_lines():
        items.append((f'rho {ai} {ti}', card.rhoPrd[ai][ti],
                      cpu.rhoPrd[ai][ti], card64.rhoPrd[ai][ti], False))
        for key in ('_Rij', '_Rji'):
            items.append((f'{key} {ai} {ti}', getattr(card, key)[ai][ti],
                          getattr(cpu, key)[ai][ti],
                          getattr(card64, key)[ai][ti], False))
    f32_card_rule('one prd_redistribute', items)
    return {'ms': ms, 'counts': counts}


def options_dense():
    """(b) falc_h6ca with gammaMode='dense' on the card, float64 and the
    float32 state: 3 MALI steps with stat_equil, a fourth, then dense and
    factored on its params (DENSE_TOL of each array's maximum); the ms of
    each mode's iteration (host clock, synchronised)."""
    from lightweaver_tpu_torch.context import build_iteration_fn
    from lightweaver_tpu_torch.fal import Falc82
    from lightweaver_tpu_torch.problems import h6ca_context
    phase('Context options (b): dense Gamma on falc_h6ca against factored')
    total = {}
    for dtype in (torch.float64, F32):
        ctx = h6ca_context(Falc82(), 5, gammaMode='dense', dtype=dtype)
        reset_counts()
        for _ in range(3):
            ctx.formal_sol_gamma_matrices()
            ctx.stat_equil()
        ctx.formal_sol_gamma_matrices()
        counts = read_counts()
        params = dict(ctx._params)
        outs, msMode = {}, {}
        for mode in ('factored', 'dense'):
            it = build_iteration_fn(dataclasses.replace(ctx.cfg,
                                                        gammaMode=mode))
            outs[mode] = it(params)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            it(params)
            torch.cuda.synchronize()
            msMode[mode] = (time.perf_counter() - t0) * 1e3
        f, d = outs['factored'], outs['dense']
        pairs = [('J', f['J'], d['J'])]
        for ai in range(len(f['Gamma'])):
            pairs.append((f'Gamma {ai}', f['Gamma'][ai], d['Gamma'][ai]))
            for key in ('Rij', 'Rji'):
                pairs += [(f'{key} {ai} {ti}', x, d[key][ai][ti])
                          for ti, x in enumerate(f[key][ai])]
        worst = max(max_rel(a.double(), b.double()) for _, a, b in pairs)
        name = 'sweep' if dtype == torch.float64 else 'sweep_f32'
        print(f'  {dtype}: dense vs factored {worst:.3e} of each array\'s '
              f'maximum (bar {DENSE_TOL[dtype]}); one iteration factored '
              f'{msMode["factored"]:.1f} ms, dense {msMode["dense"]:.1f} ms; '
              f'{name} launches {counts[name]}')
        if not (worst <= DENSE_TOL[dtype] and counts[name] == 4):
            raise AssertionError(f'dense Gamma in {dtype}: {worst:.3e}, '
                                 f'launches {counts}')
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def options_depth_data():
    """(c) depthData on falc_h6ca (3 MALI steps deep): one filled MALI step
    under each scheme on card twins of the same state and on a CPU twin;
    chi, eta and I within DEPTH_TOL of each wavelength's maximum across
    the schemes and against the CPU, the capture on the card; compute_radiative_losses on the card's capture
    finite and equal to the CPU's (DEPTH_TOL of each wavelength's
    maximum of the angle-integrated chi S)."""
    from lightweaver_tpu_torch.fal import Falc82
    from lightweaver_tpu_torch.problems import h6ca_context
    from lightweaver_tpu_torch.utils import compute_radiative_losses
    phase('Context options (c): depthData on falc_h6ca under each scheme, '
          'card against CPU, and compute_radiative_losses')
    base = h6ca_context(Falc82(), 5)
    for _ in range(3):
        base.formal_sol_gamma_matrices()
        base.stat_equil()
    cpu = options_twin(base, 'cpu')
    cpu.depthData.fill = True
    cpu.formal_sol_gamma_matrices()
    lossRef = compute_radiative_losses(cpu)
    dd = cpu.depthData
    chiS = np.einsum('lmdk,m->lk', dd.eta.numpy() + (
        cpu.bgSca.numpy() * cpu.J.numpy())[:, None, None, :],
        np.asarray(cpu.atmos.wmu))
    cards = {}
    reset_counts()
    for scheme in SCHEMES:
        card = options_twin(base, 'cuda', scheme=scheme)
        card.depthData.fill = True
        card.formal_sol_gamma_matrices()
        cards[scheme] = card
    torch.cuda.synchronize()
    counts = read_counts()
    errs = {}
    for scheme, card in cards.items():
        for key in ('chi', 'eta', 'I'):
            x = getattr(card.depthData, key)
            if x.device.type != 'cuda' or x.shape != getattr(dd, key).shape:
                raise AssertionError(f'depthData.{key} under {scheme}: '
                                     f'{x.device} {tuple(x.shape)}')
            e = max(float(rows_err(x, getattr(dd, key)).max()),
                    float(rows_err(x, getattr(cards[SCHEMES[0]].depthData,
                                              key)).max()))
            errs[(scheme, key)] = e
        loss = compute_radiative_losses(card)
        errs[(scheme, 'loss')] = float(
            (np.abs(loss - lossRef).max(axis=1)
             / np.abs(chiS).max(axis=1)).max()) if np.isfinite(
                 loss).all() else np.inf
    for scheme in SCHEMES:
        print(f'  {scheme}: chi {errs[(scheme, "chi")]:.2e}, eta '
              f'{errs[(scheme, "eta")]:.2e}, I {errs[(scheme, "I")]:.2e} '
              '(against the CPU and the default scheme), radiative losses '
              f'{errs[(scheme, "loss")]:.2e}')
    print(f'  launches: sweep {counts["sweep"]}, gamma {counts["gamma"]}, '
          f'fused {counts["fused"]} (bar {DEPTH_TOL})')
    for (scheme, key), e in errs.items():
        if not e <= DEPTH_TOL:
            raise AssertionError(f'depthData under {scheme}: {key} {e:.3e}')
    if not (counts['sweep'] == 2 and counts['gamma'] == 1
            and counts['fused'] == 1):
        raise AssertionError(f'depthData launches {counts}')
    return counts


def options_rest():
    """(d) Two MALI steps with stat_equil between each, card against CPU
    (KERNEL_TOL: J and I per wavelength, Gamma and the rates of each
    array's maximum, after the second step): falc_h6ca
    with a backgroundProvider wrapping basic_background that counts its
    calls (one per Context), with initSol=InitialSolution.Zero, and H 6
    active with a detailed Ca II atom."""
    from lightweaver_tpu_torch import InitialSolution
    from lightweaver_tpu_torch.atomic_set import RadiativeSet
    from lightweaver_tpu_torch.background import basic_background
    from lightweaver_tpu_torch.context import Context
    from lightweaver_tpu_torch.fal import Falc82
    from lightweaver_tpu_torch.problems import h6ca_context
    from lightweaver_tpu_torch.rh_atoms import CaII_atom, H_6_atom
    phase('Context options (d): backgroundProvider, initSol=Zero, a '
          'detailed Ca II atom; two MALI steps each, card against CPU')
    calls = []

    def provider(*args):
        calls.append(1)
        return basic_background(*args)

    def detailed(device):
        atmos = Falc82()
        atmos.quadrature(5)
        rs = RadiativeSet([H_6_atom(), CaII_atom()])
        rs.set_active('H')
        rs.set_detailed_static('Ca')
        return Context(atmos, rs.compute_wavelength_grid(),
                       rs.compute_eq_pops(atmos), device=device)
    makers = {
        'backgroundProvider': lambda d: h6ca_context(
            Falc82(), 5, device=d, backgroundProvider=provider),
        'initSol=Zero': lambda d: h6ca_context(
            Falc82(), 5, device=d, initSol=InitialSolution.Zero),
        'detailed Ca II': detailed}
    total = {}
    for label, make in makers.items():
        card, cpu = make('cuda'), make('cpu')
        reset_counts()
        for ctx in (card, cpu):
            ctx.formal_sol_gamma_matrices()
            ctx.stat_equil()
            ctx.formal_sol_gamma_matrices()
        torch.cuda.synchronize()
        counts = read_counts()
        errs = [float(rows_err(card.J, cpu.J).max()),
                float(rows_err(card.I, cpu.I).max())]
        for ai in range(len(cpu._Gamma)):
            errs.append(max_rel(card._Gamma[ai].cpu(), cpu._Gamma[ai]))
            for key in ('_Rij', '_Rji'):
                errs += [max_rel(x.cpu(), getattr(cpu, key)[ai][ti])
                         for ti, x in enumerate(getattr(card, key)[ai])]
        print(f'  {label}: J {errs[0]:.2e}, I {errs[1]:.2e}, Gamma and rates '
              f'{max(errs[2:]):.2e} (bar {KERNEL_TOL}); sweep launches '
              f'{counts["sweep"]}')
        if not (max(errs) <= KERNEL_TOL and counts['sweep'] == 2):
            raise AssertionError(f'{label}: card vs CPU {max(errs):.3e}, '
                                 f'launches {counts}')
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    if len(calls) != 2:
        raise AssertionError(f'backgroundProvider called {len(calls)} '
                             'times, once per Context expected')
    return total


def context_options():
    """Phase 15: the Context options on the card.  Returns each phase's
    launch counts (the path's own, each read just after it ran) and the
    hybrid-PRD run's ms per outer iteration."""
    hprd = options_hprd_f32()
    counts = [hprd['counts'], options_dense(), options_depth_data(),
              options_rest()]
    total = {k: sum(c.get(k, 0) for c in counts) for k in counts[0]}
    return {'launches': total, 'hprd_ms': hprd['ms']}


# ---- phase 16: distribution over ranks ----------------------------------
# the ranks of (a)-(c), all on this one card: NCCL refuses two ranks on
# one device, so they are joined by gloo (CUDA tensors staged through the
# host); (d) is NCCL at world size 1
DIST_RANKS = 2
# seconds each spawn may take before its ranks are killed
DIST_DEADLINE = 600
# (a) against phase 13 (c)'s default scheme after as many steps: the
# columns axis changes no column's arithmetic
DIST_BATCH_TOL = 1e-9
# (b) against phase 14's slab after SLAB_2D_ROLL_STEPS steps: the ring
# closure across ranks reassociates the affine compositions
DIST_SLAB_TOL = 1e-10
# (c) falc_h6ca-shaped columns on a (1, 2) mesh under each scheme: the
# Gamma of each of DIST_LAMBDA_STEPS steps against the unsharded batch's
# step from the same state (the lambda sums split in two; free-running,
# the first stat_equil takes their ~1e-16 to ~4e-10 of Gamma)
DIST_LAMBDA_C, DIST_LAMBDA_STEPS, DIST_LAMBDA_TOL = 8, 5, 1e-10
# under the default scheme (each scheme until phase 18, whose (a) runs
# every scheme on a wavelength mesh, needed the time)
DIST_LAMBDA_SCHEMES = ('mali_full_precond',)
# (d) a batch on a (1, 1) NCCL mesh against the same batch without one
DIST_NCCL_C, DIST_NCCL_STEPS = 64, 5


def _rank_entry(target, rank, world, workdir, args):
    """A spawned rank: target(rank, world, workdir, *args) with its result
    pickled to workdir/rank<r>.pkl, or its traceback to rank<r>.err and
    exit code 1.  A rank prints nothing."""
    import os
    import pickle
    import traceback
    base = Path(workdir) / f'rank{rank}'
    try:
        result = target(rank, world, workdir, *args)
        with open(f'{base}.pkl', 'wb') as f:
            pickle.dump(result, f, protocol=4)
    except BaseException:
        Path(f'{base}.err').write_text(traceback.format_exc())
        os._exit(1)


def spawn_ranks(target, world, args=()):
    """Run target on ``world`` spawned processes; kill them all when one
    fails or DIST_DEADLINE passes (then raise); return their results in
    rank order."""
    import multiprocessing as mp
    import pickle
    import tempfile
    workdir = tempfile.mkdtemp(prefix='chip_smoke_ranks_')
    ctx = mp.get_context('spawn')
    procs = [ctx.Process(target=_rank_entry,
                         args=(target, r, world, workdir, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DIST_DEADLINE
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f'{target.__name__}: the ranks ran past '
                                     f'{DIST_DEADLINE} s')
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        errs = [(Path(workdir) / f'rank{r}.err') for r in range(world)]
        errs = [f'rank {r}: {e.read_text()}' for r, e in enumerate(errs)
                if e.exists()]
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f'{target.__name__}: rank exit codes {codes}\n'
                             + '\n'.join(errs))
    out = []
    for r in range(world):
        with open(Path(workdir) / f'rank{r}.pkl', 'rb') as f:
            out.append(pickle.load(f))
    shutil.rmtree(workdir, ignore_errors=True)
    return out


def gamma_err(ours, ref):
    """max |ours - ref| / max(|ref|, 1e-10 max |ref|) over every atom's
    Gamma."""
    err = 0.0
    for a, b in zip(ours, ref):
        a, b = np.asarray(a), np.asarray(b)
        floor = 1e-10 * np.abs(b).max()
        err = max(err, float((np.abs(a - b) / np.maximum(np.abs(b), floor))
                             .max()))
    return err


def dist_rank(rank, world, workdir):
    """The ranks of phase 16 (a)-(c), joined by gloo with a file://
    rendezvous, each on the card.  Returns its numbers; rank 0 also the
    gathered states that the parent checks."""
    import torch.distributed as dist
    from lightweaver_tpu_torch.parallel import make_mesh
    from lightweaver_tpu_torch.parallel.multihost import initialize_multihost
    from lightweaver_tpu_torch.parallel.xshard2d import make_x_mesh
    from lightweaver_tpu_torch.problems import column_batch, slab_2d
    initialize_multihost(init_method=f'file://{workdir}/rendezvous',
                         num_processes=world, process_id=rank,
                         backend='gloo')
    out = {}

    # (a) phase 13's batch, each rank its block of columns
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh(world, 1)
    t0 = time.perf_counter()
    b = column_batch(BATCH_C, seed=BATCH_SEED, mesh=mesh)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    dist.barrier()
    reset_counts()
    t0 = time.perf_counter()
    b.iterate(NmaxIter=BATCH_SCHEME_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out['batch'] = {'Ncol': b.Ncol, 'setup': setup,
                    'ms': wall / BATCH_SCHEME_STEPS * 1e3,
                    'launches': {k: v for k, v in read_counts().items() if v},
                    'peak': torch.cuda.max_memory_allocated() / 2 ** 30}
    pops, J = b.pops, b.J
    if rank == 0:
        out['batch'].update(pops=pops, J=J)
    del b, pops, J
    torch.cuda.empty_cache()

    # (b) the 82 x 256 slab, each rank its block of x columns
    Nz, Nx, nq = SLAB_2D
    torch.cuda.reset_peak_memory_stats()
    xmesh = make_x_mesh(world)
    t0 = time.perf_counter()
    ctx = slab_2d(Nz, Nx, periodic=True, quadrature=nq,
                  formalSolver='piecewise_besser_2d', mesh=xmesh)
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    xs = ctx.cfg.xShard
    dist.barrier()
    reset_counts()
    n0 = xs.collectives
    dJ, sPerStep, _ = slab_2d_steps(ctx, SLAB_2D_ROLL_STEPS)
    out['slab'] = {'Nx': ctx.cfg.Nx, 'build': build, 'dJ': dJ,
                   'ms': sPerStep * 1e3,
                   'collectives': (xs.collectives - n0) / SLAB_2D_ROLL_STEPS,
                   'launches': {k: v for k, v in read_counts().items() if v},
                   'peak': torch.cuda.max_memory_allocated() / 2 ** 30}
    J = ctx.gather_x(ctx.J)
    if rank == 0:
        out['slab']['J'] = J.cpu().numpy()
    del ctx, J
    torch.cuda.empty_cache()

    # (c) the wavelength axis under each scheme, in lockstep: rank 0 runs
    # each step of the unsharded batch from the sharded batch's state
    lamMesh = make_mesh(1, world)
    out['lambda'] = {}
    for scheme in DIST_LAMBDA_SCHEMES:
        b = column_batch(DIST_LAMBDA_C, seed=BATCH_SEED, mesh=lamMesh,
                         fsIterScheme=scheme)
        u = (column_batch(DIST_LAMBDA_C, seed=BATCH_SEED,
                          fsIterScheme=scheme) if rank == 0 else None)
        errs, wall, counts = [], 0.0, {}
        for k in range(DIST_LAMBDA_STEPS):
            J = b._lam_rows(b.params['J'], 0)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            b.formal_sol_gamma_matrices()
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            for name, n in read_counts().items():
                if n:
                    counts[name] = counts.get(name, 0) + n
            if u is not None:
                u.params['J'] = J
                u.params['pops'] = list(b.params['pops'])
                u.formal_sol_gamma_matrices()
                errs.append(gamma_err([g.cpu().numpy() for g in b._Gamma],
                                      [g.cpu().numpy() for g in u._Gamma]))
            if k >= 3:
                b.stat_equil()
        out['lambda'][scheme] = {
            'ms': wall / DIST_LAMBDA_STEPS * 1e3, 'errs': errs,
            'rows': (b.cfg.lamLo, b.cfg.lamHi), 'launches': counts}
        del b, u
        torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()
    return out


def nccl_rank(rank, world, workdir):
    """Phase 16 (d): initialize_multihost(num_processes=1,
    backend='nccl'); all_reduce (sum, max, min), all_gather and broadcast
    of CUDA tensors through NCCL; a DIST_NCCL_C-column batch on the
    (1, 1) mesh against the same batch without a mesh."""
    import torch.distributed as dist
    from lightweaver_tpu_torch.parallel import multihost as mh
    from lightweaver_tpu_torch.problems import column_batch
    mh.initialize_multihost(num_processes=1, backend='nccl')
    x = torch.arange(1.0, 5.0, dtype=torch.float64, device='cuda')
    checks = {'backend': dist.get_backend()}
    for op in (dist.ReduceOp.SUM, dist.ReduceOp.MAX, dist.ReduceOp.MIN):
        y = x.clone()
        dist.all_reduce(y, op=op)
        checks[str(op)] = bool(torch.equal(y, x))
    ys = [torch.empty_like(x)]
    dist.all_gather(ys, x)
    y = x.clone()
    dist.broadcast(y, 0)
    checks['all_gather'] = bool(torch.equal(ys[0], x))
    checks['broadcast'] = bool(torch.equal(y, x))
    mesh = mh.global_mesh()
    bs = column_batch(DIST_NCCL_C, seed=BATCH_SEED, mesh=mesh)
    bu = column_batch(DIST_NCCL_C, seed=BATCH_SEED)
    for b in (bs, bu):
        b.iterate(NmaxIter=DIST_NCCL_STEPS)
    err = max(relerr(a, r) for a, r in zip(bs.pops, bu.pops))
    dist.destroy_process_group()
    return {'checks': checks, 'err': err, 'mesh': tuple(mesh.mesh.shape)}


def distribution(batchRef, slabRef):
    """Phase 16: the port's distribution (parallel/) on the card.  (a)
    BASELINE config 5's 1.5D leg, BATCH_C columns, on a (2, 1) mesh of
    two gloo ranks (half each), BATCH_SCHEME_STEPS steps from LTE
    (ColumnBatch.iterate): populations and J within DIST_BATCH_TOL of
    phase 13 (c)'s default scheme after as many steps, ms per batch step
    beside its.  (b) The 82 x 256 slab x-sharded over the two ranks
    (Context(mesh=), 128 columns each), SLAB_2D_ROLL_STEPS BESSER MALI
    steps with stat_equil: J per wavelength within DIST_SLAB_TOL of that
    wavelength's maximum against phase 14's single-rank slab after as
    many, ms per step and the collectives per step.  (c) DIST_LAMBDA_C
    falc_h6ca columns on a (1, 2) mesh under each scheme,
    DIST_LAMBDA_STEPS steps: the Gamma of each within DIST_LAMBDA_TOL of
    the unsharded batch's step from the same state.  (d) NCCL at world size 1 (nccl_rank).  Every rank
    runs on this card; one that fails or outlives DIST_DEADLINE fails the
    phase."""
    Nz, Nx, _ = SLAB_2D
    phase(f'distribution (a)-(c): {DIST_RANKS} gloo ranks on this card: '
          f'{BATCH_C} columns on a ({DIST_RANKS}, 1) mesh, the {Nz} x {Nx} '
          f'slab x-sharded, a (1, {DIST_RANKS}) wavelength mesh')
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f'  card memory before spawning: {free / 2**30:.1f} of '
          f'{total / 2**30:.1f} GiB free (single-rank peaks: the batch '
          f'35.5, the slab 24.0 GiB; each rank holds about half)')
    ranks = spawn_ranks(dist_rank, DIST_RANKS)
    r0 = ranks[0]

    a = r0['batch']
    errPops = max(relerr(p, q) for p, q in zip(a['pops'], batchRef['pops']))
    errJ = relerr(a['J'], batchRef['J'])
    print(f'  (a) {DIST_RANKS} ranks x {a["Ncol"]} columns: '
          f'{a["ms"]:.1f} ms per batch step (rank 1 '
          f'{ranks[1]["batch"]["ms"]:.1f}; phase 13 (c) on one rank '
          f'{batchRef["ms"]:.1f}), set-up {a["setup"]:.1f} s, peak '
          + ' / '.join(f'{r["batch"]["peak"]:.2f}' for r in ranks)
          + f' GiB per rank; launches per rank {a["launches"]}; after '
          f'{BATCH_SCHEME_STEPS} steps against phase 13: populations '
          f'{errPops:.2e}, J {errJ:.2e} (bar {DIST_BATCH_TOL})')
    if not (errPops < DIST_BATCH_TOL and errJ < DIST_BATCH_TOL):
        raise AssertionError(f'the sharded batch differs: pops {errPops}, '
                             f'J {errJ}')
    if a['launches'] != {'sweep': BATCH_SCHEME_STEPS}:
        raise AssertionError(f'the sharded batch launched {a["launches"]}')

    sl = r0['slab']
    J, ref = sl['J'], slabRef['J3']
    errSlab = float((np.abs(J - ref).max(axis=1)
                     / np.abs(ref).max(axis=1)).max())
    print(f'  (b) {DIST_RANKS} ranks x {sl["Nx"]} columns: {sl["ms"]:.1f} ms '
          f'per MALI step (rank 1 {ranks[1]["slab"]["ms"]:.1f}; phase 14 on '
          f'one rank {slabRef["ms_per_step"]:.1f}, stat_equil included), '
          f'{sl["collectives"]:.0f} all_gathers per step, Context built in '
          f'{sl["build"]:.1f} s, peak '
          + ' / '.join(f'{r["slab"]["peak"]:.2f}' for r in ranks)
          + f' GiB per rank; dJ ' + ' '.join(f'{d:.3g}' for d in sl['dJ'])
          + f'; J after {SLAB_2D_ROLL_STEPS} steps against phase 14 '
          f'{errSlab:.2e} of each wavelength\'s maximum (bar '
          f'{DIST_SLAB_TOL})')
    no_kernel_launched('the x-sharded slab', sl['launches'])
    if not errSlab <= DIST_SLAB_TOL:
        raise AssertionError(f'the x-sharded slab differs: {errSlab}')

    for scheme, res in r0['lambda'].items():
        print(f'  (c) {scheme}: rows {res["rows"]} of rank 0, '
              f'{res["ms"]:.1f} ms per MALI step, launches per rank '
              f'{res["launches"]} in {DIST_LAMBDA_STEPS} steps; Gamma of each '
              f'step against the unsharded step from the same state '
              + ' '.join(f'{e:.2e}' for e in res['errs'])
              + f' (bar {DIST_LAMBDA_TOL})')
        if not max(res['errs']) < DIST_LAMBDA_TOL:
            raise AssertionError(f'{scheme} on the wavelength mesh differs: '
                                 f'{res["errs"]}')
        if not res['launches']:
            raise AssertionError(f'{scheme} on the wavelength mesh launched '
                                 'no kernel')

    phase(f'distribution (d): NCCL at world size 1, {DIST_NCCL_C} columns '
          'on a (1, 1) mesh')
    (d,) = spawn_ranks(nccl_rank, 1)
    print(f'  backend {d["checks"]["backend"]}, mesh {d["mesh"]}; collectives '
          + ', '.join(f'{k} {v}' for k, v in d['checks'].items()
                      if k != 'backend')
          + f'; populations after {DIST_NCCL_STEPS} steps against no mesh '
          f'{d["err"]:.2e}')
    if not (all(v for k, v in d['checks'].items() if k != 'backend')
            and d['checks']['backend'] == 'nccl' and d['err'] < 1e-12):
        raise AssertionError(f'NCCL at world size 1: {d}')


# ---- phase 17: the MALI loop on the device --------------------------------
# JAX's iterate_on_device on falc_h6ca on the CPU (scripts/
# jax_on_device_iterations.py): 211 iterations, the host loop's count, with
# populations within 2.0e-10 of golden
OD_JAX_ITERS = 211
# the JAX package's tests/test_on_device_loop.py bars: populations against
# the host loop at another count; with Ng (same count); PRD (+- 2
# iterations, populations, rho)
OD_HOST_RTOL, OD_NG_RTOL = 5e-3, 1e-7
OD_PRD_SLACK, OD_PRD_POPS, OD_PRD_RHO = 2, 5e-3, 1e-3
# (d): falc_h6ca steps of both loops under each scheme, populations apart
# (10 since phase 18 needed the time; were 20)
OD_LOCKSTEP_STEPS, OD_LOCKSTEP_TOL = 10, 1e-9
# (f): iterations of each loop under torch.profiler and in sync-warn mode
# (2 since phase 18; were 5)
OD_PROFILED = 2


def od_atmos(Nspace, vlos=None):
    """FAL-C at np.unique(np.linspace(0, 81, Nspace).astype(int)) of its
    depths, 3 rays (tests/test_on_device_loop.py's setups)."""
    from lightweaver_tpu_torch import Atmosphere
    from lightweaver_tpu_torch.fal import Falc82
    full = Falc82()
    idx = np.unique(np.linspace(0, 81, Nspace).astype(int))
    atmos = Atmosphere(height=full.height[idx],
                       temperature=full.temperature[idx],
                       vlos=full.vlos[idx] if vlos is None else vlos,
                       vturb=full.vturb[idx], ne=full.ne[idx],
                       nHTot=full.nHTot[idx])
    atmos.quadrature(3)
    return atmos


def od_context(atoms, active, atmos, **kwargs):
    from lightweaver_tpu_torch import RadiativeSet
    from lightweaver_tpu_torch.context import Context
    rs = RadiativeSet([a() for a in atoms])
    rs.set_active(*active)
    return Context(atmos, rs.compute_wavelength_grid(),
                   rs.compute_eq_pops(atmos), device='cuda', **kwargs)


def host_loop(ctx, NmaxIter, Nscatter=3, JTol=5e-3, popsTol=1e-3):
    """The host-driven MALI loop of tests/test_on_device_loop.py (and of
    iterate_ctx_se without PRD): formal_sol_gamma_matrices, stat_equil
    past the Nscatter warm-up, dJ read each step; returns the steps."""
    for it in range(NmaxIter):
        ju = ctx.formal_sol_gamma_matrices()
        dJ = float(ju.dJMax)
        if it < Nscatter:
            continue
        pu = ctx.stat_equil()
        if dJ < JTol and pu.dPopsMax < popsTol:
            break
    return it + 1


def count_syncs(fn):
    """The synchronising CUDA operations ``fn`` issues: the warnings of
    torch.cuda.set_sync_debug_mode('warn')."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum('synchroniz' in str(w.message) for w in caught)


def od_falc_h6ca():
    """(a) falc_h6ca at full width (82 depths, H 6 + Ca II, 5 rays, f64,
    default scheme) through iterate_on_device to convergence: the JAX
    package's count (OD_JAX_ITERS) and, at the golden run's count, the
    populations within GOLDEN_RTOL of golden, else within OD_HOST_RTOL.
    The counts are set to 0 just before and read just after."""
    from lightweaver_tpu_torch.fal import Falc82
    from lightweaver_tpu_torch.problems import h6ca_context
    phase('on-device loop (a): falc_h6ca through iterate_on_device to '
          'convergence (default scheme, f64)')
    ctx = h6ca_context(Falc82(), 5, device='cuda')
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    nIter, dJ, dPops = ctx.iterate_on_device(NmaxIter=500)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    reads = ctx._odRunnerCache[1].reads
    ref = golden('falc_h6ca_ref')
    nRef = int(ref['out_niter'][0])
    bar = GOLDEN_RTOL if nIter == nRef else OD_HOST_RTOL
    errs = {f'pops_a{ia}': relerr(st['n'].cpu(), ref[f'out_pops_a{ia}'])
            for ia, st in enumerate(ctx.popsState)}
    print(f'converged in {nIter} iterations (JAX iterate_on_device '
          f'{OD_JAX_ITERS}, golden {nRef}), dJ {dJ:.3e}, dPops {dPops:.3e}; '
          f'{wall:.2f} s, {wall / (nIter + 1) * 1e3:.3f} ms per MALI step '
          f'(the final formal_sol_gamma_matrices counted); {reads} host '
          f'reads ({reads / nIter:.3f} per iteration); launches '
          + ', '.join(f'{k} {v}' for k, v in counts.items() if v))
    print('populations against golden: '
          + ', '.join(f'{k} {v:.3e}' for k, v in errs.items())
          + f' (bar {bar})')
    if nIter != OD_JAX_ITERS:
        raise AssertionError(f'{nIter} iterations, JAX {OD_JAX_ITERS}')
    if counts['sweep'] < nIter:
        raise AssertionError(f'sweep launched {counts["sweep"]} times in '
                             f'{nIter} iterations')
    if reads > nIter:
        raise AssertionError(f'{reads} host reads in {nIter} iterations')
    bad = {k: v for k, v in errs.items() if not v < bar}
    if bad:
        raise AssertionError(f'on-device falc_h6ca off golden: {bad}')
    return counts


def od_ng():
    """(b) tests/test_on_device_loop.py's 25-depth H 6 + Ca II (Ca
    active) problem with Ng(2, 5, 8): iterate_on_device against the host
    Ng loop, the same count and populations within OD_NG_RTOL."""
    from lightweaver_tpu_torch import CaII_atom, H_6_atom, NgOptions
    phase('on-device loop (b): 25 depths, Ca II active, Ng(2, 5, 8) '
          'against the host Ng loop')
    ng = NgOptions(2, 5, 8)
    atoms, active = (H_6_atom, CaII_atom), ('Ca',)
    ctxD = od_context(atoms, active, od_atmos(25))
    t0 = time.perf_counter()
    nDev, dJ, dPops = ctxD.iterate_on_device(NmaxIter=400, ngOptions=ng)
    torch.cuda.synchronize()
    tDev = time.perf_counter() - t0
    ctxH = od_context(atoms, active, od_atmos(25), ngOptions=ng)
    t0 = time.perf_counter()
    nHost = host_loop(ctxH, 400)
    torch.cuda.synchronize()
    tHost = time.perf_counter() - t0
    err = relerr(ctxD.popsState[0]['n'].cpu(), ctxH.popsState[0]['n'].cpu())
    print(f'on-device {nDev} iterations ({tDev:.2f} s), host Ng loop '
          f'{nHost} ({tHost:.2f} s); populations {err:.3e} apart (bar '
          f'{OD_NG_RTOL})')
    if nDev != nHost or not err < OD_NG_RTOL:
        raise AssertionError('on-device Ng differs from the host Ng loop')


def od_prd(hprd):
    """(c) tests/test_on_device_loop.py's H 6 PRD setup (30 depths,
    accelerateScattering, 10 sub-iterations to 2e-4) or its hybrid-PRD one
    (24 depths under an 8 km/s outflow, 6 to 1e-3): iterate_on_device
    (prd=True) against iterate_ctx_se(prd=True): iterations within
    OD_PRD_SLACK, populations OD_PRD_POPS, rho OD_PRD_RHO.  Returns the
    on-device run's launch counts."""
    from lightweaver_tpu_torch import H_6_atom, iterate_ctx_se
    name = 'hybrid PRD' if hprd else 'PRD'
    if hprd:
        Nspace, sub, tol = 24, 6, 1e-3
        vlos = 8e3 * np.linspace(0.0, 1.0, Nspace)[::-1]
    else:
        Nspace, sub, tol, vlos = 30, 10, 2e-4, None
    phase(f'on-device loop (c): H 6 {name}, {Nspace} depths, '
          f'{sub} sub-iterations to {tol}, against iterate_ctx_se(prd=True)')

    def setup():
        return od_context((H_6_atom,), ('H',), od_atmos(Nspace, vlos),
                          accelerateScattering=True, hprd=hprd)
    ctxD = setup()
    reset_counts()
    t0 = time.perf_counter()
    nDev, dJ, dPops = ctxD.iterate_on_device(
        NmaxIter=300, prd=True, maxPrdSubIter=sub, prdTol=tol)
    torch.cuda.synchronize()
    tDev = time.perf_counter() - t0
    counts = read_counts()
    reads = ctxD._odRunnerCache[1].reads
    ctxH = setup()
    t0 = time.perf_counter()
    nHost = iterate_ctx_se(ctxH, prd=True, NmaxIter=300, quiet=True,
                           maxPrdSubIter=sub, prdIterTol=tol)
    torch.cuda.synchronize()
    tHost = time.perf_counter() - t0
    ai, ti, _, _ = ctxD._prd_lines()[0]
    rhoDev = ctxD.rhoPrd[ai][ti].cpu().numpy()
    popsErr = float(np.abs(ctxD.popsState[0]['n'].cpu().numpy()
                           / ctxH.popsState[0]['n'].cpu().numpy()
                           - 1.0).max())
    rhoErr = float(np.abs(rhoDev - ctxH.rhoPrd[ai][ti].cpu().numpy()).max())
    print(f'on-device {nDev} iterations, {reads} host reads ({tDev:.2f} s, '
          f'{tDev / nDev * 1e3:.2f} ms/iter), host loop {nHost} '
          f'({tHost:.2f} s, {tHost / nHost * 1e3:.2f} ms/iter); populations '
          f'{popsErr:.3e} apart, rho {rhoErr:.3e} (max |rho - 1| '
          f'{np.abs(rhoDev - 1.0).max():.3f}); launches '
          + ', '.join(f'{k} {v}' for k, v in counts.items() if v))
    if not (dJ < 5e-3 and dPops < 1e-3 and np.isfinite(rhoDev).all()
            and (rhoDev > 0).all()):
        raise AssertionError(f'on-device {name} did not converge')
    if (abs(nDev - nHost) > OD_PRD_SLACK or not popsErr < OD_PRD_POPS
            or not rhoErr < OD_PRD_RHO):
        raise AssertionError(f'on-device {name} off the host loop')
    if hprd and not torch.isfinite(ctxD.JRest).all():
        raise AssertionError('non-finite JRest')
    # a sweep per MALI step, a subset kernel per PRD sub-iteration
    if (counts['sweep'] + counts['prd_subset'] < 2 * nDev
            or not counts['prd_subset']):
        raise AssertionError(f'sweep launched {counts["sweep"]} times, the '
                             f'subset kernel {counts["prd_subset"]}')
    return counts


def device_stepper(ctx):
    """One step of ctx's cached on-device loop with its stopping read, as
    iterate_on_device takes it, past the Lambda warm-up (for the
    profiler and the sync count)."""
    loop = ctx._odRunnerCache[1]
    state = [dict(loop.start(), it=loop.Nscatter)]

    def step(_ctx):
        state[0] = loop.step(state[0])
        loop.read_flag((state[0]['dJ'] >= 0.0) | (state[0]['dPops'] >= 0.0))
    return step


def od_lockstep(scheme):
    """(d) and (f): falc_h6ca under ``scheme``, OD_LOCKSTEP_STEPS steps of
    the host loop and of iterate_on_device (zero tolerances; the Lambda
    warm-up of 3 in both): populations within OD_LOCKSTEP_TOL; ms per
    MALI step, host reads (the loop's flags) and kernel launches per
    step, the synchronising operations per step (sync-warn mode) and
    scripts/torch_profile.py's kernels and idle share over OD_PROFILED
    steps of each loop under the default scheme (profiling the other
    schemes too took 40 s).  Returns (the on-device run's counts, the
    numbers)."""
    from lightweaver_tpu_torch.fal import Falc82
    from lightweaver_tpu_torch.problems import h6ca_context
    sys.path.insert(0, str(ROOT / 'scripts'))
    from torch_profile import profile_problem
    n = OD_LOCKSTEP_STEPS
    phase(f'on-device loop (d, f): falc_h6ca under {scheme}, {n} MALI steps '
          'of the host loop and of iterate_on_device')
    ctxs = []
    for _ in range(2):
        ctx = h6ca_context(Falc82(), 5, device='cuda')
        ctx.set_fs_iter_scheme(scheme)
        ctxs.append(ctx)
    ctxH, ctxD = ctxs
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    host_loop(ctxH, n, JTol=0.0, popsTol=0.0)
    torch.cuda.synchronize()
    tHost = time.perf_counter() - t0
    cHost = read_counts()
    reset_counts()
    t0 = time.perf_counter()
    nIter, _, _ = ctxD.iterate_on_device(NmaxIter=n, JTol=0.0, popsTol=0.0)
    torch.cuda.synchronize()
    tDev = time.perf_counter() - t0
    cDev = read_counts()
    reads = ctxD._odRunnerCache[1].reads
    errs = {f'pops_a{ia}': relerr(d['n'].cpu(), h['n'].cpu())
            for ia, (d, h) in enumerate(zip(ctxD.popsState, ctxH.popsState))}
    # the device loop's final formal_sol_gamma_matrices is a step too
    out = {'host_ms': tHost / n * 1e3, 'device_ms': tDev / (n + 1) * 1e3,
           'reads': reads / nIter,
           'host_launches': {k: v / n for k, v in cHost.items() if v},
           'device_launches': {k: v / (n + 1) for k, v in cDev.items() if v}}

    def host_step(ctx):
        u = ctx.formal_sol_gamma_matrices()
        float(u.dJMax)
        ctx.stat_equil()
    devStep = device_stepper(ctxD)
    out['host_syncs'] = count_syncs(
        lambda: [host_step(ctxH) for _ in range(OD_PROFILED)]) / OD_PROFILED
    out['device_syncs'] = count_syncs(
        lambda: [devStep(ctxD) for _ in range(OD_PROFILED)]) / OD_PROFILED
    idle = ''
    if scheme == SCHEMES[0]:
        out['host_profile'] = profile_problem(
            f'falc_h6ca host loop, {scheme}', ctxH, host_step,
            iters=OD_PROFILED)
        out['device_profile'] = profile_problem(
            f'falc_h6ca on-device loop, {scheme}', ctxD, devStep,
            iters=OD_PROFILED)
        idle = (f'; idle share host {out["host_profile"]["idle"]:.3f}, '
                f'on-device {out["device_profile"]["idle"]:.3f}')
    print(f'{scheme}: populations apart after {n} steps: '
          + ', '.join(f'{k} {v:.3e}' for k, v in errs.items())
          + f' (bar {OD_LOCKSTEP_TOL}); ms per MALI step host '
          f'{out["host_ms"]:.3f}, on-device {out["device_ms"]:.3f}; host '
          f'reads per iteration {out["reads"]:.3f} (on-device); '
          f'synchronising operations per step host {out["host_syncs"]:.1f}, '
          f'on-device {out["device_syncs"]:.1f}; launches per step host '
          + ', '.join(f'{k} {v:.2f}' for k, v in out['host_launches'].items())
          + '; on-device '
          + ', '.join(f'{k} {v:.2f}'
                      for k, v in out['device_launches'].items())
          + idle)
    if nIter != n:
        raise AssertionError(f'{nIter} on-device steps of {n}')
    bad = {k: v for k, v in errs.items() if not v < OD_LOCKSTEP_TOL}
    if bad:
        raise AssertionError(f'{scheme}: on-device loop off the host loop '
                             f'in lockstep: {bad}')
    kernel = {'mali_full_precond': 'sweep', PALLAS: 'gamma',
              FUSED: 'fused'}[scheme]
    if cDev[kernel] < nIter:
        raise AssertionError(f'{scheme}: {kernel} launched {cDev[kernel]} '
                             f'times in {nIter} on-device steps')
    if reads > nIter:
        raise AssertionError(f'{reads} host reads in {nIter} iterations')
    return cDev, out


def od_sync_free():
    """(e) One on-device body (DeviceLoop.step: the MALI step, the
    statistical-equilibrium solve, Ng's extrapolation, the PRD
    sub-iterations with their flag taken as 'go on' rather than read)
    per scheme with Ng(2, 3, 4) on falc_h6ca and with PRD (3
    sub-iterations) on falc_h6mg, and hybrid PRD under the default scheme
    on falc_h6mg with the outflow, each after an unchecked warm-up body,
    under torch.cuda.set_sync_debug_mode('error'): any synchronising CUDA
    operation raises."""
    from lightweaver_tpu_torch.context import DeviceLoop
    from lightweaver_tpu_torch.fal import Falc82
    from lightweaver_tpu_torch.ops.ng import NgOptions
    from lightweaver_tpu_torch.problems import h6ca_context, h6mg_context
    phase("on-device loop (e): one body per scheme under "
          "torch.cuda.set_sync_debug_mode('error')")
    cases = [('falc_h6ca', 'Ng(2, 3, 4)', lambda: h6ca_context(
                 Falc82(), 5, device='cuda'), SCHEMES, (2, 3, 4), False),
             ('falc_h6mg', 'PRD', lambda: h6mg_context(device='cuda'),
              SCHEMES, (0, 0, 0), True),
             ('falc_h6mg', 'hybrid PRD', lambda: h6mg_context(
                 hprd=True, device='cuda'), SCHEMES[:1], (0, 0, 0), True)]
    for problem, what, build, schemes, ng, prd in cases:
        ctx = build()
        for scheme in schemes:
            ctx.set_fs_iter_scheme(scheme)
            loop = DeviceLoop(ctx, 0, NgOptions(*ng), prd, 3, 0.0)
            s = loop.start()
            for checked in (False, True):
                # Ng's count at its first extrapolation (Ndelay 5)
                s['cnt'] = 4
                if checked:
                    torch.cuda.synchronize()
                    torch.cuda.set_sync_debug_mode('error')
                try:
                    s = loop.step(s, more=lambda flag: True)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            ok = all(bool(torch.isfinite(n).all()) for n in s['pops'])
            print(f'{problem} {what} under {scheme}: one body, no '
                  f'synchronising operation, {loop.reads} host reads, '
                  f'populations finite {ok}')
            if not ok or loop.reads:
                raise AssertionError(f'{problem} {what} {scheme}: body')


def od_benchmark():
    """(g) benchmark(Niter=10) on FALC-500 (lightweaver_tpu_torch's
    export): the precisions, the Gamma accumulation and the schemes, on
    the card; it supplies the FALC-500 ms/iter that phase 11 measured
    until phase 17 needed the time (with stage breakdowns, now
    dropped)."""
    from lightweaver_tpu_torch import benchmark
    phase('on-device loop (g): benchmark(Niter=10) on FALC-500')
    t0 = time.perf_counter()
    res = benchmark(Niter=10, verbose=True)
    print(f'benchmark: {time.perf_counter() - t0:.1f} s; timings (ms/iter) '
          + ', '.join(f'{m}/{p} {v * 1e3:.3f}'
                      for (m, p), v in res['timings'].items())
          + '; schemes at ' + '/'.join(res['best']) + ' '
          + ', '.join(f'{k} {v * 1e3:.3f}'
                      for k, v in res['schemeTimings'].items()))
    if not all(np.isfinite(v) and v > 0 for v in res['timings'].values()):
        raise AssertionError('benchmark timings')
    if set(res['schemeTimings']) != set(SCHEMES):
        raise AssertionError(f'benchmark raced {set(res["schemeTimings"])}')
    return res


def on_device_loop():
    """Phase 17: Context.iterate_on_device (a)-(g).  Returns the kernels'
    launches on the phase's main paths ((a), (c), the on-device runs of
    (d)) and (d, f)'s numbers per scheme."""
    launches = od_falc_h6ca()
    od_ng()
    for hprd in (False, True):
        for k, v in od_prd(hprd).items():
            launches[k] += v
    numbers = {}
    for scheme in SCHEMES:
        counts, numbers[scheme] = od_lockstep(scheme)
        for k, v in counts.items():
            launches[k] += v
    od_sync_free()
    bench = od_benchmark()
    return launches, numbers, bench


# ---- phase 18: distribution, the rest ------------------------------------
# (a) falc_h6mg's atoms (H 6 and Mg II active, PRD h&k, Ly-alpha and
# Ly-beta) on DIST_PRD_C FAL-C columns, a (1, 2) wavelength mesh, each of
# DIST_PRD_ROUNDS rounds (a MALI step, stat_equil, prd_redistribute(
# maxIter=3)) in lockstep with one rank's batch from the same state: rho
# per row of its window, J per wavelength, the populations per level
# (the lambda split reassociates Gamma's sums, which stat_equil and the
# rho sub-iterations amplify in the smallest values: elementwise 3.4e-9
# on the CPU rehearsal; tests/test_torch_distributed.py measured the
# rounds' own sensitivity)
DIST_PRD_C, DIST_PRD_ROUNDS, DIST_PRD_TOL = 8, 5, 1e-9
# (b) the 82 x 256 slab x-sharded: Ng on the populations for
# DIST_NG_STEPS MALI steps with stat_equil, then update_deps after T x
# 1.01 and one step, state_dict, compute_rays on a Ca II K window at mu =
# 1 and single_stokes_fs in problems.magnetise's field, each against the
# same calls on one rank.  Ng(2, 5, 8): one extrapolation in the 8 steps
# (the seventh); Ng(2, 3, 3) from LTE takes the slab's populations
# negative at its first extrapolation (-1.9e9 on an 82 x 8 slab on the
# CPU), which no comparison can use
DIST_NG, DIST_NG_STEPS = (2, 5, 8), 8
DIST_REST_TOL = 1e-9
# (b) the step whose radiation is the last before the extrapolation (the
# seventh MALI step, from populations of six plain solves: the seventh
# stat_equil extrapolates), held with the populations to DIST_REST_TOL;
# the x-sharded Context's Ng is the one-rank Ng run on the gathered
# populations, so what differs after it is what the extrapolation makes
# of the iterates' own differences
DIST_NG_PRE = 6
# (b) the radiation after Ng's extrapolation (the next step's J and I, the
# state's, compute_rays, Stokes), per wavelength: the emergent
# intensities form where the populations are smallest, whose elementwise
# differences the extrapolation amplifies most (it divides differences
# of near-equal iterates).  The bar was 1e-9 and was widened twice on
# the card: state I 1.05e-8, then state J 1.35e-9 (against the
# populations' 4.5e-13 per level) on an NVIDIA H100 80GB HBM3 at 700 W.
# tests/test_torch_xshard2d_options.py holds these calls without Ng to
# 1e-9.
DIST_NG_TOL = 1e-7
# (c) an 82 x 32 slab with H 6 active: charge conservation, PRD and
# hybrid PRD, DIST_H6_STEPS rounds each (2, cut from 5 for the phase's
# time: 3.0-3.7 s per PRD round per rank on an NVIDIA H100 80GB HBM3 at
# 700 W); (d) the 82 x 32 slab (Ca II active): DIST_OD_STEPS steps of
# iterate_on_device against the host loop
DIST_H6_SLAB, DIST_H6_STEPS, DIST_OD_STEPS = (82, 32), 2, 5
DIST_K_LAMBDA = 393.4     # nm: compute_rays' window about the Ca II K line


def rows_rel(a, b):
    """The largest difference in a row (first axis) over the row's
    largest value, the worst row."""
    a, b = np.asarray(a), np.asarray(b)
    a, b = a.reshape(len(b), -1), b.reshape(len(b), -1)
    return float((np.abs(a - b).max(axis=1) / np.abs(b).max(axis=1)).max())


def count_collectives():
    """Wrap torch.distributed's all_reduce and all_gather in this process
    with counters; returns the dict they count into."""
    import torch.distributed as dist
    counts = {'all_reduce': 0, 'all_gather': 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapper
    for name in counts:
        setattr(dist, name, counted(name, getattr(dist, name)))
    return counts


def prd_batch_state(b):
    """A batch's J of the whole grid, its populations, rho and JRest."""
    return {'J': b._lam_rows(b.params['J'], 0).clone(),
            'pops': [p.clone() for p in b.params['pops']],
            'rho': [[None if r is None else r.clone() for r in rs]
                    for rs in b.params['rhoPrd']],
            'JRest': None if b.JRest is None else b.JRest.clone()}


def set_prd_batch_state(b, st):
    b.params['J'] = st['J'].clone()
    b.params['pops'] = [p.clone() for p in st['pops']]
    for ai, rs in enumerate(st['rho']):
        for ti, r in enumerate(rs):
            if r is not None:
                b.params['rhoPrd'][ai][ti] = r.clone()
    b.JRest = None if st['JRest'] is None else st['JRest'].clone()


def prd_round(b):
    b.formal_sol_gamma_matrices()
    b.stat_equil()
    return b.prd_redistribute(maxIter=3, tol=0.0).NprdSubIter


def dist_rest_rank(rank, world, workdir):
    """Phase 18 (a)-(d) on two gloo ranks of this card: returns each
    case's numbers, rank 0's also the gathered states."""
    import torch.distributed as dist
    from lightweaver_tpu_torch import H_6_atom
    from lightweaver_tpu_torch.context import DeviceLoop
    from lightweaver_tpu_torch.ops import sweep
    from lightweaver_tpu_torch.ops.ng import NgOptions
    from lightweaver_tpu_torch.parallel import make_mesh
    from lightweaver_tpu_torch.parallel.multihost import initialize_multihost
    from lightweaver_tpu_torch.parallel.xshard2d import make_x_mesh
    from lightweaver_tpu_torch.problems import (column_batch,
                                                column_vlos_ramps, magnetise,
                                                slab_2d, stacked_falc)
    from lightweaver_tpu_torch.rh_atoms import MgII_atom
    initialize_multihost(init_method=f'file://{workdir}/rendezvous',
                         num_processes=world, process_id=rank,
                         backend='gloo')
    colls = count_collectives()
    out = {'t': {}}
    tRank = time.perf_counter()

    # (a) PRD and hybrid PRD on the wavelength axis
    lamMesh = make_mesh(1, world)
    vlos = column_vlos_ramps(stacked_falc(DIST_PRD_C, seed=BATCH_SEED)[0],
                             DIST_PRD_C)

    def h6mg(scheme, hprd, mesh):
        return column_batch(DIST_PRD_C, models=lambda: [H_6_atom(),
                                                        MgII_atom()],
                            activeSpecies=('H', 'Mg'), seed=BATCH_SEED,
                            vlos=vlos if hprd else None, mesh=mesh,
                            fsIterScheme=scheme, hprd=hprd)
    out['prd'] = {}
    for scheme, hprd in [(s, False) for s in SCHEMES] + [(SCHEMES[0], True)]:
        b = h6mg(scheme, hprd, lamMesh)
        u = h6mg(scheme, hprd, None) if rank == 0 else None
        lines = b.flatCtx._prd_lines()
        errs, wall, uWall, nSub = [], 0.0, 0.0, 0
        c0 = dict(colls)
        reset_counts()
        for k in range(DIST_PRD_ROUNDS):
            st = prd_batch_state(b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nSub += prd_round(b)
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            J, I = b._lam_rows(b.params['J'], 0), b._lam_rows(b._I, 1)
            counts = read_counts()
            if u is not None:
                set_prd_batch_state(u, st)
                t0 = time.perf_counter()
                prd_round(u)
                torch.cuda.synchronize()
                uWall += time.perf_counter() - t0
                e = {'rho': max(rows_rel(b.params['rhoPrd'][ai][ti].cpu(),
                                         u.params['rhoPrd'][ai][ti].cpu())
                                for ai, ti, a, t in lines),
                     'J': rows_rel(J.cpu(), u.params['J'].cpu()),
                     'pops': max(rows_rel(p.cpu(), q.cpu()) for p, q in
                                 zip(b.params['pops'], u.params['pops']))}
                if hprd:
                    e['JRest'] = rows_rel(b.JRest.cpu(), u.JRest.cpu())
                errs.append(e)
                set_counts(counts)
        res = {'ms': wall / DIST_PRD_ROUNDS * 1e3, 'errs': errs,
               'one_rank_ms': uWall / DIST_PRD_ROUNDS * 1e3,
               'rows': (b.cfg.lamLo, b.cfg.lamHi, len(b._prd_fs.rows)),
               'nSub': nSub,
               'launches': {k: v for k, v in read_counts().items() if v},
               'collectives': {k: (v - c0[k]) / DIST_PRD_ROUNDS
                               for k, v in colls.items()},
               'rhoDev': max(float((b.params['rhoPrd'][ai][ti] - 1.0).abs()
                                   .max()) for ai, ti, a, t in lines)}
        if scheme == SCHEMES[0] and not hprd and len(b._prd_fs.rows):
            # kernel 1 on this block's PRD rows, against its plain version
            args = b._prd_fs.sweep_inputs(b.params)
            kern = sweep.formal_solve_sweep(*args)
            plain = sweep.formal_solve_sweep_plain(*args)
            rel, absErr = compare_outputs('block PRD rows', RAY_NAMES,
                                          ray_outputs(kern),
                                          ray_outputs(plain), KERNEL_TOL)
            p1 = cuda_ms(lambda: sweep.formal_solve_sweep_plain(*args), 3)
            k1, k2 = kernel_device_ms(lambda: sweep.formal_solve_sweep(*args),
                                      SYMBOLS['sweep'])
            res['kernel'] = dict(ms=min(k1, k2), plain_ms=p1, rel=rel,
                                 max_abs_err=absErr, rows=len(args[0][0]),
                                 **sweep_bound(args, kern))
        out['prd'][(scheme, hprd)] = res
        del b, u
        torch.cuda.empty_cache()
    out['t']['a'] = time.perf_counter() - tRank

    # (b) the 82 x 256 slab x-sharded: Ng, update_deps, state_dict,
    # compute_rays, single_stokes_fs
    Nz, Nx, nq = SLAB_2D
    xmesh = make_x_mesh(world)
    ctx = slab_2d(Nz, Nx, periodic=True, quadrature=nq, mesh=xmesh,
                  ngOptions=NgOptions(*DIST_NG))
    out['slab'] = slab_rest(ctx, colls)
    if rank:
        # rank 0 returns the whole grid's arrays; the others their times
        out['slab'] = {k: out['slab'][k] for k in ('ms', 'stokes_peak')}
    del ctx
    torch.cuda.empty_cache()
    out['t']['b'] = time.perf_counter() - tRank

    # (c) the 82 x 32 H 6 slab: NR, PRD, hybrid PRD
    out['h6'] = {}
    for name, kw in DIST_H6_CASES.items():
        ctx = slab_2d(*DIST_H6_SLAB, mesh=xmesh, **kw)
        out['h6'][name] = h6_slab_rounds(ctx, name, colls)
        del ctx
    out['t']['c'] = time.perf_counter() - tRank

    # (d) iterate_on_device in lockstep with the host loop
    dev = slab_2d(*DIST_H6_SLAB, mesh=xmesh)
    host = slab_2d(*DIST_H6_SLAB, mesh=xmesh)
    reset_counts()
    t0 = time.perf_counter()
    nIt = dev.iterate_on_device(NmaxIter=DIST_OD_STEPS)[0]
    torch.cuda.synchronize()
    odMs = (time.perf_counter() - t0) / DIST_OD_STEPS * 1e3
    t0 = time.perf_counter()
    for it in range(DIST_OD_STEPS):
        host.formal_sol_gamma_matrices()
        if it >= 3:
            host.stat_equil()
    host.formal_sol_gamma_matrices()
    torch.cuda.synchronize()
    hostMs = (time.perf_counter() - t0) / DIST_OD_STEPS * 1e3
    out['od'] = {'nIter': nIt, 'ms': odMs, 'host_ms': hostMs,
                 'pops': relerr(dev.gather_x(dev.popsState[0]['n']).cpu(),
                                host.gather_x(host.popsState[0]['n']).cpu()),
                 'J': rows_rel(dev.gather_x(dev.J).cpu(),
                               host.gather_x(host.J).cpu()),
                 'launches': {k: v for k, v in read_counts().items() if v}}
    out['t']['d'] = time.perf_counter() - tRank
    dist.barrier()
    dist.destroy_process_group()
    return out


def set_counts(counts):
    """Put the launch counts back (rank 0's lockstep runs are not the
    sharded path's)."""
    for k, (fn, attr) in counters().items():
        setattr(fn, attr, counts[k])


DIST_H6_CASES = {
    'NR': {'activeSpecies': ('H',), 'conserveCharge': True},
    'PRD': {'activeSpecies': ('H',)},
    'hPRD': {'activeSpecies': ('H',), 'hprd': True},
}


def h6_slab_rounds(ctx, name, colls):
    """DIST_H6_STEPS rounds on an H 6 slab: a MALI step and stat_equil
    (with NR under 'NR'), prd_redistribute(maxIter=1) under PRD; the
    whole grid's populations, J, ne and rho, ms per round."""
    c0 = dict(colls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DIST_H6_STEPS):
        ctx.formal_sol_gamma_matrices()
        ctx.stat_equil()
        if name != 'NR':
            ctx.prd_redistribute(maxIter=1)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / DIST_H6_STEPS * 1e3
    return {'ms': ms, 'pops': ctx.gather_x(ctx.popsState[0]['n']).cpu()
            .numpy(), 'J': ctx.gather_x(ctx.J).cpu().numpy(),
            'ne': np.asarray(ctx.atmos.ne).copy(),
            'rho': [ctx.gather_x(ctx.rhoPrd[ai][ti]).cpu().numpy()
                    for ai, ti, a, t in ctx._prd_lines()],
            'collectives': {k: (v - c0[k]) / DIST_H6_STEPS
                            for k, v in colls.items()}}


def slab_rest(ctx, colls=None):
    """Phase 18 (b)'s calls on the 82 x 256 slab (x-sharded or on one
    rank): DIST_NG_STEPS MALI steps with stat_equil (Ng), update_deps
    after T x 1.01 and one more MALI step, state_dict, compute_rays on the K
    window at mu = 1, then single_stokes_fs in problems.magnetise's
    field; the whole grid's results and ms of each."""
    from lightweaver_tpu_torch.problems import magnetise
    out, ms = {}, {}
    def radiation():
        return {'J': ctx.gather_x(ctx.J).cpu().numpy(),
                'I': ctx.gather_x(ctx.I).cpu().numpy(),
                'pops': ctx.gather_x(ctx.popsState[0]['n']).cpu().numpy()}
    c0 = dict(colls) if colls is not None else None
    acc, wall = [], 0.0
    for k in range(DIST_NG_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx.formal_sol_gamma_matrices()
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        if k in (DIST_NG_PRE, DIST_NG_PRE + 1):
            # outside the timing and the collectives' count
            cs = dict(colls) if colls is not None else None
            out['pre_ng' if k == DIST_NG_PRE else 'post_ng'] = radiation()
            if cs is not None:
                colls.update(cs)
        t0 = time.perf_counter()
        acc.append(ctx.stat_equil().ngAccelerated)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
    ms['step'] = wall / DIST_NG_STEPS * 1e3
    if c0 is not None:
        out['collectives'] = {k: (v - c0[k]) / DIST_NG_STEPS
                              for k, v in colls.items()}
    out['accelerated'] = acc
    out['ng_pops'] = ctx.gather_x(ctx.popsState[0]['n']).cpu().numpy()
    ctx.atmos.temperature *= 1.01
    t0 = time.perf_counter()
    ctx.update_deps()
    torch.cuda.synchronize()
    ms['update_deps'] = (time.perf_counter() - t0) * 1e3
    # the MALI step on the new atmosphere; no stat_equil, whose Ng would
    # extrapolate from iterates of two atmospheres
    ctx.formal_sol_gamma_matrices()
    t0 = time.perf_counter()
    st = ctx.state_dict()
    ms['state_dict'] = (time.perf_counter() - t0) * 1e3
    out['state'] = {'J': st['J'], 'I': st['I'], 'pops': st['pops'][0],
                    'nStar': st['nStar'][0]}
    lam0 = min((t.lambda0 for a in ctx.cfg.activeAtoms for t in a.trans
                if t.isLine), key=lambda l0: abs(l0 - DIST_K_LAMBDA))
    t0 = time.perf_counter()
    out['rays'] = ctx.compute_rays(np.linspace(lam0 - 0.1, lam0 + 0.1, 41),
                                   mus=[1.0])
    torch.cuda.synchronize()
    ms['compute_rays'] = (time.perf_counter() - t0) * 1e3
    magnetise(ctx.atmos)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctx.single_stokes_fs()
    torch.cuda.synchronize()
    ms['stokes'] = (time.perf_counter() - t0) * 1e3
    out['stokes_peak'] = torch.cuda.max_memory_allocated() / 2 ** 30
    out['I'] = ctx.gather_x(ctx.I).cpu().numpy()
    out['Quv'] = ctx.gather_x(ctx.Quv).cpu().numpy()
    out['ms'] = ms
    return out


def od_nccl_rank(rank, world, workdir):
    """Phase 18 (d), NCCL at world size 1: one on-device body (Ng's first
    extrapolation) of the x-sharded 82 x 32 slab under
    torch.cuda.set_sync_debug_mode('error'), after an unchecked one."""
    import torch.distributed as dist
    from lightweaver_tpu_torch.context import DeviceLoop
    from lightweaver_tpu_torch.ops.ng import NgOptions
    from lightweaver_tpu_torch.parallel import multihost as mh
    from lightweaver_tpu_torch.parallel.xshard2d import make_x_mesh
    from lightweaver_tpu_torch.problems import slab_2d
    mh.initialize_multihost(num_processes=1, backend='nccl')
    ctx = slab_2d(*DIST_H6_SLAB, mesh=make_x_mesh(1))
    loop = DeviceLoop(ctx, 0, NgOptions(2, 3, 4), False, 3, 0.0)
    s = loop.start()
    for checked in (False, True):
        s['cnt'] = 4
        if checked:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode('error')
        try:
            s = loop.step(s, more=lambda flag: True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    ok = all(bool(torch.isfinite(n).all()) for n in s['pops'])
    backend = dist.get_backend()
    dist.destroy_process_group()
    return {'backend': backend, 'finite': ok, 'reads': loop.reads}


def distribution_rest():
    """Phase 18: the rest of the distribution on the card, two gloo ranks
    sharing it as in phase 16.  (a) falc_h6mg's atoms on DIST_PRD_C
    columns on a (1, 2) wavelength mesh, PRD under each scheme and hybrid
    PRD, in lockstep with one rank (DIST_PRD_TOL), kernel 1 on the PRD
    rows of its block against its plain version, its launches per block;
    (b) the 82 x 256 slab x-sharded with Ng, update_deps, state_dict,
    compute_rays and single_stokes_fs against one rank; (c) NR, PRD and
    hybrid PRD on an 82 x 32 H 6 slab against one rank; (d)
    iterate_on_device against the host loop on the 82 x 32 slab, and one
    body under NCCL at world size 1 with no synchronising operation.
    Returns kernel 1's record on the block and its launches."""
    from lightweaver_tpu_torch.ops.ng import NgOptions
    from lightweaver_tpu_torch.problems import slab_2d
    Nz, Nx, nq = SLAB_2D
    phase(f'distribution, the rest (a)-(c): one-rank references (the '
          f'{Nz} x {Nx} slab with Ng{DIST_NG}, the {DIST_H6_SLAB} H 6 '
          'slabs)')
    ctx = slab_2d(Nz, Nx, periodic=True, quadrature=nq,
                  ngOptions=NgOptions(*DIST_NG))
    slabRef = slab_rest(ctx)
    del ctx
    torch.cuda.empty_cache()
    h6Ref = {}
    for name, kw in DIST_H6_CASES.items():
        h6Ref[name] = h6_slab_rounds(slab_2d(*DIST_H6_SLAB, **kw), name,
                                     {'all_reduce': 0, 'all_gather': 0})
    torch.cuda.empty_cache()
    print('  one rank: ' + ', '.join(f'{k} {v:.1f} ms' for k, v in
                                     slabRef['ms'].items())
          + f' (slab); ' + ', '.join(f'{k} {v["ms"]:.1f} ms per round'
                                     for k, v in h6Ref.items())
          + f'; single_stokes_fs peak {slabRef["stokes_peak"]:.2f} GiB')

    phase(f'distribution, the rest (a)-(d): {DIST_RANKS} gloo ranks on '
          f'this card: {DIST_PRD_C} falc_h6mg columns on a (1, '
          f'{DIST_RANKS}) mesh, the slabs x-sharded')
    ranks = spawn_ranks(dist_rest_rank, DIST_RANKS)
    r0 = ranks[0]
    print('  rank 0 reached the end of (a)-(d) at ' + ', '.join(
        f'{k} {v:.1f} s' for k, v in r0['t'].items()))
    launches = 0
    record = None
    for (scheme, hprd), res in r0['prd'].items():
        label = f'{scheme}{" hPRD" if hprd else ""}'
        worst = {k: max(e[k] for e in res['errs']) for k in res['errs'][0]}
        blocks = [r['prd'][(scheme, hprd)] for r in ranks]
        print(f'  (a) {label}: rows {[b["rows"] for b in blocks]} (first, '
              f'end, PRD subset rows) per rank, {res["ms"]:.1f} ms per round '
              f'(rank 1 {blocks[1]["ms"]:.1f}; one rank '
              f'{res["one_rank_ms"]:.1f}), {res["nSub"]} sub-iterations, '
              'collectives per round ' + ', '.join(
                  f'{k} {v:.1f}' for k, v in res['collectives'].items())
              + f'; launches per rank {[b["launches"] for b in blocks]}; '
              f'max |rho - 1| {res["rhoDev"]:.2f}; worst round against one '
              f'rank ' + ', '.join(f'{k} {v:.2e}' for k, v in worst.items())
              + f' (bar {DIST_PRD_TOL})')
        if not all(v < DIST_PRD_TOL for v in worst.values()):
            raise AssertionError(f'{label} on the wavelength mesh: {worst}')
        if not res['rhoDev'] > 0.1:
            raise AssertionError(f'{label}: rho stayed at 1')
        for b in blocks:
            launches += b['launches'].get('sweep', 0)
            if 'kernel' in b and (record is None
                                  or b['kernel']['rows'] > record['rows']):
                record = b['kernel']
        if scheme == SCHEMES[0] and sum(b['launches'].get('sweep', 0)
                                        for b in blocks) == 0:
            raise AssertionError(f'{label}: no sweep launched')
    if record is None:
        raise AssertionError('no rank timed kernel 1 on its PRD rows')
    print(f'  (a) kernel 1 on a block\'s {record["rows"]} PRD rows: '
          f'{record["ms"]:.4f} ms, plain {record["plain_ms"]:.4f} ms, bound '
          f'{record["bound_ms"]:.4g} ms by {record["bound_by"]}; against '
          f'plain {record["rel"]:.2e} (bar {KERNEL_TOL})')

    sl = r0['slab']
    errs = {'pre-Ng pops': rows_rel(sl['pre_ng']['pops'],
                                    slabRef['pre_ng']['pops']),
            'pre-Ng J': rows_rel(sl['pre_ng']['J'], slabRef['pre_ng']['J']),
            'pre-Ng I': rows_rel(sl['pre_ng']['I'], slabRef['pre_ng']['I']),
            'ng_pops': rows_rel(sl['ng_pops'], slabRef['ng_pops']),
            'state pops': rows_rel(sl['state']['pops'],
                                   slabRef['state']['pops']),
            'state nStar': relerr(sl['state']['nStar'],
                                  slabRef['state']['nStar'])}
    emergent = {'post-Ng J': rows_rel(sl['post_ng']['J'],
                                      slabRef['post_ng']['J']),
                'post-Ng I': rows_rel(sl['post_ng']['I'],
                                      slabRef['post_ng']['I']),
                'state J': rows_rel(sl['state']['J'], slabRef['state']['J']),
                'state I': rows_rel(sl['state']['I'], slabRef['state']['I']),
                'rays': rows_rel(sl['rays'], slabRef['rays']),
                'Stokes I': rows_rel(sl['I'], slabRef['I'])}
    amp = np.abs(slabRef['I']).max(axis=(1, 2))[None, :, None, None]
    emergent['Stokes QUV'] = float((np.abs(sl['Quv'] - slabRef['Quv'])
                                    / amp).max())
    print(f'  (b) {Nz} x {Nx} slab on {DIST_RANKS} ranks: '
          + ', '.join(f'{k} {v:.1f} ms' for k, v in sl['ms'].items())
          + f' (rank 1 step {ranks[1]["slab"]["ms"]["step"]:.1f}); '
          f'Ng extrapolated at steps {np.flatnonzero(sl["accelerated"])} '
          f'(one rank {np.flatnonzero(slabRef["accelerated"])}); '
          'collectives per step '
          + ', '.join(f'{k} {v:.1f}' for k, v in sl['collectives'].items())
          + f'; single_stokes_fs peak per rank '
          + ' / '.join(f'{r["slab"]["stokes_peak"]:.2f}' for r in ranks)
          + ' GiB; against one rank ' + ', '.join(
              f'{k} {v:.2e}' for k, v in errs.items())
          + f' (bar {DIST_REST_TOL}; populations per level, radiation '
          'per wavelength), '
          + ', '.join(f'{k} {v:.2e}' for k, v in emergent.items())
          + f' (bar {DIST_NG_TOL}, per wavelength)')
    if not (all(v < DIST_REST_TOL for v in errs.values())
            and all(v < DIST_NG_TOL for v in emergent.values())
            and sl['accelerated'] == slabRef['accelerated']
            and np.flatnonzero(sl['accelerated']).tolist()
            == [DIST_NG_PRE]):
        raise AssertionError(f'the x-sharded slab differs: {errs}, '
                             f'{emergent}')

    for name, res in r0['h6'].items():
        ref = h6Ref[name]
        e = {'pops': relerr(res['pops'], ref['pops']),
             'J': rows_rel(res['J'], ref['J']),
             'ne': relerr(res['ne'], ref['ne'])}
        if res['rho']:
            # per row of the window, as in (a)
            e['rho'] = max(rows_rel(a, b) for a, b in zip(res['rho'],
                                                           ref['rho']))
        print(f'  (c) {DIST_H6_SLAB} H 6 slab, {name}: {res["ms"]:.1f} ms '
              f'per round (rank 1 {ranks[1]["h6"][name]["ms"]:.1f}; one '
              f'rank {ref["ms"]:.1f}), collectives per round '
              + ', '.join(f'{k} {v:.1f}' for k, v in
                          res['collectives'].items())
              + '; against one rank ' + ', '.join(f'{k} {v:.2e}'
                                                  for k, v in e.items())
              + f' (bar {DIST_REST_TOL})')
        if not all(v < DIST_REST_TOL for v in e.values()):
            raise AssertionError(f'the x-sharded H 6 slab ({name}): {e}')

    od = r0['od']
    print(f'  (d) iterate_on_device, {od["nIter"]} steps: {od["ms"]:.1f} '
          f'ms per step (host loop {od["host_ms"]:.1f}); against the host '
          f'loop: populations {od["pops"]:.2e}, J {od["J"]:.2e} (bar '
          f'{DIST_REST_TOL}); launches {od["launches"]}')
    if not (od['nIter'] == DIST_OD_STEPS and od['pops'] < DIST_REST_TOL
            and od['J'] < DIST_REST_TOL):
        raise AssertionError(f'the x-sharded on-device loop: {od}')
    no_kernel_launched('the x-sharded on-device loop', od['launches'])

    phase('distribution, the rest (d): one on-device body of the x-sharded '
          "slab under NCCL at world size 1, set_sync_debug_mode('error')")
    (d,) = spawn_ranks(od_nccl_rank, 1)
    print(f'  backend {d["backend"]}, populations finite {d["finite"]}, '
          f'{d["reads"]} host reads, no synchronising operation')
    if not (d['backend'] == 'nccl' and d['finite'] and d['reads'] == 0):
        raise AssertionError(f'the NCCL body: {d}')
    return dict(record, launches=launches)


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
    'sweep_linear': ('lightweaver_tpu_torch/csrc/sweep.cu',
                     'lightweaver_tpu/ops/pallas_sweep.py:297'),
    'sweep_besser': ('lightweaver_tpu_torch/csrc/sweep.cu',
                     'lightweaver_tpu/ops/pallas_sweep.py:297'),
    'sweep_linear_f32': ('lightweaver_tpu_torch/csrc/sweep.cu',
                         'lightweaver_tpu/ops/pallas_sweep.py:297'),
    'sweep_besser_f32': ('lightweaver_tpu_torch/csrc/sweep.cu',
                         'lightweaver_tpu/ops/pallas_sweep.py:297'),
    'probe_elementwise': ('lightweaver_tpu_torch/csrc/probe.cu',
                          'scripts/pallas_probe.py:28'),
    'probe_recurrence': ('lightweaver_tpu_torch/csrc/probe.cu',
                         'scripts/pallas_probe.py:57'),
    'sweep2d': ('lightweaver_tpu_torch/csrc/sweep2d.cu',
                'none: lightweaver_tpu/ops/formal_solver2d.py leaves the '
                'plane sweep to XLA'),
    'sweep2d_f32': ('lightweaver_tpu_torch/csrc/sweep2d.cu',
                    'none: lightweaver_tpu/ops/formal_solver2d.py leaves '
                    'the plane sweep to XLA'),
    'prd_scatter': ('lightweaver_tpu_torch/csrc/prd_scatter.cu',
                    'none: lightweaver_tpu/ops/prd.py leaves the PRD '
                    'scattering integral to XLA'),
    'prd_subset': ('lightweaver_tpu_torch/csrc/prd_subset.cu',
                   'none: lightweaver_tpu/context.py assembles the PRD '
                   'subset rows in XLA before its sweep kernel'),
}
SCHEMES = ('mali_full_precond', PALLAS, FUSED)


def main():
    tStart = time.perf_counter()
    smi = environment()
    build_kernels()
    probes = probe_check()
    kernel_check()
    scheme_kernel_check()
    nrCtx, schemeRef = main_path()
    raysMs = readme_rays(nrCtx)
    scheme_paths(schemeRef)
    callable_bc_check()
    prdKern = prd_kernel_check()
    launches = prd_paths()
    multi_ng_kernel_check()
    _, snap = converge_multi_ng(SCHEMES[0])
    for scheme in SCHEMES[1:]:
        converge_multi_ng(scheme, NG_SCHEME_STEPS, snap)
    multi_ng_early_ng_raises()
    nr_check(nrCtx)
    del nrCtx
    phase('falc_ca_timedep (Ca II active, f64): the golden backward-Euler '
          'protocol under each scheme')
    for scheme in SCHEMES:
        timedep_check(scheme)
    escape_check()
    solverKern = solver_kernel_check()
    solverLaunches = {}
    for solver in SOLVERS[::2]:
        solverLaunches[sweep_name(solver, torch.float64)] = converge_solver(
            solver, LINEAR_STEPS)
    phase('synthesis (c): the mixed-precision problem (40 depths, 3 rays, '
          'Ca II active) in float32 under the linear and BESSER solvers')
    for solver in SOLVERS[::2]:
        solverLaunches[sweep_name(solver, F32)] = solver_steps_f32(solver)
    stokesMs = stokes_golden()
    pickle_check()
    f32Kern = f32_kernel_check()
    phase('mixed-precision problem (40 depths, 3 rays, Ca II active) in '
          'float32 under each scheme')
    converge_mixed(SCHEMES[0])
    for scheme in SCHEMES[1:]:
        converge_mixed(scheme, F32_SOLVER_STEPS)
    phase('falc_h6ca at full width in float32 under each scheme, '
          f'NmaxIter = {F32_FULL_ITERS}')
    f32Launches = dict.fromkeys(F32_NAMES, 0)
    for scheme in SCHEMES:
        counts = falc_h6ca_f32(scheme)
        for k in F32_NAMES:
            f32Launches[k] += counts[k]
    batch_kernel_check()
    batchRef = batch_schemes(batch_converged())
    batch_prd()
    # phase 14, 2D: the plane sweep kernel (the JAX package runs no Pallas
    # kernel there), each run checked to launch it and no other csrc/ one
    golden2dMs = [golden_2d(*g) for g in GOLDEN_2D]
    slab = slab_2d_real()
    syn2d = card_cpu_2d()
    # phase 15, the Context options: the sweep (f64, f32), line Gamma and
    # fused kernels on their paths
    options = context_options()
    # phase 16, distribution: ranks in processes of their own, against
    # phases 13 and 14
    distribution(batchRef, slab)
    del batchRef
    # phase 17, the MALI loop on the device; its benchmark gives the
    # FALC-500 ms/iter
    odLaunches, odNumbers, bench = on_device_loop()
    # phase 18, the rest of the distribution: kernel 1 on a wavelength
    # block's PRD rows
    blockPrd = distribution_rest()
    # the kernels' record: the float64 instances on the PRD path (phase 8's
    # launches, phase 7's inputs), the float32 ones on falc_h6ca's float32
    # path (phase (c)'s launches, phase (a)'s inputs), the probes; phase
    # 15's launches added to each instance's
    records = {name: dict(prdKern[name], launches=launches[name])
               for name in ('sweep', 'gamma', 'fused', 'prd_scatter',
                            'prd_subset')}
    records.update({name: dict(f32Kern[name], launches=f32Launches[name])
                    for name in F32_NAMES})
    records.update({name: dict(solverKern[name], launches=n)
                    for name, n in solverLaunches.items()})
    records.update(slab['kernels'])
    records.update(probes)
    for name, n in list(options['launches'].items()) + list(
            odLaunches.items()) + [('sweep', blockPrd['launches'])]:
        if name in records:
            records[name]['launches'] += n
    print(f'synthesis: compute_rays (the README program, 1001 wavelengths, '
          f'mu = 1) {raysMs:.1f} ms, single_stokes_fs (BASELINE config 4) '
          f'{stokesMs:.1f} ms')
    print(f'2D: falc2d_ca {golden2dMs[0]:.1f} (linear) / '
          f'{golden2dMs[1]:.1f} (BESSER) ms/iter; slab_2d{SLAB_2D[:2]} '
          f'{slab["ms_per_step"]:.1f} ms per MALI step, peak '
          f'{slab["peak_gib"]:.2f} GiB, {slab["profile"]["kernels"]:.0f} '
          f'kernels per step, idle share {slab["profile"]["idle"]:.3f}, '
          'stages ' + ', '.join(f'{k} {v:.1f} ms'
                                for k, v in slab['stages_ms'].items())
          + f'; single_stokes_fs {syn2d["stokes_ms"]:.1f} ms, compute_rays '
          f'{syn2d["rays_ms"]:.1f} ms')
    print(f'Context options: falc_h6mg hybrid PRD in float32 '
          f'{options["hprd_ms"]:.1f} ms per outer iteration; launches '
          + ', '.join(f'{k} {v}' for k, v in options['launches'].items()
                      if v))
    prof = odNumbers[SCHEMES[0]]
    print('on-device loop: ' + '; '.join(
        f'{s}: {v["device_ms"]:.1f} ms per MALI step against the host '
        f'loop\'s {v["host_ms"]:.1f}, {v["reads"]:.2f} host reads per '
        f'iteration' for s, v in odNumbers.items())
        + f'; idle share {prof["device_profile"]["idle"]:.3f} against '
        f'{prof["host_profile"]["idle"]:.3f} ({SCHEMES[0]})'
        + '; launches ' + ', '.join(f'{k} {v}' for k, v in odLaunches.items()
                                    if v))
    print('FALC-500 (benchmark): ' + ', '.join(
        f'{m}/{p} {v * 1e3:.3f}' for (m, p), v in bench['timings'].items())
        + ' ms/iter; ' + ', '.join(f'{k} {v * 1e3:.3f}' for k, v in
                                   bench['schemeTimings'].items())
        + f' ms/iter at {"/".join(bench["best"])}')
    print(f'distribution: kernel 1 on a wavelength block\'s '
          f'{blockPrd["rows"]} PRD rows {blockPrd["ms"]:.4f} ms (plain '
          f'{blockPrd["plain_ms"]:.4f}, bound {blockPrd["bound_ms"]:.4g} ms '
          f'by {blockPrd["bound_by"]}), {blockPrd["launches"]} launches on '
          'the two blocks')
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
