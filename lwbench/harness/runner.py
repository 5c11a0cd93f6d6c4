"""One run of one cell: set-up, the measured window, the traced steps,
the check against the reference, and the result line.  What differs by
the configuration's kind (the inputs, the system, the compared units,
the shapes, the harness spans it opens, the reference and its numbers)
comes from its module lwbench/kinds/<kind>.py (manifest.kind_path).

Set-up (``setup_s``, from process start): the inputs from the seed, the
program's system built on the device, and the warm-up with the cell's
own shapes only: the Nscatter formal solutions and one MALI step (the
first run of a checkout also builds the kernels then).  The window then
runs MALI steps until ``seconds`` have passed; where every column (or
the slab) has converged, the system goes back to its LTE start, without
repeating the set-up, and its Nscatter steps count in the window.  A
traced run then profiles ``trace_steps`` steps with the harness's spans
(harness/trace.py), and after them runs as many steps twice more with the
program's own tracer on (harness/program_trace.py:measure), untimed.
"""
import gc
import subprocess
import sys
import time
from contextlib import nullcontext

import torch

from . import check, manifest, program_trace, trace as traceMod
from .record import Record
from .spans import Spans, stages_wrapped
from .systems import DTYPES

JAX_NAMES = ('jax', 'jaxlib', 'flax', 'lightweaver_tpu')


def log(t0: float, what: str):
    print(f'[{time.perf_counter() - t0:8.2f} s] {what}', file=sys.stderr,
          flush=True)


def jax_modules() -> list:
    """Modules whose top-level name is one of JAX_NAMES (compared whole:
    lightweaver_tpu_torch is not lightweaver_tpu)."""
    return sorted(m for m in list(sys.modules)
                  if m.split('.', 1)[0] in JAX_NAMES)


def card() -> dict:
    """The card's name, count and power limit (nvidia-smi)."""
    out = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
           'count': 1}
    try:
        res = subprocess.run(['nvidia-smi', '--query-gpu=power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=60)
        out['power_limit'] = res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out['power_limit'] = 'not read'
    return out


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             root=manifest.ROOT, device='cuda', dtype=None, t0=None,
             fault=None) -> dict:
    """Run cell ``name`` once; returns the result dict (without the JAX
    check, which the caller makes last).  ``dtype`` overrides the
    configuration's precision (the control); ``fault(system)``, if
    given, breaks the built system underneath (the tests)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = manifest.load_cell(name, root)
    config, traffic, settings = cell.config, cell.traffic, cell.settings
    kind = cell.kind
    dtypeName = dtype or config['precision']
    dev = torch.device(device)
    cuda = dev.type == 'cuda'
    about = card() if cuda else {'platform': 'cpu', 'kind': 'cpu',
                                 'count': 1}

    inputs = kind.make_inputs(config, seed)
    units = kind.check_units(config, settings, seed)
    spans = Spans(dev)
    system = kind.System(config, traffic, inputs, dev, DTYPES[dtypeName],
                         units)
    log(t0, f'{name}: seed {seed}, {dtypeName}, system built')
    if fault is not None:
        fault(system)
    system.scatter_steps()
    system.mali_step(spans)
    first = [u[1] for u in system.units(system.keep())]
    spans.sync()
    setup = time.perf_counter() - t0
    log(t0, 'warm-up done: set-up over')
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    steps = colIters = 0
    with stages_wrapped(spans) if traced else nullcontext():
        spans.mode = 'timed' if traced else 'off'
        tw = time.perf_counter()
        while True:
            if system.all_converged():
                system.restart()
                system.scatter_steps()
            kept = system.keep()
            colIters += system.mali_step(spans)
            steps += 1
            if time.perf_counter() - tw >= seconds:
                break
        spans.sync()
        window = time.perf_counter() - tw
        spans.mode = 'off'
        windowPeak = torch.cuda.max_memory_allocated(dev) if cuda else None
        prof = program = None
        if traced:
            def step():
                nonlocal kept
                kept = system.keep()
                system.mali_step(spans)
            prof = traceMod.profile_steps(
                step, settings['trace_steps'], spans,
                traceMod.SPAN_NAMES + tuple(kind.SPANS))
            program = program_trace.measure(step, settings['trace_steps'],
                                            cuda, spans.sync)
            log(t0, f"program's spans: {2 * program['steps']} steps in "
                f"{program['seconds']:.3f} s, per step:\n"
                + program_trace.format_table(program['table']))
    last = system.units(kept)
    log(t0, f'window over: {steps} MALI steps in {window:.3f} s')
    if cuda:
        peak = max(peak, torch.cuda.max_memory_allocated(dev))

    rec = Record(kind=config['kind'], dtype=dtypeName, setup_s=setup,
                 window_s=window, steps=steps, column_iterations=colIters,
                 spans=dict(spans.seconds), trace=prof,
                 window_peak_bytes=windowPeak, program=program,
                 **kind.shapes(config))
    metrics = {}
    for m in cell.metrics(perLayer=traced):
        value = manifest.load_reader(m['name'], root)(rec)
        if value is not None:
            metrics[m['name']] = {'value': float(value), 'unit': m['unit']}

    del system, kept
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = check.reference_numbers(kind, config, traffic, inputs, units,
                                      first, last, dev)
    log(t0, 'reference over')
    limits = settings['limits']
    about['memory_peak_bytes'] = int(peak)
    if prof is not None:
        about['busy_s'] = prof['busy_s']
        about['window_s'] = prof['window_s']
    out = {'correct': check.verdict(numbers, limits), 'attempted': steps,
           'failed': 0, 'metrics': metrics, 'device': about}
    if prof is not None:
        out['breakdown'] = traceMod.breakdown(prof)
    out['check'] = check.readout(numbers, limits)
    return out
