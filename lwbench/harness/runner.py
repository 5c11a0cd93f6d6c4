"""One run of one cell: set-up, the measured window, the traced steps,
the check against the reference, and the result line.

Set-up (``setup_s``, from process start): the inputs from the seed, the
program's system built on the device, and the warm-up with the cell's
own shapes only: the Nscatter formal solutions and one MALI step (the
first run of a checkout also builds the kernels then).  The window then
runs MALI steps until ``seconds`` have passed; where every column (or
the slab) has converged, the system goes back to its LTE start, without
repeating the set-up, and its Nscatter steps count in the window.
"""
import gc
import subprocess
import sys
import time
from contextlib import nullcontext

import numpy as np
import torch

from . import check, inputs as inputsMod, manifest, trace as traceMod
from .record import Record
from .spans import Spans, stages_wrapped
from ..reference.problem import wavelength_count
from .systems import DTYPES, SYSTEMS

JAX_NAMES = ('jax', 'jaxlib', 'flax', 'lightweaver_tpu')


def log(t0: float, what: str):
    print(f'[{time.perf_counter() - t0:8.2f} s] {what}', file=sys.stderr,
          flush=True)


def jax_modules() -> list:
    """Modules whose top-level name is one of JAX_NAMES (compared whole:
    lightweaver_tpu_torch is not lightweaver_tpu)."""
    return sorted(m for m in list(sys.modules)
                  if m.split('.', 1)[0] in JAX_NAMES)


def check_columns(config: dict, settings: dict, seed: int) -> list:
    """The batch's columns the check compares, drawn from the seed."""
    if config['kind'] != 'column_batch':
        return []
    rng = np.random.default_rng([seed, 1])
    return sorted(int(c) for c in rng.choice(
        config['columns'], settings['check_columns'], replace=False))


def shapes(config: dict) -> dict:
    """Nlam, Nmu (rays per direction) and Nk from the configuration, the
    wavelength grid by the reference's own model layer."""
    Nlam = wavelength_count(config)
    depths = len(np.unique(np.linspace(0, 81, config['depths']).astype(int)))
    if config['kind'] == 'column_batch':
        return {'Nlam': Nlam, 'Nmu': config['rays'],
                'Nk': config['columns'] * depths}
    return {'Nlam': Nlam, 'Nmu': 2 * config['quadrature'],
            'Nk': config['x_columns'] * depths}


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
    dtypeName = dtype or config['precision']
    dev = torch.device(device)
    cuda = dev.type == 'cuda'
    about = card() if cuda else {'platform': 'cpu', 'kind': 'cpu',
                                 'count': 1}

    inputs = inputsMod.make(config, seed)
    cols = check_columns(config, settings, seed)
    spans = Spans(dev)
    system = SYSTEMS[config['kind']](config, traffic, inputs, dev,
                                     DTYPES[dtypeName], cols)
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
        prof = None
        if traced:
            def step():
                nonlocal kept
                kept = system.keep()
                system.mali_step(spans)
            prof = traceMod.profile_steps(step, settings['trace_steps'],
                                          spans)
    last = system.units(kept)
    log(t0, f'window over: {steps} MALI steps in {window:.3f} s')
    if cuda:
        peak = max(peak, torch.cuda.max_memory_allocated(dev))

    rec = Record(kind=config['kind'], dtype=dtypeName, setup_s=setup,
                 window_s=window, steps=steps, column_iterations=colIters,
                 spans=dict(spans.seconds), trace=prof,
                 window_peak_bytes=windowPeak, **shapes(config))
    metrics = {}
    for m in cell.metrics(perLayer=traced):
        value = manifest.load_reader(m['name'], root)(rec)
        if value is not None:
            metrics[m['name']] = {'value': float(value), 'unit': m['unit']}

    del system, kept
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = check.reference_numbers(config, traffic, inputs, cols, first,
                                      last, dev)
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
    out['check'] = {k: {'value': numbers[k], 'limit': limits[k]}
                    for k in check.NAMES}
    return out
