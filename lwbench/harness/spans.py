"""Spans around the calls into the program's layers, from the benchmark's
own files.

In a traced run the stages of the program's MALI step (the module
functions ``gather``, ``formal_solve`` and ``gamma_rates`` of
``lightweaver_tpu_torch.context``, which its step calls by name) are
wrapped, and the harness wraps its own ``stat_equil`` calls.  Two modes:

- 'timed': the host clock around each call, the device synchronised
  before and after it (chip_smoke.py:stage_breakdown's method), so each
  stage's time is its own; the durations are kept per name;
- 'annotated': a torch.profiler.record_function range per call and no
  synchronisation, so a profiled step runs as it does untraced.

Untraced runs ('off') wrap nothing.
"""
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

STAGES = ('gather', 'formal_solve', 'gamma_rates')


class Spans:
    def __init__(self, device):
        self.mode = 'off'
        self.device = torch.device(device)
        self.seconds = defaultdict(list)

    def sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    @contextmanager
    def span(self, name: str):
        if self.mode == 'timed':
            self.sync()
            t0 = time.perf_counter()
            yield
            self.sync()
            self.seconds[name].append(time.perf_counter() - t0)
        elif self.mode == 'annotated':
            with torch.profiler.record_function(name):
                yield
        else:
            yield

    def wrap(self, name: str, fn):
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped


@contextmanager
def stages_wrapped(spans: Spans):
    """The program's stage functions wrapped in spans while inside."""
    from lightweaver_tpu_torch import context
    saved = {name: getattr(context, name) for name in STAGES}
    try:
        for name, fn in saved.items():
            setattr(context, name, spans.wrap(name, fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(context, name, fn)
