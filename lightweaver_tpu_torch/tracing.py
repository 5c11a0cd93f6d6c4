"""Spans and host-transfer counters inside the MALI step, off unless
``enable()`` is called.

The tracer is process-wide and is driven by calls alone: ``enable()``,
``disable()``, ``reset()`` and ``collect()``.  It reads no environment
variable and writes no file.  It assumes one host thread drives the port,
as every loop of the port does.

- ``span(name)``: a context manager.  Off, the shared no-op after one flag
  test.  On, a ``torch.profiler.record_function(name)`` range (under
  torch.profiler the span is in the trace, on the clock of the device's
  events), and the span's host time (``time.perf_counter_ns``) and self
  time (its time less its child spans') added to an aggregate keyed by the
  span's path, e.g. ``lw.stat_equil/lw.host.pops_to_host``: a count and
  two sums per path, nothing per event, so a long run keeps no growing
  list.
- ``to_host(t)`` and ``to_device(array, dtype, device)``: the funnels of
  the step's device-to-host reads and of its copies from host memory to
  the device.  While on, each call counts one transfer and its bytes on
  the innermost open span's path (``OUTSIDE`` where none is open),
  whatever the device: on the CPU the count is the number of sites the
  step passes, on a card each is a transfer that waits for the stream.

Nothing here synchronises the device: a span is the host's time as it
runs, not a stage's device time.
"""
import time
from collections import defaultdict

import numpy as np
import torch

# the path that counters take where no span is open
OUTSIDE = '(no span)'


class _Stats:
    __slots__ = ('count', 'total_ns', 'self_ns', 'reads', 'read_bytes',
                 'writes', 'write_bytes')

    def __init__(self):
        self.count = self.total_ns = self.self_ns = 0
        self.reads = self.read_bytes = self.writes = self.write_bytes = 0


class _NoSpan:
    """What span() returns while the tracer is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()
_on = False
_stack = []                     # the open spans, innermost last
_stats = defaultdict(_Stats)    # path -> _Stats


class _Span:
    __slots__ = ('name', 'path', 'childNs', 't0', 'range')

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.path = (self.name if not _stack
                     else _stack[-1].path + '/' + self.name)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.childNs = 0
        _stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        _stack.pop()
        st = _stats[self.path]
        st.count += 1
        st.total_ns += dt
        st.self_ns += dt - self.childNs
        if _stack:
            _stack[-1].childNs += dt
        self.range.__exit__(*exc)
        return False


def enable():
    """Turn the tracer on: later spans and transfers are recorded."""
    global _on
    _on = True


def disable():
    """Turn the tracer off; what it recorded stays until reset()."""
    global _on
    _on = False


def reset():
    """Forget every aggregate and counter (open spans stay open)."""
    _stats.clear()


def collect() -> dict:
    """Per path: ``count`` (spans closed), ``total_s`` and ``self_s`` (host
    seconds), ``host_reads``/``host_read_bytes`` and ``host_writes``/
    ``host_write_bytes`` (transfers whose innermost open span had this
    path).  Empty while nothing was recorded."""
    return {path: {'count': st.count, 'total_s': st.total_ns * 1e-9,
                   'self_s': st.self_ns * 1e-9, 'host_reads': st.reads,
                   'host_read_bytes': st.read_bytes,
                   'host_writes': st.writes,
                   'host_write_bytes': st.write_bytes}
            for path, st in _stats.items()}


def span(name: str):
    """A host span named ``name`` (see the module's docstring)."""
    if not _on:
        return _NOOP
    return _Span(name)


def _innermost() -> _Stats:
    return _stats[_stack[-1].path if _stack else OUTSIDE]


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``, counted as one host read of its bytes while on."""
    if _on:
        st = _innermost()
        st.reads += 1
        st.read_bytes += t.numel() * t.element_size()
    return t.cpu()


def to_device(array, dtype, device) -> torch.Tensor:
    """A copy of the host ``array`` as a tensor of ``dtype`` (None: numpy's)
    on ``device``, never a view of it (on the CPU either); counted as one
    host write of its bytes while on."""
    t = torch.tensor(np.asarray(array), dtype=dtype, device=device)
    if _on:
        st = _innermost()
        st.writes += 1
        st.write_bytes += t.numel() * t.element_size()
    return t
