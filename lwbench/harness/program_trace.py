"""The program's own spans and host-transfer counters
(``lightweaver_tpu_torch.tracing``) over a cell's MALI steps, and the
device trace's idle time split over the spans that it overlaps.

- ``tracer_steps``: MALI steps with the tracer on, no profiler and no
  synchronisation: the host as it runs, with its span aggregates and its
  host reads and writes per step;
- ``profiled_steps``: MALI steps under torch.profiler with the tracer on,
  so the ``lw.*`` ranges are in the trace on the device's clock;
- ``overlap``: per innermost ``lw.*`` path, the device operations launched
  inside it, the device's busy seconds inside it, and the idle seconds it
  overlaps: each gap between device operations is split over the
  innermost ``lw.*`` range covering each part of it, a part under none
  going to ``OUTSIDE``;
- ``readings``: the per-layer numbers these give, and ``table`` the span
  table, one row per path, all per step.

``lwbench/span_table.py`` runs them on a cell.
"""
import time
from collections import defaultdict

from torch.autograd import DeviceType

from lightweaver_tpu_torch import tracing

from .trace import _device_ops, _union

OUTSIDE = 'outside_program'
PREFIX = 'lw.'


def tracer_steps(step, steps: int, sync) -> dict:
    """``steps`` calls of step() with the tracer on (reset first), the
    device synchronised before and after them alone; returns the steps,
    their seconds and the tracer's aggregate."""
    sync()
    tracing.reset()
    tracing.enable()
    try:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync()
        seconds = time.perf_counter() - t0
    finally:
        tracing.disable()
    return {'steps': steps, 'seconds': seconds, 'spans': tracing.collect()}


def profiled_steps(step, steps: int, cuda: bool, sync):
    """``steps`` calls of step() under torch.profiler with the tracer on;
    returns the profiler's events."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    tracing.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]
                     + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
            for _ in range(steps):
                step()
            sync()
    finally:
        tracing.disable()
    return prof.events()


def _lw_path(e):
    """The path of the lw.* ranges holding host event e (e itself
    included), outermost first, or None outside every one."""
    names = []
    while e is not None:
        if e.name.startswith(PREFIX):
            names.append(e.name)
        e = e.cpu_parent
    return '/'.join(reversed(names)) if names else None


def _innermost(t, ranges) -> str:
    """The path of the shortest range of ``ranges`` [(start, end, path)]
    holding time t, or OUTSIDE."""
    return min(((e - s, path) for s, e, path in ranges if s <= t <= e),
               default=(None, OUTSIDE))[1]


def overlap(events, cuda: bool):
    """(rows, unlinked).  Per innermost lw.* path (OUTSIDE for none), a
    row of ``launches`` (the device operations the host launched inside
    it), ``busy_s`` (their device seconds) and ``idle_s`` (the device's
    idle seconds between operations that its ranges overlap: each part of
    a gap once, under the innermost range covering it).  ``unlinked``
    counts the operations whose launch was not found (placed by their own
    start).  On the card an operation's launch is the host's runtime call
    with its correlation id (cudaLaunchKernel, cudaMemcpyAsync, ...), so
    a kernel launched outside any aten operation (the port's ctypes
    kernels) counts where the host launched it.  On the CPU, the tests,
    the innermost aten operations stand in for the device's, as in
    harness/trace.py, and are launched where they start."""
    out = defaultdict(lambda: {'launches': 0, 'busy_s': 0.0, 'idle_s': 0.0})
    ops = [e for e in _device_ops(events, cuda)
           if not e.name.startswith(PREFIX)]
    ranges = [(e.time_range.start, e.time_range.end, _lw_path(e))
              for e in events if e.device_type == DeviceType.CPU
              and e.name.startswith(PREFIX)]
    launch = {}
    if cuda:
        launch = {e.id: e.time_range.start for e in events
                  if e.device_type == DeviceType.CPU
                  and e.name.startswith('cuda') and e.id > 0}
    unlinked = 0
    for op in ops:
        t = launch.get(op.id) if cuda else op.time_range.start
        if t is None:
            unlinked += 1
            t = op.time_range.start
        row = out[_innermost(t, ranges)]
        row['launches'] += 1
        row['busy_s'] += op.time_range.elapsed_us() * 1e-6
    busy = _union([(e.time_range.start, e.time_range.end) for e in ops])
    for (_, g0), (g1, _) in zip(busy[:-1], busy[1:]):
        cuts = sorted({g0, g1, *(t for s, e, _ in ranges
                                 for t in (s, e) if g0 < t < g1)})
        for a, b in zip(cuts[:-1], cuts[1:]):
            out[_innermost(0.5 * (a + b), ranges)]['idle_s'] += (b - a) * 1e-6
    return dict(out), unlinked


def _has(path: str, name: str) -> bool:
    """Whether ``name`` is one of the ranges of ``path``."""
    return name in path.split('/')


def readings(tracer: dict, ov: dict, profSteps: int) -> dict:
    """The per-layer numbers of the tracer's steps and the profiled steps:
    host reads + writes per step; per profiled step, the idle ms that the
    lw.host.* ranges overlap, the idle ms and launches inside
    lw.formal_solve (its children included) and the launches inside
    lw.gamma_rates (its per-atom children included)."""
    def total(key, pred):
        return sum(r[key] for p, r in ov.items() if pred(p)) / profSteps

    return {
        'host_syncs_per_step': sum(
            s['host_reads'] + s['host_writes']
            for s in tracer['spans'].values()) / tracer['steps'],
        'host_stall_ms': total('idle_s', lambda p: p.rsplit('/', 1)[-1]
                               .startswith(PREFIX + 'host.')) * 1e3,
        'formal_solve_idle_ms': total(
            'idle_s', lambda p: _has(p, 'lw.formal_solve')) * 1e3,
        'formal_solve_launches': total(
            'launches', lambda p: _has(p, 'lw.formal_solve')),
        'gamma_rates_launches': total('launches', lambda p: any(
            n == 'lw.gamma_rates' or n.startswith('lw.gamma_rates.')
            for n in p.split('/')))}


def table(tracer: dict, ov: dict, profSteps: int) -> list:
    """The span table: per path (the union of both sources), per step:
    spans closed, host ms and self ms and host reads and writes (the
    tracer's steps); device busy ms, launches and overlapped idle ms (the
    profiled steps); sorted by path."""
    spans, n = tracer['spans'], tracer['steps']
    rows = []
    for path in sorted(set(spans) | set(ov)):
        s, d = spans.get(path), ov.get(path)
        rows.append({
            'path': path,
            'count': s['count'] / n if s else None,
            'host_ms': s['total_s'] / n * 1e3 if s else None,
            'self_ms': s['self_s'] / n * 1e3 if s else None,
            'reads': s['host_reads'] / n if s else None,
            'writes': s['host_writes'] / n if s else None,
            'busy_ms': d['busy_s'] / profSteps * 1e3 if d else None,
            'launches': d['launches'] / profSteps if d else None,
            'idle_ms': d['idle_s'] / profSteps * 1e3 if d else None})
    return rows


def format_table(rows: list) -> str:
    """The span table as text, one row per path."""
    cols = ('count', 'host_ms', 'self_ms', 'reads', 'writes', 'busy_ms',
            'launches', 'idle_ms')
    width = max([len(r['path']) for r in rows] + [4])
    lines = [f"{'path':<{width}} " + ' '.join(f'{c:>10}' for c in cols)]
    for r in rows:
        lines.append(f"{r['path']:<{width}} " + ' '.join(
            f'{r[c]:>10.3f}' if r[c] is not None else f"{'-':>10}"
            for c in cols))
    return '\n'.join(lines)
