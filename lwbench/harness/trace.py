"""The device trace of a traced run: a few MALI steps under
torch.profiler, with the harness's spans as record_function ranges and
no synchronisation inside them.  The harness's spans are SPAN_NAMES (the
program's stages and stat_equil) and the spans the cell's kind opens
(its ``SPANS``); a run passes them all as ``names``.

From the trace: every device operation (kernels, copies, fills) with its
name and duration; the device's busy seconds (the union of their
intervals; the port launches on one stream) against the traced window's
wall seconds (scripts/torch_profile.py:profile_problem's arithmetic); the
idle gaps between operations, each named by the host span that was
running when the next operation started (the host was late with it); and
the device's busy seconds inside each stage: the device time the
profiler links to each host operation inside that stage's range.
"""
import time
from collections import defaultdict

from torch.autograd import DeviceType

from .spans import STAGES

SPAN_NAMES = STAGES + ('stat_equil',)
OUTSIDE = 'outside_stages'
# entries of each list of a result's breakdown
TOP = 10


def _device_ops(events, cuda: bool, names=SPAN_NAMES):
    """The device operations (not the harness's ranges ``names``); on the
    CPU (the tests) the innermost aten operations stand in for them."""
    if not cuda:
        return [e for e in events if e.device_type == DeviceType.CPU
                and e.name.startswith('aten::') and not e.cpu_children]
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)
            and e.name not in names]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label(t, host):
    """The innermost host span holding time t (us), or OUTSIDE."""
    best = None
    for name, s, e in host:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return OUTSIDE if best is None else best[2]


def _stage(e, names):
    """The innermost range of ``names`` holding host event e (e itself
    included), or None."""
    while e is not None:
        if e.name in names:
            return e.name
        e = e.cpu_parent
    return None


def _stage_busy(events, ops, cuda: bool, names) -> dict:
    """The device's busy seconds per stage: the device time of every host
    operation inside the stage's range (on the card, the kernels, copies
    and fills the profiler links to the operation that launched them,
    summed: the port launches on one stream; on the CPU, the tests, the
    innermost operations' own time)."""
    busy = defaultdict(float)
    if cuda:
        for e in events:
            if e.device_type == DeviceType.CPU and e.kernels:
                name = _stage(e, names)
                if name is not None:
                    busy[name] += sum(k.duration for k in e.kernels) * 1e-6
    else:
        for op in ops:
            name = _stage(op, names)
            if name is not None:
                busy[name] += op.time_range.elapsed_us() * 1e-6
    return dict(busy)


def profile_steps(step, steps: int, spans, names=SPAN_NAMES) -> dict:
    """Run step() ``steps`` times under the profiler; returns the device
    operations [(name, seconds)], busy_s, window_s, the idle seconds by
    host span, the busy seconds by span, and the step count.  ``names``:
    the harness's spans."""
    from torch.profiler import ProfilerActivity, profile
    cuda = spans.device.type == 'cuda'
    spans.mode = 'annotated'
    spans.sync()
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        spans.sync()
        window = time.perf_counter() - t0
    spans.mode = 'off'
    events = prof.events()
    ops = _device_ops(events, cuda, names)
    if not ops:
        raise RuntimeError('the profiler recorded no device operation')
    intervals = [(e.time_range.start, e.time_range.end) for e in ops]
    busy = _union(intervals)
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CPU and e.name in names]
    idle = defaultdict(float)
    for (_, end), (start, _) in zip(busy[:-1], busy[1:]):
        idle[_label(start - 1, host)] += (start - end) * 1e-6
    return {'ops': [(e.name, e.time_range.elapsed_us() * 1e-6) for e in ops],
            'busy_s': sum(e - s for s, e in busy) * 1e-6,
            'window_s': window, 'idle_by_span': dict(idle),
            'busy_by_stage': _stage_busy(events, ops, cuda, names),
            'steps': steps}


def breakdown(trace: dict) -> dict:
    """The device operations with the most time and the idle seconds by
    host span, at most TOP of each."""
    byName = defaultdict(float)
    for name, s in trace['ops']:
        byName[name] += s
    ops = sorted(byName.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(trace['idle_by_span'].items(), key=lambda kv: -kv[1])[:TOP]
    return {'device_ops': [[n[:160], s] for n, s in ops],
            'idle_gaps': [[n, s] for n, s in gaps]}
