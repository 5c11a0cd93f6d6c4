"""The program's span table of one cell: where the host's time and the
device's idle time go inside lightweaver_tpu_torch, by its own spans and
host-transfer counters (lightweaver_tpu_torch.tracing).

    python3 lwbench/span_table.py --workload <cell> --seed <n> \
        --seconds <s> [--rounds 3] [--steps 5]

Set-up as run.py's; then ``--seconds`` of untraced MALI steps (the
window's steady state); then ``--rounds`` rounds of ``--steps`` untraced
steps against as many with the tracer on (no profiler, no harness
synchronisation inside), the tracer's cost when on; then the cell's
``trace_steps`` steps under torch.profiler with the tracer on and the
harness's stage ranges (harness/spans.py, annotated), so that one trace
gives the idle time by overlap with the program's spans and by the
harness's end labels (harness/trace.py:_label).  The span table goes to
standard error (per path and per step: host ms, self ms, host reads and
writes from the tracer's steps; device busy ms, launches and idle ms from
the profiled steps); the last line of standard output is one JSON object
with the readings (harness/program_trace.py:readings), the cost rounds,
both idle attributions, the table and the device.  No check against the
reference: the benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def end_labels(events, cuda: bool, names) -> dict:
    """The idle seconds between device operations, each gap named by the
    harness range of ``names`` that held its end (harness/trace.py:
    profile_steps's attribution, on the same events)."""
    from torch.autograd import DeviceType
    from lwbench.harness.trace import _device_ops, _label, _union
    ops = [e for e in _device_ops(events, cuda, names)
           if not e.name.startswith('lw.')]
    busy = _union([(e.time_range.start, e.time_range.end) for e in ops])
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CPU and e.name in names]
    idle = defaultdict(float)
    for (_, end), (start, _) in zip(busy[:-1], busy[1:]):
        idle[_label(start - 1, host)] += (start - end) * 1e-6
    return dict(idle)


def run(name: str, seed: int, seconds: float, rounds: int, steps: int,
        root=None, device='cuda', log=None) -> dict:
    """The span table's run of cell ``name`` (see the module docstring);
    returns the result dict."""
    import torch
    from lwbench.harness import manifest
    from lwbench.harness import program_trace as pt
    from lwbench.harness.runner import card
    from lwbench.harness.spans import Spans, stages_wrapped
    from lwbench.harness.systems import DTYPES
    from lwbench.harness.trace import SPAN_NAMES

    t0 = time.perf_counter()
    log = log or (lambda what: None)
    cell = manifest.load_cell(name, root or manifest.ROOT)
    config, traffic, settings = cell.config, cell.traffic, cell.settings
    dev = torch.device(device)
    cuda = dev.type == 'cuda'
    spans = Spans(dev)
    kind = cell.kind
    system = kind.System(
        config, traffic, kind.make_inputs(config, seed), dev,
        DTYPES[config['precision']], kind.check_units(config, settings, seed))
    system.scatter_steps()
    system.mali_step(spans)
    spans.sync()
    setup = time.perf_counter() - t0
    log(f'set-up {setup:.1f} s')

    def step():
        if system.all_converged():
            system.restart()
            system.scatter_steps()
        system.mali_step(spans)

    def timed(n):
        spans.sync()
        ts = time.perf_counter()
        for _ in range(n):
            step()
        spans.sync()
        return (time.perf_counter() - ts) / n * 1e3

    n = 0
    tw = time.perf_counter()
    while n == 0 or time.perf_counter() - tw < seconds:
        step()
        n += 1
    spans.sync()
    windowMs = (time.perf_counter() - tw) / n * 1e3
    log(f'window: {n} steps, {windowMs:.3f} ms per step')

    cost, tracer = [], {'steps': 0, 'spans': {}}
    for _ in range(rounds):
        off = timed(steps)
        got = pt.tracer_steps(step, steps, spans.sync)
        cost.append({'off_ms': off, 'on_ms': got['seconds'] / steps * 1e3})
        tracer['steps'] += got['steps']
        for path, s in got['spans'].items():
            acc = tracer['spans'].setdefault(path, dict.fromkeys(s, 0))
            for k, v in s.items():
                acc[k] += v
    log(f'tracer cost rounds (ms per step): {cost}')

    profSteps = settings['trace_steps']
    with stages_wrapped(spans):
        spans.mode = 'annotated'
        events = pt.profiled_steps(step, profSteps, cuda, spans.sync)
        spans.mode = 'off'
    ov, unlinked = pt.overlap(events, cuda)
    nOps = sum(r['launches'] for r in ov.values())
    rows = pt.table(tracer, ov, profSteps)
    log('span table, per MALI step:\n' + pt.format_table(rows))
    about = card() if cuda else {'platform': 'cpu', 'kind': 'cpu',
                                 'count': 1}
    return {'workload': name, 'seed': seed, 'setup_s': setup,
            'window_steps': n, 'window_step_ms': windowMs,
            'cost_rounds': cost, 'tracer_steps': tracer['steps'],
            'profiled_steps': profSteps,
            'device_ops_per_step': nOps / profSteps,
            'unlinked_ops': unlinked,
            'readings': pt.readings(tracer, ov, profSteps),
            'idle_by_overlap_s': {p: r['idle_s'] for p, r in ov.items()},
            'idle_by_end_label_s': end_labels(
                events, cuda, SPAN_NAMES + tuple(kind.SPANS)),
            'table': rows, 'device': about}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--rounds', type=int, default=3)
    ap.add_argument('--steps', type=int, default=5)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print('span_table.py needs a CUDA device', file=sys.stderr)
        return 2
    t0 = time.perf_counter()

    def log(what):
        print(f'[{time.perf_counter() - t0:8.2f} s] {args.workload}: {what}',
              file=sys.stderr, flush=True)
    out = run(args.workload, args.seed, args.seconds, args.rounds,
              args.steps, log=log)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
