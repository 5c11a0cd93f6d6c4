"""lightweaver_tpu_torch.tracing: the spans and host-transfer counters of
the MALI step.

Off by default (no lw.* range in a profiled step, nothing collected); on,
spans aggregate by path with their self time, counters land on the
innermost open span, reset() clears both; one step of a tiny 1D Context,
a tiny ColumnBatch (with and without a converged column) and a tiny
periodic 2D Context nests the documented spans and counts the documented
host reads and writes; and the tracer changes no number of the step.

No jax here; the sync cross-check on a card is in
lwbench/tests/test_lwbench_program_trace.py.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lightweaver_tpu_torch import problems, tracing

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)

FSGM = 'lw.formal_sol_gamma_matrices'
SE = 'lw.stat_equil'
BATCH_SE = 'lw.batch.stat_equil'
# per case: the host reads and writes of one MALI step (formal_sol_gamma_
# matrices, then stat_equil) by span path
TRANSFERS = {
    # stat_equil's flags (one read); nTotal of each active atom (H, Ca)
    'context_1d': {
        f'{SE}/lw.se.solve': (0, 2),
        f'{SE}/lw.host.flags_to_host': (1, 0)},
    # + the batch's dJ and populations read, its populations pushed back
    'batch': {
        f'{FSGM}/lw.host.dj_to_host': (1, 0),
        f'{BATCH_SE}/{SE}/lw.se.solve': (0, 2),
        f'{BATCH_SE}/{SE}/lw.host.flags_to_host': (1, 0),
        f'{BATCH_SE}/lw.host.pops_to_host': (1, 0),
        f'{BATCH_SE}/lw.host.pops_to_device': (0, 2)},
    # + the mask of the converged columns
    'batch_frozen': {
        f'{FSGM}/lw.host.frozen_mask': (0, 1),
        f'{FSGM}/lw.host.dj_to_host': (1, 0),
        f'{BATCH_SE}/{SE}/lw.se.solve': (0, 2),
        f'{BATCH_SE}/{SE}/lw.host.flags_to_host': (1, 0),
        f'{BATCH_SE}/lw.host.pops_to_host': (1, 0),
        f'{BATCH_SE}/lw.host.pops_to_device': (0, 2)},
    # Ca alone active
    'slab_2d': {
        f'{SE}/lw.se.solve': (0, 1),
        f'{SE}/lw.host.flags_to_host': (1, 0)},
}
CASES = tuple(TRANSFERS)


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def build(case):
    """The case's program object after its first MALI step."""
    if case == 'context_1d':
        obj = problems.h6ca_context(problems.falc_decimated(20), Nrays=2,
                                    device='cpu')
    elif case.startswith('batch'):
        obj = problems.column_batch(3, Nk=20, Nrays=2, device='cpu')
    else:
        obj = problems.slab_2d(10, 4, periodic=True, quadrature=1,
                               device='cpu',
                               formalSolver='piecewise_besser_2d')
    obj.formal_sol_gamma_matrices()
    obj.stat_equil()
    if case == 'batch_frozen':
        obj.converged[1] = True
    return obj


def mali_step(obj):
    obj.formal_sol_gamma_matrices()
    obj.stat_equil()


def state(obj):
    """J, the populations and Gamma of the program object."""
    if hasattr(obj, 'params'):
        return [obj.params['J'], *obj.params['pops'], *obj._Gamma]
    return [obj.J, *(st['n'] for st in obj.popsState), *obj._Gamma]


def lw_ancestors(e):
    """The names of the lw.* ranges holding profiler event e."""
    out = []
    e = e.cpu_parent
    while e is not None:
        if e.name.startswith('lw.'):
            out.append(e.name)
        e = e.cpu_parent
    return out


def test_off_by_default():
    assert tracing.span('lw.a') is tracing.span('lw.b')
    obj = build('context_1d')
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mali_step(obj)
    assert not [e.name for e in prof.events() if e.name.startswith('lw.')]
    assert tracing.collect() == {}


def test_spans_aggregate_by_path_and_counters_land_innermost():
    x = torch.arange(6, dtype=torch.float64)
    tracing.enable()
    for _ in range(2):
        with tracing.span('lw.a'):
            tracing.to_device([1.0, 2.0], torch.float64, 'cpu')
            with tracing.span('lw.b'):
                tracing.to_host(x)
                tracing.to_host(x[:2])
    tracing.to_host(x)
    got = tracing.collect()
    assert set(got) == {'lw.a', 'lw.a/lw.b', tracing.OUTSIDE}
    a, b = got['lw.a'], got['lw.a/lw.b']
    assert a['count'] == b['count'] == 2
    assert 0 <= a['self_s'] <= a['total_s']
    assert 0 <= b['self_s'] == pytest.approx(b['total_s'])
    assert a['self_s'] <= a['total_s'] - b['total_s'] + 1e-9
    assert (a['host_reads'], a['host_writes'], a['host_write_bytes']) == (
        0, 2, 32)
    assert (b['host_reads'], b['host_read_bytes'], b['host_writes']) == (
        4, 2 * (48 + 16), 0)
    assert got[tracing.OUTSIDE]['host_reads'] == 1
    tracing.reset()
    assert tracing.collect() == {}
    tracing.disable()
    with tracing.span('lw.c'):
        tracing.to_host(x)
    assert tracing.collect() == {}


@pytest.mark.parametrize('case', CASES)
def test_step_nests_spans_and_counts_transfers(case):
    obj = build(case)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mali_step(obj)
    tracing.disable()
    events = [e for e in prof.events() if e.name.startswith('lw.')]
    names = {e.name for e in events}
    stages = ('lw.gather', 'lw.formal_solve', 'lw.gamma_rates')
    assert set(stages) <= names
    if case == 'slab_2d':
        assert {'lw.fs2d.start', 'lw.fs2d.sweep'} <= names
    for e in events:
        up = lw_ancestors(e)
        if e.name in stages or e.name.startswith('lw.gamma_rates.'):
            assert FSGM in up, (e.name, up)
        if e.name.startswith('lw.fs2d.'):
            assert 'lw.formal_solve' in up
        if e.name in ('lw.host.dj_to_host', 'lw.host.frozen_mask'):
            assert FSGM in up
        elif e.name.startswith('lw.host.') or e.name == 'lw.se.solve':
            assert SE in up or BATCH_SE in up, (e.name, up)
    active = [a.model.element.name for a in obj.cfg.activeAtoms]
    assert {f'lw.gamma_rates.{el}' for el in active} <= names
    got = {path: (s['host_reads'], s['host_writes'])
           for path, s in tracing.collect().items()
           if s['host_reads'] or s['host_writes']}
    assert got == TRANSFERS[case]


@pytest.mark.parametrize('case', CASES)
def test_tracer_changes_no_number(case):
    off, on = build(case), build(case)
    mali_step(off)
    tracing.enable()
    mali_step(on)
    tracing.disable()
    assert tracing.collect()
    for x, y in zip(state(off), state(on)):
        assert torch.equal(x, y)
