"""The program's spans and counters read by the benchmark's side
(harness/program_trace.py, span_table.py): the idle time between device
operations split over the innermost lw.* range covering each part of it;
a tiny run of each cell on the CPU gives every reading and a span table;
and, on a card, one MALI step of each tiny cell synchronises exactly as
often as the program's host_reads + host_writes count (its funnels miss
no transfer)."""
import math
import warnings
from dataclasses import dataclass, field
from typing import List, Optional

import pytest
import torch
from torch.autograd import DeviceType

from lightweaver_tpu_torch import tracing
from lwbench import span_table
from lwbench.harness import inputs as inputsMod, manifest
from lwbench.harness import program_trace as pt
from lwbench.harness.systems import DTYPES, SYSTEMS
from lwbench.tests.tiny import COLS, SLAB, tiny_root

SEED = 2 ** 31 + 11
READINGS = ('host_syncs_per_step', 'host_stall_ms', 'formal_solve_idle_ms',
            'formal_solve_launches', 'gamma_rates_launches')


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_root(tmp_path_factory.mktemp('tiny'))


@pytest.fixture(autouse=True)
def tracer_off():
    yield
    tracing.disable()
    tracing.reset()


@dataclass
class _Range:
    start: float
    end: float


@dataclass
class _Event:
    """The fields of a profiler event that overlap() reads."""
    name: str
    start: float
    end: float
    cpu_parent: Optional['_Event'] = None
    cpu_children: List = field(default_factory=list)
    device_type: DeviceType = DeviceType.CPU

    @property
    def time_range(self):
        return _RangeUs(self.start, self.end)


class _RangeUs(_Range):
    def elapsed_us(self):
        return self.end - self.start


def test_idle_split_over_the_innermost_range():
    a = _Event('lw.a', 0, 100)
    b = _Event('lw.b', 40, 60, cpu_parent=a)
    c = _Event('lw.c', 120, 130)
    ops = [_Event('aten::x', 0, 10, cpu_parent=a),
           _Event('aten::y', 90, 100, cpu_parent=a),
           _Event('aten::z', 140, 150)]
    got, unlinked = pt.overlap([a, b, c, *ops], cuda=False)
    assert unlinked == 0
    idle = {p: r['idle_s'] * 1e6 for p, r in got.items()}
    assert idle == pytest.approx({'lw.a': 60, 'lw.a/lw.b': 20, 'lw.c': 10,
                                  pt.OUTSIDE: 30})
    assert got['lw.a']['launches'] == 2
    assert got[pt.OUTSIDE]['launches'] == 1


@pytest.mark.parametrize('cell', (COLS, SLAB))
def test_tiny_span_table_gives_every_reading(root, cell):
    out = span_table.run(cell, SEED, 0.3, rounds=1, steps=1, root=root,
                         device='cpu')
    got = out['readings']
    assert set(got) == set(READINGS)
    assert all(math.isfinite(v) and v >= 0 for v in got.values())
    assert got['host_syncs_per_step'] >= 2
    assert got['formal_solve_launches'] > 0
    assert got['gamma_rates_launches'] > 0
    paths = {r['path'] for r in out['table']}
    assert {'lw.formal_sol_gamma_matrices/lw.gather',
            'lw.formal_sol_gamma_matrices/lw.formal_solve'} <= paths
    assert out['idle_by_end_label_s']
    assert out['cost_rounds'][0]['on_ms'] > 0


def _tiny_program(root, cell, device):
    """The program object of a tiny cell after its warm-up."""
    c = manifest.load_cell(cell, root)
    system = SYSTEMS[c.config['kind']](
        c.config, c.traffic, inputsMod.make(c.config, SEED),
        torch.device(device), DTYPES[c.config['precision']],
        list(range(c.settings['check_columns'])))
    system.scatter_steps()
    prog = getattr(system, 'b', None) or system.ctx
    prog.formal_sol_gamma_matrices()
    prog.stat_equil()
    return prog


@pytest.mark.gpu
@pytest.mark.parametrize('cell', (COLS, SLAB))
def test_funnels_count_every_sync_on_the_card(root, cell):
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device')
    prog = _tiny_program(root, cell, 'cuda')
    torch.cuda.synchronize()
    tracing.reset()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        tracing.enable()
        try:
            prog.formal_sol_gamma_matrices()
            prog.stat_equil()
        finally:
            tracing.disable()
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # the sync debug mode's own warning, once per process, is no sync
    syncs = [(w.filename, w.lineno) for w in caught
             if 'called a synchronizing CUDA operation' in str(w.message)]
    spans = tracing.collect()
    counted = sum(s['host_reads'] + s['host_writes'] for s in spans.values())
    assert counted > 0
    assert len(syncs) == counted, ([str(w.message)[:80] for w in caught],
                                   syncs, spans)
