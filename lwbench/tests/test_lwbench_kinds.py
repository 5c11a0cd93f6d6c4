"""Kinds as files: a kind (its system, inputs, compared state and
numbers, harness spans and reference step) added to a copy of the
benchmark by new files alone runs through run_cell and reads correct,
and a fault planted in it does not; a number without a limit, or a
limit without a number, is no correct run; a reader of a program span
added by a file reads in a traced run; and the tiny cells read the
check numbers that the parent commit of the kind modules read."""
import hashlib
import json
from pathlib import Path

import pytest
import torch

from lwbench.harness import check, runner
from lwbench.tests.tiny import COLS, SLAB, tiny_root

SEED = 2 ** 31 + 5

TOY_KIND = '''"""A toy kind: points of a harmonic oscillator stepped by
symplectic Euler, state x and v, never converging."""
import importlib.util
from pathlib import Path

import numpy as np
import torch

from lwbench.harness import check
from lwbench.harness.systems import host_state

NUMBERS = {'x': check.rel_rows, 'v': check.rel_rows}
SPANS = ('kick',)


def make_inputs(config, seed):
    rng = np.random.default_rng(seed)
    return {'x': rng.uniform(-1, 1, config['points']),
            'v': rng.uniform(-1, 1, config['points'])}


def check_units(config, settings, seed):
    return []


def shapes(config):
    return {'Nlam': 1, 'Nmu': 1, 'Nk': config['points']}


class System:
    def __init__(self, config, traffic, inputs, device, dtype, units):
        self.dt, self.nscatter = config['dt'], traffic['nscatter']
        self.x0 = torch.as_tensor(inputs['x'], dtype=dtype, device=device)
        self.v0 = torch.as_tensor(inputs['v'], dtype=dtype, device=device)
        self.restart()

    def restart(self):
        self.x, self.v = self.x0.clone(), self.v0.clone()

    def scatter_steps(self):
        for _ in range(self.nscatter):
            self.x = self.x + self.dt * self.v

    def mali_step(self, spans):
        with spans.span('kick'):
            self.v = self.v - self.dt * self.x
        self.x = self.x + self.dt * self.v
        return 1

    def all_converged(self):
        return False

    def keep(self):
        return {'x': self.x.clone(), 'v': self.v.clone()}

    def units(self, kept):
        return [(host_state(kept), host_state({'x': self.x, 'v': self.v}))]


def reference(config, inputs, unit, units, device):
    path = Path(__file__).resolve().parents[1] / 'reference' / 'toy_step.py'
    spec = importlib.util.spec_from_file_location('toy_step', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Unit(config, inputs)
'''

TOY_REFERENCE = '''"""The toy kind's reference, in float64 numpy."""


class Unit:
    def __init__(self, config, inputs):
        self.inputs, self.dt = inputs, config['dt']

    def start(self):
        return {'x': self.inputs['x'], 'v': self.inputs['v']}

    def scatter(self, s):
        return {'x': s['x'] + self.dt * s['v'], 'v': s['v']}

    def step(self, s):
        v = s['v'] - self.dt * s['x']
        return {'x': s['x'] + self.dt * v, 'v': v}

    def resume(self, kept):
        return dict(kept)

    def compared(self, s):
        return s
'''


def _snapshot(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob('*') if p.is_file()}


def _add_toy(root: Path, limits: dict):
    """The toy kind, its reference, configuration, traffic, and the cells
    toy_<n> with the limits ``limits[n]``, by new files and new entries
    of BENCHMARK.json."""
    lw = root / 'lwbench'
    (lw / 'kinds' / 'toy_oscillator.py').write_text(TOY_KIND)
    (lw / 'reference').mkdir(exist_ok=True)
    (lw / 'reference' / 'toy_step.py').write_text(TOY_REFERENCE)
    (lw / 'configs' / 'toy.json').write_text(json.dumps(
        {'name': 'toy', 'kind': 'toy_oscillator', 'points': 64, 'dt': 0.01,
         'precision': 'float64', 'reduced_why': {}}))
    (lw / 'traffic' / 'toy_steps.json').write_text(json.dumps(
        {'scheme': 'symplectic_euler', 'nscatter': 2}))
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append({'name': 'toy', 'source': 'a test',
                             'file': 'lwbench/configs/toy.json',
                             'reduced': [], 'why': 'a test'})
    for name, lim in limits.items():
        (lw / 'cells' / f'toy_{name}.json').write_text(json.dumps(
            {'check_columns': 0, 'trace_steps': 1, 'limits': lim}))
        bench['workloads'].append({'name': f'toy_{name}', 'config': 'toy',
                                   'traffic': 'toy_steps', 'chips': 1,
                                   'why': 'a test'})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))


@pytest.fixture(scope='module')
def toy_root(tmp_path_factory):
    torch.set_num_threads(2)
    root = tiny_root(tmp_path_factory.mktemp('toy'))
    before = _snapshot(root)
    benchBefore = json.loads((root / 'BENCHMARK.json').read_text())
    _add_toy(root, {'ok': {'x': 1e-12, 'v': 1e-12},
                    'nolimit': {'x': 1e-12},
                    'extralimit': {'x': 1e-12, 'v': 1e-12, 'w': 1.0}})
    after = _snapshot(root)
    # nothing of the copy changes but BENCHMARK.json, which only gains
    assert {p: h for p, h in after.items() if p in before} == \
        {p: h for p, h in before.items() if p != Path('BENCHMARK.json')} | \
        {Path('BENCHMARK.json'): after[Path('BENCHMARK.json')]}
    benchAfter = json.loads((root / 'BENCHMARK.json').read_text())
    for key, entries in benchBefore.items():
        if isinstance(entries, list) and key != 'command' and key != 'paths':
            assert benchAfter[key][:len(entries)] == entries
    return root


def _toy(root, cell, **kw):
    return runner.run_cell(cell, SEED, 0.05, False, root=root, device='cpu',
                           **kw)


def test_toy_kind_added_by_files_reads_correct(toy_root):
    out = _toy(toy_root, 'toy_ok')
    assert out['correct'], out['check']
    assert out['attempted'] > 1
    assert {k: v['value'] for k, v in out['check'].items()} == \
        {'x': 0.0, 'v': 0.0}
    assert set(out['metrics']) == {'setup_s'}


def test_toy_kind_fault_reads_not_correct(toy_root):
    """The step returns its state unchanged."""
    def unchanged(system):
        system.mali_step = lambda spans: 1
    out = _toy(toy_root, 'toy_ok', fault=unchanged)
    assert not out['correct'], out['check']
    assert out['check']['v']['value'] > 1e-4


def test_toy_kind_control_reads_not_correct(toy_root):
    out = _toy(toy_root, 'toy_ok', dtype='float32')
    assert not out['correct'], out['check']


def test_traced_toy_run_names_its_own_span(toy_root):
    """The kind's harness span 'kick' names the idle gaps that end in it
    (the trace's span names are the harness's and the kind's)."""
    out = runner.run_cell('toy_ok', SEED, 0.05, True, root=toy_root,
                          device='cpu')
    assert out['correct'], out['check']
    assert out['device']['busy_s'] > 0
    assert 'kick' in {n for n, _ in out['breakdown']['idle_gaps']}


def test_number_without_a_limit_is_not_correct(toy_root):
    out = _toy(toy_root, 'toy_nolimit')
    assert not out['correct']
    assert out['check']['v'] == {'value': 0.0, 'limit': None}


def test_limit_without_a_number_is_not_correct(toy_root):
    out = _toy(toy_root, 'toy_extralimit')
    assert not out['correct']
    assert out['check']['w'] == {'value': None, 'limit': 1.0}


def test_verdict_and_readout():
    assert check.verdict({'a': 1.0}, {'a': 1.0})
    assert not check.verdict({'a': 1.0}, {'a': 0.5})
    assert not check.verdict({'a': float('nan')}, {'a': 1.0})
    assert not check.verdict({'a': 0.0, 'b': 0.0}, {'a': 1.0})
    assert not check.verdict({'a': 0.0}, {'a': 1.0, 'b': 1.0})
    assert list(check.readout({'b': 0.0, 'a': 0.0}, {'c': 1.0, 'a': 1.0})) \
        == ['b', 'a', 'c']


def test_reader_of_a_program_span_added_by_a_file(toy_root):
    """A per-layer metric reading lw.gather's device time and host
    transfers, added to the copy by its entry and its reader file."""
    bench = json.loads((toy_root / 'BENCHMARK.json').read_text())
    bench['per_layer'].append({
        'name': 'gather_busy_ms.cols', 'unit': 'ms', 'better': 'lower',
        'source': 'device_trace', 'layer': 'formal solution',
        'moves': 'column_iters_per_s', 'workloads': [COLS]})
    (toy_root / 'BENCHMARK.json').write_text(json.dumps(bench))
    (toy_root / 'lwbench' / 'metrics' / 'gather_busy_ms.cols.py').write_text(
        'def read(run):\n'
        "    return run.program_span('lw.gather', 'busy_ms')\n")
    out = runner.run_cell(COLS, SEED, 0.3, True, root=toy_root,
                          device='cpu')
    assert out['correct'], out['check']
    got = {k: v['value'] for k, v in out['metrics'].items()}
    assert got['gather_busy_ms.cols'] > 0
    for name in ('host_syncs_per_step.cols', 'host_stall_ms.cols',
                 'gamma_rates_launches.cols'):
        assert got[name] >= 0
    assert got['gamma_rates_launches.cols'] > 0


# The check numbers and the untraced metrics' names of the tiny cells at
# the parent commit of the kind modules (one window step: --seconds 0;
# two threads), read by running that commit's tree on this CPU.
PARENT = {
    COLS: ({'J': 3.01894412479764e-11, 'pops': 2.525461953411986e-10,
            'Gamma': 1.6730588390648745e-12},
           ['column_iters_per_s', 'setup_s']),
    SLAB: ({'J': 3.932876370992095e-15, 'pops': 1.4540433606357974e-09,
            'Gamma': 1.4844636951936301e-12},
           ['setup_s', 'step_ms'])}


@pytest.mark.parametrize('cell', [COLS, SLAB])
def test_tiny_cells_read_what_the_parent_read(toy_root, cell):
    out = runner.run_cell(cell, SEED, 0.0, False, root=toy_root,
                          device='cpu')
    assert out['attempted'] == 1 and out['correct']
    numbers, metrics = PARENT[cell]
    assert {k: v['value'] for k, v in out['check'].items()} == numbers
    assert sorted(out['metrics']) == metrics
