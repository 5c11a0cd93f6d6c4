"""The manifest and the files it names load by name, a cell added by
files alone is found, and BENCHMARK.json keeps to the benchmark's
contract on names, units and sizes."""
import json
import re
import shutil

import pytest

from lwbench.harness import manifest
from lwbench.harness.manifest import ROOT

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024
    assert 1 <= BENCH['run_seconds'] <= 51
    assert BENCH['paths'] == ['lwbench']
    assert BENCH['command'][1] == 'lwbench/run.py'


@pytest.mark.parametrize('section', ['configs', 'workloads', 'end_to_end',
                                     'per_layer'])
def test_names_units_and_lines(section):
    names = [e['name'] for e in BENCH[section]]
    assert len(set(names)) == len(names)
    for e in BENCH[section]:
        assert NAME.match(e['name']), e['name']
        if 'unit' in e:
            assert UNIT.match(e['unit']), e['unit']
            assert e['better'] in ('lower', 'higher')
        for key in ('why', 'layer', 'source'):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and '\n' not in e[key] \
                    and '\t' not in e[key]


def test_metric_keys_and_moves():
    e2e = {m['name'] for m in BENCH['end_to_end']}
    cells = {w['name'] for w in BENCH['workloads']}
    assert 'setup_s' in e2e
    for m in BENCH['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in BENCH['per_layer']:
        assert set(m) == {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['moves'] in e2e and set(m['workloads']) <= cells
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')


@pytest.mark.parametrize('workload', [w['name'] for w in BENCH['workloads']])
def test_every_cell_loads_with_its_files(workload):
    cell = manifest.load_cell(workload)
    assert cell.chips == 1
    assert manifest.kind_path(cell.config['kind']).is_file()
    assert set(cell.settings['limits']) == set(cell.kind.NUMBERS)
    e2e = [m['name'] for m in cell.metrics(perLayer=False)]
    assert 'setup_s' in e2e and len(e2e) >= 2
    layer = cell.metrics(perLayer=True)
    assert layer
    for m in e2e + [m['name'] for m in layer]:
        assert callable(manifest.load_reader(m))


def test_config_files_state_what_the_manifest_says():
    for c in BENCH['configs']:
        data = json.loads((ROOT / c['file']).read_text())
        assert data['name'] == c['name']
        assert set(data['reduced_why']) == set(c['reduced'])


def test_a_cell_added_by_files_alone(tmp_path):
    """A new workload entry plus its cell file, traffic and metric in a
    temporary copy is found by name; no harness file names it."""
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'lwbench', tmp_path / 'lwbench',
                    ignore=shutil.ignore_patterns('reference', 'tests',
                                                  '__pycache__'))
    bench = json.loads((tmp_path / 'BENCHMARK.json').read_text())
    bench['workloads'].append({'name': 'cols512_other',
                               'config': 'falc_h6ca_cols512',
                               'traffic': 'mali_other', 'chips': 1,
                               'why': 'a test cell'})
    bench['per_layer'].append({'name': 'other_ms', 'unit': 'ms',
                               'better': 'lower', 'source': 'program_span',
                               'layer': 'column batch',
                               'moves': 'column_iters_per_s',
                               'workloads': ['cols512_other']})
    bench['end_to_end'][0]['workloads'].append('cols512_other')
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    lw = tmp_path / 'lwbench'
    (lw / 'traffic' / 'mali_other.json').write_text(json.dumps(
        {'scheme': 'mali_full_precond_fused', 'nscatter': 3, 'jtol': 5e-3,
         'popstol': 1e-3}))
    shutil.copy(lw / 'cells' / 'cols512_default.json',
                lw / 'cells' / 'cols512_other.json')
    (lw / 'metrics' / 'other_ms.py').write_text(
        'def read(run):\n    return 1.5\n')
    cell = manifest.load_cell('cols512_other', tmp_path)
    assert cell.traffic['scheme'] == 'mali_full_precond_fused'
    assert cell.config['columns'] == 512
    assert [m['name'] for m in cell.metrics(perLayer=True)] == ['other_ms']
    assert 'column_iters_per_s' in [m['name']
                                    for m in cell.metrics(perLayer=False)]
    assert manifest.load_reader('other_ms', tmp_path)(None) == 1.5
    with pytest.raises(KeyError):
        manifest.load_cell('no_such_cell', tmp_path)


def test_suffixed_metric_falls_back_to_its_quantity(tmp_path):
    """<quantity>.<suffix> reads lwbench/metrics/<quantity>.py unless it
    has a file of its own."""
    metrics = tmp_path / 'lwbench' / 'metrics'
    metrics.mkdir(parents=True)
    (metrics / 'q_ms.py').write_text('def read(run):\n    return 1.0\n')
    (metrics / 'q_ms.b.py').write_text('def read(run):\n    return 2.0\n')
    assert manifest.load_reader('q_ms.a', tmp_path)(None) == 1.0
    assert manifest.load_reader('q_ms.b', tmp_path)(None) == 2.0
    assert manifest.load_reader('q_ms', tmp_path)(None) == 1.0
    assert manifest.reader_path('formal_solve_roofline.2d').name == \
        'formal_solve_roofline.2d.py'


def test_unknown_kind_raises_listing_the_kinds(tmp_path):
    with pytest.raises(KeyError, match='column_batch.*context_2d'):
        manifest.load_kind('no_such_kind')
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'lwbench', tmp_path / 'lwbench',
                    ignore=shutil.ignore_patterns('reference', 'tests',
                                                  '__pycache__'))
    cfg = tmp_path / 'lwbench' / 'configs' / 'falc_h6ca_cols512.json'
    cfg.write_text(json.dumps(dict(json.loads(cfg.read_text()),
                                   kind='no_such_kind')))
    with pytest.raises(KeyError, match="no kind 'no_such_kind'"):
        manifest.load_cell('cols512_default', tmp_path)
