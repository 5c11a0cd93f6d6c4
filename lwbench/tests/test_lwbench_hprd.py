"""The hybrid-PRD cell cols_h6mg_prd at a size the CPU holds (its own tiny
copy: 4 columns of 20 depths, every column compared): a sound run is
correct and reads at rounding against the plain PRD reference
(reference/prd.py), the control (the program's float32 path) is not
correct, and neither is a run broken in each way hybrid PRD can break:
rho held at 1 (a CRD step), the velocities zeroed in the program alone
(plain PRD), one PRD sub-iteration fewer than the batch's settings.  A
traced run reports every per-layer metric BENCHMARK.json lists for the
cell that a CPU run can read, with the sub-iterations the batch took.
The reference imports neither the program nor the JAX package, and the
least time of the scattering integrals comes from the shapes alone."""
import json
import math
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lwbench.harness import prd_work, runner
from lwbench.harness.manifest import ROOT
from lwbench.tests.tiny import edit_json, tiny_root

CELL = 'cols_h6mg_prd'
CONFIG = 'falc_h6mg_hprd_cols512'
# read from the card alone: the card's memory
CARD_ONLY = {'peak_mem_gib.hprd'}
SEED = 2 ** 31 + 5


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    torch.set_num_threads(2)
    tmp = tiny_root(tmp_path_factory.mktemp('tiny_hprd'))
    edit_json(tmp / 'lwbench' / 'configs' / f'{CONFIG}.json', columns=4,
              depths=20)
    edit_json(tmp / 'lwbench' / 'cells' / f'{CELL}.json', check_columns=4)
    return tmp


def run(root, **kw):
    return runner.run_cell(CELL, SEED, 0.5, False, root=root, device='cpu',
                           **kw)


def numbers(out):
    return {k: v['value'] for k, v in out['check'].items()}


def test_sound_run_is_correct(root):
    out = run(root)
    assert out['correct'], out['check']
    got = numbers(out)
    assert set(got) == {'J', 'pops', 'Gamma', 'rho', 'JRest',
                        'prd_subiters'}
    assert all(v <= 1e-8 for v in got.values()), out['check']
    assert got['prd_subiters'] == 0.0
    assert out['attempted'] >= 1 and out['metrics']['setup_s']['value'] > 0
    assert out['metrics']['step_ms']['value'] > 0
    assert 'column_iters_per_s' not in out['metrics']


def test_control_float32_is_not_correct(root):
    out = run(root, dtype='float32')
    assert not out['correct'], out['check']


def rho_held_at_one(system):
    """prd_redistribute does nothing: every step a CRD step."""
    b = system.b
    b.prd_redistribute = lambda maxIter=3, tol=1e-2: SimpleNamespace(
        NprdSubIter=maxIter)


def one_subiteration_fewer(system):
    """prd_redistribute stops one sub-iteration before the settings."""
    b = system.b
    redistribute = b.prd_redistribute
    b.prd_redistribute = lambda maxIter=3, tol=1e-2: redistribute(
        maxIter=maxIter - 1, tol=tol)


@pytest.mark.parametrize('fault', [rho_held_at_one, one_subiteration_fewer])
def test_broken_prd_step_is_not_correct(root, fault):
    out = run(root, fault=fault)
    assert not out['correct'], (fault.__name__, out['check'])
    if fault is one_subiteration_fewer:
        assert numbers(out)['prd_subiters'] == math.inf


def test_velocities_zeroed_in_the_program_are_not_correct(root, monkeypatch):
    """The program built on vlos = 0 (plain PRD) while the reference takes
    the seed's velocities."""
    from lightweaver_tpu_torch.parallel import ColumnBatch
    stacked = ColumnBatch.from_stacked.__func__

    def still(cls, height, temperature, vlos, *args, **kwargs):
        return stacked(cls, height, temperature, np.zeros_like(vlos), *args,
                       **kwargs)
    monkeypatch.setattr(ColumnBatch, 'from_stacked', classmethod(still))
    out = run(root)
    assert not out['correct'], out['check']
    assert numbers(out)['rho'] > 1e-6


def test_traced_run_reports_its_layers(root):
    out = runner.run_cell(CELL, SEED, 0.5, True, root=root, device='cpu')
    assert out['correct'], out['check']
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    listed = {m['name'] for m in bench['per_layer']
              if CELL in m['workloads']}
    assert set(out['metrics']) == listed - CARD_ONLY
    values = {k: v['value'] for k, v in out['metrics'].items()}
    assert all(math.isfinite(v) and v >= 0 for v in values.values()), values
    # from LTE every sub-iteration of the settings runs
    assert values['prd_subiters.hprd'] == 3.0
    assert 0 < values['prd_scatter_roofline.hprd'] < 100
    spans = {n for n, _ in out['breakdown']['idle_gaps']}
    assert spans <= {'gather', 'formal_solve', 'gamma_rates', 'stat_equil',
                     'prd', 'outside_stages'}


def test_least_time_from_the_shapes():
    config = json.loads((ROOT / 'lwbench' / 'configs'
                         / f'{CONFIG}.json').read_text())
    windows = prd_work.prd_windows(config)
    assert windows == list(config['prd_lines'].values()) == [101, 51, 250,
                                                            219]
    assert prd_work.FINE_POINTS == 54
    w = prd_work.scatter_work(windows, 512 * 82)
    assert w['flops'] == 20 * 54 * 512 * 82 * 621
    assert w['bytes'] == 16 * 512 * 82 * 621
    assert w['bound_by'] == 'operations'
    assert w['least_s'] == pytest.approx(w['flops'] / 34e12)
    run = SimpleNamespace(kind='column_batch_hprd', Nk=512 * 82, Nmu=5)
    assert prd_work.config_of(run, ROOT)['name'] == CONFIG
    assert prd_work.config_of(SimpleNamespace(kind='column_batch_hprd',
                                              Nk=7, Nmu=5), ROOT) is None


SCRIPT = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    from lwbench.reference import prd
    from lwbench.harness import prd_work
    bad = sorted(m for m in sys.modules if m.split('.', 1)[0] in
                 ('jax', 'jaxlib', 'flax', 'lightweaver_tpu',
                  'lightweaver_tpu_torch'))
    from lwbench.harness import manifest
    manifest.load_kind('column_batch_hprd')
    from lwbench.harness import runner
    print('REFERENCE', bad, 'KIND', runner.jax_modules())
""")


def test_reference_imports_neither_the_program_nor_jax():
    env = dict(os.environ, OMP_NUM_THREADS='1')
    res = subprocess.run([sys.executable, '-c', SCRIPT, str(ROOT)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert 'REFERENCE [] KIND []' in res.stdout, res.stdout


@pytest.mark.gpu
def test_tiny_cell_correct_on_the_card(root):
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device')
    out = runner.run_cell(CELL, SEED, 0.5, True, root=root, device='cuda')
    assert out['correct'], out['check']
    assert out['device']['busy_s'] > 0
    values = {k: v['value'] for k, v in out['metrics'].items()}
    assert values['prd_subiters.hprd'] == 3.0
    assert 0 < values['prd_scatter_roofline.hprd'] < 100
