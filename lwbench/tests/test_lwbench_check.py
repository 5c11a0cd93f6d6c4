"""The harness against the reference (lwbench/reference: the MALI step
written from the method) at a size the CPU holds (4 columns of 20
depths, under the default and the fused scheme; a 20 x 8 slab): a sound
run is correct and reads at rounding (J 3e-11, pops 2.5e-10 to 1.5e-9,
Gamma 1.7e-12 here: the reference and the program compute the same
step), the control (the program's float32 path) is not correct, and
neither is a run
whose timed path is broken underneath in each way the cells can break:
a step that returns its state unchanged, half of the batch (or slab)
left out, an answer altered where it is produced.  One cell has one chip,
so no exchange between chips can be left out.  A traced run reports
every per-layer metric that BENCHMARK.json lists for its cell and that a
CPU run can read."""
import json
import math

import pytest
import torch

from lightweaver_tpu_torch import context as program_context
from lwbench.harness import runner
from lwbench.harness.manifest import ROOT
from lwbench.tests.tiny import COLS, FUSED, SLAB, tiny_root

CELLS = [COLS, SLAB, FUSED]
# read from the card alone: kernels by name, the card's memory
CARD_ONLY = {'formal_solve_roofline.cols', 'formal_solve_roofline.fused',
             'peak_mem_gib.cols', 'peak_mem_gib.2d', 'peak_mem_gib.fused'}

SEED = 2 ** 31 + 5


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_root(tmp_path_factory.mktemp('tiny'))


def run(root, cell, **kw):
    return runner.run_cell(cell, SEED, 0.5, False, root=root, device='cpu',
                           **kw)


def numbers(out):
    return {k: v['value'] for k, v in out['check'].items()}


def _state_of(system):
    """(get, set) of the program object's J and populations."""
    obj = getattr(system, 'b', None)
    if obj is not None:
        return (lambda: (obj.params['J'], list(obj.params['pops'])),
                lambda J, pops: (obj.params.__setitem__('J', J),
                                 obj.params.__setitem__('pops', pops)))
    ctx = system.ctx

    def set_(J, pops):
        ctx.J = J
        for st, n in zip(ctx.popsState, pops):
            st['n'] = n
    return (lambda: (ctx.J, [st['n'] for st in ctx.popsState]), set_)


def unchanged(system):
    """Every MALI step hands back the state it started from."""
    get, set_ = _state_of(system)
    prog = getattr(system, 'b', None) or system.ctx
    fsgm, se = prog.formal_sol_gamma_matrices, prog.stat_equil

    def fsgm_(*a, **k):
        J, pops = get()
        out = fsgm(*a, **k)
        set_(J, pops)
        return out

    def se_():
        J, pops = get()
        out = se()
        set_(J, pops)
        return out
    prog.formal_sol_gamma_matrices, prog.stat_equil = fsgm_, se_


def half_left_out(system):
    """The second half of the points keeps its state in every step."""
    get, set_ = _state_of(system)
    prog = getattr(system, 'b', None) or system.ctx
    se = prog.stat_equil
    state = {'J': None, 'pops': None}

    def keep_half(J, pops):
        h = J.shape[-1] // 2
        J = J.clone()
        J[..., h:] = state['J'][..., h:]
        out = []
        for n, n0 in zip(pops, state['pops']):
            n = n.clone()
            n[..., h:] = n0[..., h:]
            out.append(n)
        return J, out

    def se_():
        if state['J'] is None:
            state['J'], state['pops'] = get()
            return se()
        out = se()
        set_(*keep_half(*get()))
        state['J'], state['pops'] = get()
        return out
    prog.stat_equil = se_


@pytest.mark.parametrize('cell', CELLS)
def test_sound_run_is_correct(root, cell):
    out = run(root, cell)
    assert out['correct'], out['check']
    assert all(v <= 1e-8 for v in numbers(out).values()), out['check']
    assert out['attempted'] >= 1 and out['metrics']['setup_s']['value'] > 0


@pytest.mark.parametrize('cell', CELLS)
def test_control_float32_is_not_correct(root, cell):
    out = run(root, cell, dtype='float32')
    assert not out['correct'], out['check']


@pytest.mark.parametrize('cell', CELLS)
@pytest.mark.parametrize('fault', [unchanged, half_left_out])
def test_broken_step_is_not_correct(root, cell, fault):
    out = run(root, cell, fault=fault)
    assert not out['correct'], (fault.__name__, out['check'])


@pytest.mark.parametrize('cell,stage', [(COLS, 'formal_solve'),
                                        (SLAB, 'formal_solve'),
                                        (FUSED, 'fused_stage')])
def test_altered_answer_is_not_correct(root, cell, stage, monkeypatch):
    """One wavelength row of J altered by 1e-5 where the formal solution
    (the fused scheme's: its fused stage) produces it."""
    solve = getattr(program_context, stage)

    def altered(*args, **kwargs):
        I, Psi, IeffBase, moments, *rest = solve(*args, **kwargs)
        J = moments['J'].clone()
        J[J.shape[0] // 2] *= 1.0 + 1e-5
        return (I, Psi, IeffBase, dict(moments, J=J), *rest)
    monkeypatch.setattr(program_context, stage, altered)
    out = run(root, cell)
    assert not out['correct'], out['check']
    assert numbers(out)['J'] > 1e-6


@pytest.mark.parametrize('cell', CELLS)
def test_traced_run_reports_its_layers(root, cell):
    out = runner.run_cell(cell, SEED, 0.5, True, root=root, device='cpu')
    assert out['correct'], out['check']
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    listed = {m['name'] for m in bench['per_layer']
              if cell in m['workloads']}
    assert set(out['metrics']) == listed - CARD_ONLY
    assert all(math.isfinite(v['value']) and v['value'] >= 0
               for v in out['metrics'].values()), out['metrics']
    spans = {n for n, _ in out['breakdown']['idle_gaps']}
    assert spans <= {'gather', 'formal_solve', 'gamma_rates', 'stat_equil',
                     'outside_stages'}
    assert len(out['breakdown']['device_ops']) <= 10
    # the stage wrappers are gone once the run is over
    assert program_context.formal_solve.__name__ == 'formal_solve'


@pytest.mark.gpu
def test_tiny_cells_correct_on_the_card(root):
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device')
    for cell in CELLS:
        out = runner.run_cell(cell, SEED, 0.5, True, root=root,
                              device='cuda')
        assert out['correct'], out['check']
        assert out['device']['busy_s'] > 0
