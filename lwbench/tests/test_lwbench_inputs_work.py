"""The inputs made from the seed by each kind's generator, the kinds'
shapes and compared columns, and the formal solution's count at the
cells' shapes."""
import numpy as np
import pytest

from lightweaver_tpu_torch.problems import stacked_falc
from lwbench.harness import inputs, manifest
from lwbench.harness.work import formal_solution_work

COLUMNS = manifest.load_kind('column_batch')
SLAB = manifest.load_kind('context_2d')


@pytest.mark.parametrize('C,Nk,seed', [(8, 82, 1), (3, 20, 2 ** 33 + 7)])
def test_columns_match_problems_stacked_falc(C, Nk, seed):
    cfg = {'columns': C, 'depths': Nk, 'temperature_spread': 0.05}
    ours = COLUMNS.make_inputs(cfg, seed)
    theirs = stacked_falc(C, Nk, seed=seed, spread=0.05)
    for key, ref in zip(inputs.FIELDS, theirs):
        np.testing.assert_array_equal(ours[key], ref)


def test_slab_same_shapes_every_seed_and_peak():
    cfg = manifest.load_cell('slab2d_besser').config
    a, b = SLAB.make_inputs(cfg, 3), SLAB.make_inputs(cfg, 2 ** 31 + 11)
    assert {k: v.shape for k, v in a.items()} == \
        {k: v.shape for k, v in b.items()}
    assert a['temperature'].shape == (82, 256)
    for x in (a, b):
        pert = x['temperature'] / x['temperature'][:, :1].mean(axis=1,
                                                               keepdims=True)
        dev = x['temperature'][0] / inputs.falc_depths(82)['temperature'][0]
        assert np.isclose(np.abs(dev - 1).max(), 0.05)
        assert np.all(pert > 0)
        assert np.isclose(np.abs(x['vx']).max(), 1000.0, rtol=1e-3)
    assert not np.array_equal(a['temperature'], b['temperature'])
    np.testing.assert_array_equal(SLAB.make_inputs(cfg, 3)['temperature'],
                                  a['temperature'])


def test_negative_seed_refused():
    with pytest.raises(ValueError):
        inputs.check_seed(-1)


def test_formal_solution_count_at_the_cells_shapes():
    cols = formal_solution_work(1046, 5, 512 * 82)
    assert cols['bytes'] == 8 * 1046 * 41984 * 23
    assert cols['flops'] == 100 * 1046 * 10 * 41984
    assert cols['bound_by'] == 'bytes'
    assert cols['least_s'] == pytest.approx(2.4121e-3, rel=1e-4)
    slab = formal_solution_work(546, 12, 256 * 82)
    assert slab['bytes'] == 8 * 546 * 20992 * 51
    assert slab['bound_by'] == 'bytes'
    assert slab['least_s'] == pytest.approx(1.3959e-3, rel=1e-4)
    assert formal_solution_work(1046, 5, 41984, 'float32')['least_s'] == \
        pytest.approx(cols['least_s'] / 2)


@pytest.mark.parametrize('workload,expect', [
    ('cols512_default', {'Nlam': 1046, 'Nmu': 5, 'Nk': 41984}),
    ('slab2d_besser', {'Nlam': 546, 'Nmu': 12, 'Nk': 20992}),
    ('cols512_fused', {'Nlam': 1046, 'Nmu': 5, 'Nk': 41984})])
def test_shapes_of_the_cells(workload, expect):
    cell = manifest.load_cell(workload)
    assert cell.kind.shapes(cell.config) == expect
    assert cell.config['wavelengths'] == expect['Nlam']


def test_check_columns_drawn_from_the_seed():
    cell = manifest.load_cell('cols512_default')
    draw = cell.kind.check_units
    a = draw(cell.config, cell.settings, 5)
    assert a == draw(cell.config, cell.settings, 5)
    assert len(set(a)) == cell.settings['check_columns']
    assert a != draw(cell.config, cell.settings, 6)
    assert max(a) < 512
    slab = manifest.load_cell('slab2d_besser')
    assert slab.kind.check_units(slab.config, slab.settings, 5) == []
