"""The PRD work's spans (lightweaver_tpu_torch.tracing): one traced MALI
step of a tiny hybrid-PRD ColumnBatch (H 6 + Mg II, four PRD lines)
followed by prd_redistribute nests lw.prd.redistribute, one
lw.prd.subiter per sub-iteration, lw.prd.scatter_rho per line and
sub-iteration, lw.prd.subset_solve per sub-iteration, lw.hprd.rest_frame_j
in the MALI step, and drho's read in lw.host.drho_to_host; the single
Context's prd_redistribute reports the same lw.prd.* paths; and the
tracer changes no number of the PRD step.

No jax here."""
import numpy as np
import pytest
import torch

from lightweaver_tpu_torch import H_6_atom, MgII_atom, problems, tracing
from lightweaver_tpu_torch.problems import column_batch, stacked_falc

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)

FSGM = 'lw.formal_sol_gamma_matrices'
RED = 'lw.prd.redistribute'
SUB = f'{RED}/lw.prd.subiter'


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def batch():
    """Two columns of 10 depths, H 6 + Mg II active in hybrid PRD, one
    column with a 10 km/s ramp, after its first MALI step and PRD
    redistribution."""
    C, Nk = 2, 10
    h = stacked_falc(C, Nk)[0]
    vlos = np.zeros((C, Nk))
    vlos[1] = 1e4 * (h - h.min()) / (h.max() - h.min())
    b = column_batch(C, models=lambda: [H_6_atom(), MgII_atom()],
                     activeSpecies=('H', 'Mg'), Nk=Nk, vlos=vlos, Nrays=1,
                     device='cpu', hprd=True)
    prd_step(b)
    return b


def prd_step(obj, maxIter=2):
    obj.formal_sol_gamma_matrices()
    obj.stat_equil()
    # tol 0: every sub-iteration runs
    return obj.prd_redistribute(maxIter=maxIter, tol=0.0)


def test_batch_prd_step_spans_and_reads():
    b = batch()
    tracing.enable()
    upd = prd_step(b, maxIter=2)
    tracing.disable()
    got = tracing.collect()
    n = upd.NprdSubIter
    assert n == 2 and len(b.flatCtx._prd_lines()) == 4
    assert got[RED]['count'] == 1
    assert got[SUB]['count'] == n
    assert got[f'{SUB}/lw.prd.scatter_rho']['count'] == 4 * n
    assert got[f'{SUB}/lw.prd.subset_solve']['count'] == n
    assert got[f'{FSGM}/lw.hprd.rest_frame_j']['count'] == 1
    drho = got[f'{SUB}/lw.host.drho_to_host']
    assert (drho['count'], drho['host_reads'], drho['host_writes']) == (
        n, n, 0)
    assert drho['host_read_bytes'] == n * 8 * b.Ncol
    # the masks of the converged columns: one write each
    assert got[f'{RED}/lw.host.frozen_mask']['host_writes'] == 2
    # the integral and the subset solve read nothing back
    for path in (f'{SUB}/lw.prd.scatter_rho', f'{SUB}/lw.prd.subset_solve'):
        assert got[path]['host_reads'] == got[path]['host_writes'] == 0


def test_batch_stops_where_drho_falls_below_tol():
    b = batch()
    tracing.enable()
    upd = b.prd_redistribute(maxIter=3, tol=1e30)
    tracing.disable()
    got = tracing.collect()
    assert upd.NprdSubIter == 1 == got[SUB]['count']


def test_context_prd_redistribute_same_paths():
    ctx = problems.h6mg_context(problems.falc_decimated(12), Nrays=1,
                                hprd=True, device='cpu')
    prd_step(ctx)
    tracing.enable()
    upd = prd_step(ctx, maxIter=2)
    tracing.disable()
    got = tracing.collect()
    n = upd.NprdSubIter
    assert n == 2
    assert got[RED]['count'] == 1 and got[SUB]['count'] == n
    assert got[f'{SUB}/lw.prd.scatter_rho']['count'] == 4 * n
    assert got[f'{SUB}/lw.prd.subset_solve']['count'] == n
    assert got[f'{FSGM}/lw.hprd.rest_frame_j']['count'] == 1
    # rho to the host for the tracking Ng: each line each sub-iteration
    assert got[f'{SUB}/lw.host.rho_to_host']['host_reads'] == 4 * n


def test_tracer_changes_no_number_of_the_prd_step():
    off, on = batch(), batch()
    prd_step(off)
    tracing.enable()
    prd_step(on)
    tracing.disable()
    for x, y in zip([off.params['J'], off.JRest, *off.params['pops']]
                    + [r for row in off.params['rhoPrd'] for r in row
                       if r is not None],
                    [on.params['J'], on.JRest, *on.params['pops']]
                    + [r for row in on.params['rhoPrd'] for r in row
                       if r is not None]):
        assert torch.equal(x, y)
