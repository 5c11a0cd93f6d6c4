"""The port's distribution on a card: ranks of their own processes on
one NVIDIA GPU, joined by gloo (NCCL refuses two ranks on one device),
and NCCL at world size 1.  The same cases as the CPU tests
(tests/test_torch_distributed.py, test_torch_xshard2d.py), against the
unsharded port on the card.

No jax here, so the file also runs where only torch is installed; on a
machine with an NVIDIA GPU:

    python -m pytest tests/test_torch_distributed_card.py --noconftest -q

Without a GPU the tests marked gpu skip.
"""
import numpy as np
import pytest
import torch

import torch_dist_cases as tc


# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')


def _rel(ours, ref):
    return float(np.max(np.abs(np.asarray(ours) / np.asarray(ref) - 1.0)))


@pytest.mark.gpu
def test_sharded_batch_on_the_card(tmp_path):
    """8 columns on a (2, 1) and a (1, 2) mesh of two gloo ranks on the
    card, 5 MALI steps + stat_equil: J after the first step equal to the
    unsharded batch's on the card (1e-12), and after 5 steps pops and J
    within 1e-9: on the card torch's lambda reductions over 4 columns
    take another order than over 8 (3.8e-11 measured on the (2, 1) mesh,
    not bit for bit as on the CPU), and the wavelength axis splits them
    in two; the refusals."""
    _card()
    from lightweaver_tpu_torch.parallel import ColumnBatch
    from lightweaver_tpu_torch.problems import stacked_falc
    shapes = ((2, 1), (1, 2))
    ranks = tc.spawn_ranks(tc.columns_case, 2, tmp_path,
                           args=(shapes, 'cuda'))
    b = ColumnBatch.from_stacked(*stacked_falc(tc.COLUMNS_C, tc.COLUMNS_NK),
                                 tc.models, ('Ca',), Nrays=2)
    for i in range(tc.COLUMNS_STEPS):
        b.formal_sol_gamma_matrices()
        if i == 0:
            J1 = b.J
        b.stat_equil()
    out = ranks.result()
    for shape in shapes:
        res = out[shape]
        assert _rel(res['J1'], J1) < 1e-12
        assert _rel(res['pops'][0], b.pops[0]) < 1e-9, shape
        assert _rel(res['J'], b.J) < 1e-9, shape
    assert all(m and not m.startswith('wrong') for m in out['raises'].values())


@pytest.mark.gpu
def test_xsharded_context_on_the_card(tmp_path):
    """The 16 x 8 2D Context x-sharded over two gloo ranks on the card, 3
    MALI steps each with stat_equil, periodic (linear, BESSER) and with
    callable x boundaries: J after the first step within 1e-12 per
    wavelength of the unsharded Context on the card, pops, J and I after
    3 within 1e-8."""
    _card()
    ctx0 = tc.context_2d(device='cuda')
    ctx0.depthData.fill = True
    ctx0.formal_sol_gamma_matrices()
    cfg = ctx0.cfg
    bc = ctx0.depthData.I.cpu().numpy().reshape(
        cfg.Nlam, cfg.Nmu, 2, cfg.Nz, cfg.Nx)[..., 0].copy()
    ranks = tc.spawn_ranks(tc.context_2d_case, 2, tmp_path,
                           args=(bc, False, 'cuda'))
    refs = {}
    for name, kw in tc.CTX_CASES.items():
        kw = dict(kw)
        ctx = tc.context_2d(xBcData=bc if kw.pop('xBc', False) else None,
                            device='cuda', **kw)
        tc.context_steps(ctx, 1)
        J1 = ctx.J.cpu().numpy()
        tc.context_steps(ctx, tc.CTX_STEPS - 1)
        refs[name] = (J1, ctx.popsState[0]['n'].cpu().numpy(),
                      ctx.J.cpu().numpy(), ctx.I.cpu().numpy())
    out = ranks.result()
    for name, (J1, pops, J, I) in refs.items():
        res = out[name]
        err1 = (np.abs(res['J1'] - J1).max(axis=1)
                / np.abs(J1).max(axis=1)).max()
        assert err1 < 1e-12, name
        assert _rel(res['pops'], pops) < 1e-8, name
        assert _rel(res['J'], J) < 1e-8, name
        assert _rel(res['I'], I) < 1e-8, name


@pytest.mark.gpu
def test_nccl_at_world_size_one(tmp_path):
    """initialize_multihost(num_processes=1)'s NCCL group on the card: the
    collectives the port uses, and a batch on the (1, 1) mesh equal to
    the batch without one."""
    _card()
    out = tc.spawn_ranks(tc.nccl_case, 1, tmp_path, backend='nccl').result()
    assert out['backend'] == 'nccl' and all(out['ok'].values()), out['ok']
    np.testing.assert_array_equal(*out['pops'])
