"""The PRD work in blocks: ops/prd.py:prd_scatter_rho_plain over blocks
of depths and Context._prd_subset_idxs over blocks of the Doppler factors
give the unblocked result bit for bit, at several block sizes (one of
them not a divisor of the depths or of the factors); on the card, the
plain version's blocked integral equals its unblocked one at a column
batch's size (prd_scatter_rho launches the kernel there, in one launch).

No jax here."""
import numpy as np
import pytest
import torch

from lightweaver_tpu_torch import H_6_atom, MgII_atom
from lightweaver_tpu_torch import constants as Const
from lightweaver_tpu_torch import context
from lightweaver_tpu_torch.ops import prd
from lightweaver_tpu_torch.problems import column_batch, stacked_falc

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)

UNBLOCKED = 1 << 62


def scatter_rho(args, blockElements):
    """The plain prd_scatter_rho (on a card too, where prd_scatter_rho
    launches the kernel) with the block budget ``blockElements``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prd, 'BLOCK_ELEMENTS', blockElements)
        return prd.prd_scatter_rho_plain(*args)


def random_line(W: int, Nk: int, seed: int, device='cpu'):
    """Random arguments of prd_scatter_rho: an increasing window in
    Doppler units per depth, Voigt damping, a positive J."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=g,
                                           dtype=torch.float64)
    qWave = (torch.linspace(-30.0, 30.0, W, dtype=torch.float64)[:, None]
             * u(1, Nk, lo=0.5, hi=1.5)) + u(W, Nk, hi=0.01)
    qWave = torch.sort(qWave, dim=0).values
    args = (qWave, u(Nk, lo=1e-4, hi=0.1), u(W, Nk, lo=0.5, hi=2.0),
            u(Nk, lo=0.1, hi=1.0), u(Nk, lo=0.5, hi=2.0))
    return tuple(a.to(device) for a in args)


@pytest.mark.parametrize('depths', [1, 7, 16, 40, 41])
def test_blocked_scatter_rho_is_unblocked_bit_for_bit(depths):
    W, Nk = 13, 41
    args = random_line(W, Nk, seed=depths)
    ref = scatter_rho(args, UNBLOCKED)
    got = scatter_rho(args, depths * W * prd.NFINE)
    assert got.shape == (W, Nk) and got.is_contiguous()
    assert torch.equal(got, ref)
    # a budget below one depth's elements still takes one depth a block
    assert torch.equal(scatter_rho(args, 1), ref)


def test_default_block_holds_a_small_grid_whole():
    args = random_line(11, 30, seed=3)
    assert torch.equal(prd.prd_scatter_rho(*args),
                       scatter_rho(args, UNBLOCKED))
    assert 30 * 11 * prd.NFINE < prd.BLOCK_ELEMENTS


def subset_numpy(ctx) -> np.ndarray:
    """Context._prd_subset_idxs as one [Nlam, M] numpy pass (the form it
    had before it was blocked)."""
    cfg = ctx.cfg
    prdActive = np.zeros(cfg.Nlam, bool)
    for ai, ti, a, t in ctx._prd_lines():
        prdActive[t.Nblue:t.Nred] = True
    w = np.asarray(cfg.wavelength, np.float64)
    facs = (1.0 + np.array([-1.0, 1.0])[None, :, None]
            * np.asarray(cfg.vlosMu)[:, None, :] / Const.CLight).ravel()
    prevLam = w[np.maximum(np.arange(cfg.Nlam) - 1, 0)]
    nextLam = w[np.minimum(np.arange(cfg.Nlam) + 1, cfg.Nlam - 1)]
    lo = prevLam[:, None] * facs[None, :]
    hi = nextLam[:, None] * facs[None, :]
    iLo = np.maximum(np.searchsorted(w, lo, side='right') - 1, 0)
    iHi = np.minimum(np.searchsorted(w, hi, side='right') + 1, cfg.Nlam)
    cum = np.concatenate([[0], np.cumsum(prdActive)])
    prdActive |= ((cum[iHi] - cum[iLo]) > 0).any(axis=1)
    return np.nonzero(prdActive)[0]


@pytest.fixture(scope='module')
def hprd_batch():
    """Three columns of 12 depths, H 6 + Mg II active in hybrid PRD, with
    top velocities of -40, 0 and +25 km/s (ramps in height)."""
    C, Nk = 3, 12
    h = stacked_falc(C, Nk)[0]
    ramp = (h - h.min()) / (h.max() - h.min())
    vlos = np.array([-40e3, 0.0, 25e3])[:, None] * ramp[None, :]
    return column_batch(C, models=lambda: [H_6_atom(), MgII_atom()],
                        activeSpecies=('H', 'Mg'), Nk=Nk, vlos=vlos, Nrays=2,
                        device='cpu', hprd=True)


def test_blocked_subset_is_unblocked(hprd_batch, monkeypatch):
    fc = hprd_batch.flatCtx
    ref = subset_numpy(fc)
    M = fc.cfg.vlosMu.size * 2
    windows = sum(t.W for ai, ti, a, t in fc._prd_lines())
    # the velocities widen the subset past the union of the windows
    assert len(ref) > len(fc.cfg.prdIdxs) and len(ref) > windows // 2
    assert np.array_equal(fc._prd_subset_idxs(), ref)
    for block in (1, 7, 50, M, M + 3):
        monkeypatch.setattr(context, 'BLOCK_ELEMENTS', block * fc.cfg.Nlam)
        assert np.array_equal(fc._prd_subset_idxs(), ref), block
    monkeypatch.setattr(context, 'BLOCK_ELEMENTS', 1)
    assert np.array_equal(fc._prd_subset_idxs(), ref)


@pytest.mark.gpu
def test_blocked_scatter_rho_on_the_card():
    """At 64 columns' depths and the Mg II k window's 250 rows, in blocks of
    each size, the plain version's result on the card equals its unblocked
    one."""
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device')
    W, Nk = 250, 64 * 82
    args = random_line(W, Nk, seed=11, device='cuda')
    ref = scatter_rho(args, UNBLOCKED)
    for depths in (1000, 777, 64 * 82 - 1):
        assert torch.equal(scatter_rho(args, depths * W * prd.NFINE), ref), \
            depths
    assert torch.equal(prd.prd_scatter_rho_plain(*args), ref)
