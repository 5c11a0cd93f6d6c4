"""The PRD scattering kernel (csrc/prd_scatter.cu, ops/prd.py:
prd_scatter_cuda): on the card against the plain torch version
(prd_scatter_rho_plain) in float64, the wrapper's input checks, and that
CPU tensors take the plain version without loading the kernel.

No jax here, so the file also runs where only torch is installed; on a
machine with an NVIDIA GPU:

    python -m pytest tests/test_torch_prd_kernel.py --noconftest -q

Without a GPU the tests marked gpu skip.
"""
import numpy as np
import pytest
import torch

from lightweaver_tpu_torch import H_6_atom, RadiativeSet
from lightweaver_tpu_torch.context import Context
from lightweaver_tpu_torch.ops import _build, prd
from lightweaver_tpu_torch.problems import falc_interpolated

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)

# max |kernel - plain| / max |plain|: the kernel's sums run in fine-point
# order and it contracts multiply-adds, the plain version's do neither
TOL = 1e-12
# the depths of 8 columns of the hybrid-PRD column batch, and its four
# PRD windows (Ly-alpha, Ly-beta, Mg II k, Mg II h)
BATCH_NK = 8 * 82
BATCH_WINDOWS = (101, 51, 250, 219)


def line(W: int, Nk: int, seed: int, span=30.0, ties=False,
         device='cpu'):
    """Arguments of prd_scatter_rho: a window of W rows rising in Doppler
    units at every depth over about [-span, span] (a different scale per
    depth, so both signs and every branch of gII appear), Voigt damping,
    a positive J, the rates' prefactor and Jbar; ``ties`` repeats rows
    (empty interpolation intervals)."""
    rng = np.random.default_rng(seed)
    q = (np.linspace(-span, span, W)[:, None] * rng.uniform(0.5, 1.5, Nk)
         + rng.uniform(0.0, 0.01, (W, Nk)))
    q = np.sort(q, axis=0)
    if ties and W > 12:
        q[5:8] = q[5]
        q[W - 3] = q[W - 4]
    args = (q, rng.uniform(1e-4, 0.1, Nk), rng.uniform(0.5, 2.0, (W, Nk)),
            rng.uniform(0.1, 1.0, Nk), rng.uniform(0.5, 2.0, Nk))
    return tuple(torch.tensor(a, dtype=torch.float64, device=device)
                 for a in args)


CASES = {
    # (W, Nk, span, ties): every regime of both signs over a wide window
    'W250_wide': (250, 1000 + 3, 30.0, False),
    'W51_wide': (51, 37, 30.0, False),
    # a window inside the core: the fine grid [-4, 4] runs past both ends
    'W51_narrow': (51, 45, 1.5, False),
    'W2': (2, 33, 3.0, False),
    'W1': (1, 31, 1.0, False),
    'W250_ties': (250, 97, 10.0, True),
    **{f'batch_W{W}': (W, BATCH_NK, 40.0, False) for W in BATCH_WINDOWS},
}


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')


@pytest.mark.gpu
@pytest.mark.parametrize('case', list(CASES))
def test_kernel_matches_plain(case):
    """rho from one launch equals the plain version's on the card within
    TOL of its maximum, and CUDA tensors take the kernel."""
    cuda_or_skip()
    W, Nk, span, ties = CASES[case]
    args = line(W, Nk, seed=len(case) + W, span=span, ties=ties,
                device='cuda')
    ref = prd.prd_scatter_rho_plain(*args)
    n0 = prd.prd_scatter_cuda.launches
    got = prd.prd_scatter_rho(*args)
    torch.cuda.synchronize()
    assert prd.prd_scatter_cuda.launches == n0 + 1
    assert got.shape == (W, Nk) and got.dtype == torch.float64
    assert torch.isfinite(got).all()
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    assert err <= TOL, err


@pytest.mark.gpu
def test_kernel_takes_accum_float32():
    """A float32 J and Jbar (accumDtype=float32) reach the kernel in
    float64, exactly converted."""
    cuda_or_skip()
    args = list(line(101, 200, seed=3, device='cuda'))
    args[2], args[4] = args[2].float(), args[4].float()
    up = [a.double() for a in args]
    got = prd.prd_scatter_rho(*args)
    ref = prd.prd_scatter_cuda(*up)
    assert got.dtype == torch.float64 and torch.equal(got, ref)


def _raising_cases(device):
    """(name, arguments) the wrapper must refuse, on ``device``."""
    args = line(21, 40, seed=1, device=device)
    bad = {'float32 qWave': (args[0].float(),) + args[1:],
           'float32 J': args[:2] + (args[2].float(),) + args[3:],
           'non-contiguous J': args[:2] + (args[2].T.contiguous().T,)
           + args[3:],
           'J of the wrong shape': args[:2] + (args[2][:20],) + args[3:],
           'aDamp of the wrong shape': (args[0], args[1][:-1]) + args[2:],
           'qWave of one dimension': (args[0][0],) + args[1:],
           'Jbar on the meta device': args[:4] + (
               torch.empty_like(args[4], device='meta'),)}
    if device == 'cpu':
        bad['CPU tensors'] = args
    return bad


@pytest.mark.parametrize('device', ['cpu', 'cuda'])
def test_wrapper_refuses(device):
    """TypeError on a dtype other than float64, ValueError on a shape, a
    tensor that is not contiguous, one on another device, and CPU
    tensors; nothing launched."""
    if device == 'cuda' and not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    n0 = prd.prd_scatter_cuda.launches
    for name, args in _raising_cases(device).items():
        with pytest.raises((TypeError, ValueError)):
            prd.prd_scatter_cuda(*args)
        assert prd.prd_scatter_cuda.launches == n0, name


def _no_build(*args, **kwargs):
    raise AssertionError('a CPU tensor reached the CUDA kernel')


def test_cpu_never_loads_the_kernel(monkeypatch):
    """prd_scatter_rho on CPU tensors is the plain version, bit for bit,
    and builds or loads no library."""
    monkeypatch.setattr(_build, 'load', _no_build)
    args = line(51, 30, seed=2)
    n0 = prd.prd_scatter_cuda.launches
    got = prd.prd_scatter_rho(*args)
    assert torch.equal(got, prd.prd_scatter_rho_plain(*args))
    assert prd.prd_scatter_cuda.launches == n0


def test_cpu_context_prd_never_loads_the_kernel(monkeypatch):
    """A CPU Context's prd_redistribute (H 6, Ly-alpha and Ly-beta in
    PRD) runs without the library and moves rho."""
    monkeypatch.setattr(_build, 'load', _no_build)
    atmos = falc_interpolated(20)
    atmos.quadrature(3)
    rs = RadiativeSet([H_6_atom()])
    rs.set_active('H')
    ctx = Context(atmos, rs.compute_wavelength_grid(),
                  rs.compute_eq_pops(atmos), device='cpu')
    ctx.formal_sol_gamma_matrices()
    ctx.stat_equil()
    n0 = prd.prd_scatter_cuda.launches
    ctx.prd_redistribute(maxIter=1)
    rho = [ctx.rhoPrd[ai][ti] for ai, ti, a, t in ctx._prd_lines()]
    assert len(rho) == 2
    assert all(torch.isfinite(r).all() and (r != 1.0).any() for r in rho)
    assert prd.prd_scatter_cuda.launches == n0


def test_interp_single_row():
    """A window of one row: interp gives its value everywhere (jnp.interp's
    rule, its i - 1 wrapping to the row itself)."""
    xp = torch.tensor([[0.3], [-1.0]], dtype=torch.float64)
    fp = torch.tensor([[2.5], [7.0]], dtype=torch.float64)
    x = torch.tensor([-5.0, 0.3, 0.30000001, 9.0], dtype=torch.float64)
    got = prd.interp(x, xp, fp)
    assert torch.equal(got, fp.expand(2, 4))
