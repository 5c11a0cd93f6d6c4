"""The sweep and fused kernels over a batch of columns (the depth axis of
Ncol independent columns, parallel/columns.py's layout): the plain
versions against themselves column by column, the input checks, and on a
card the kernels against their plain versions and against their own
single-column launches.

No jax here, so the file also runs where only torch is installed; on a
machine with an NVIDIA GPU:

    python -m pytest tests/test_torch_columns_kernels.py --noconftest -q

Without a GPU the tests marked gpu skip.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from lightweaver_tpu_torch.ops import fused as tfused
from lightweaver_tpu_torch.ops import sweep as tsweep
from lightweaver_tpu_torch.problems import column_rays, column_slots

SOLVERS = ('piecewise_linear_1d', 'piecewise_bezier3_1d',
           'piecewise_besser_1d')
NAMES = ('I', 'Psi', 'IeffBase', 'J', 'PsiBar', 'IBar', 'IeffSrcBar')

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def _rays(C, NL, Nmu, Nk, seed=0, device='cpu', dtype=torch.float64):
    return {k: torch.tensor(v, dtype=dtype, device=device)
            for k, v in column_rays(C, NL, Nmu, Nk, seed).items()}


def _slots(C, S, NL, Nmu, Nk, bcs, seed=0, device='cpu',
           dtype=torch.float64):
    s = column_slots(C, S, NL, Nmu, Nk, seed)

    def t_(x):
        return torch.tensor(x, dtype=dtype, device=device)
    args = {k: t_(s[k]) for k in ('phiP', 'chiCo', 'etaCo', 'bgChi',
                                  'bgEta', 'scaJ', 'height', 'muz', 'wmu')}
    for name, kind in zip(('upper', 'lower'), bcs):
        args[name] = (kind, None if kind == 'zero' else t_(s[kind]))
    return args


def _column(args, c, Nk):
    """The single-column arguments of column c of a batch's arguments."""
    out = {}
    for k, v in args.items():
        if k in ('upper', 'lower'):
            kind, rows = v
            out[k] = (kind, None if rows is None else (
                rows[..., c] if kind == 'data' else rows[:, c]).contiguous())
        elif k == 'height':
            out[k] = v[c].contiguous()
        elif k in ('IupwD', 'IupwU'):
            out[k] = v[..., c].contiguous()
        elif k in ('muz', 'wmu'):
            out[k] = v
        else:
            out[k] = v[..., c * Nk:(c + 1) * Nk].contiguous()
    return out


def _outputs(out):
    return list(out[:3]) + [out[3][k] for k in NAMES[3:]]


def _slice(x, c, Nk):
    return x[..., c * Nk:(c + 1) * Nk]


@pytest.mark.parametrize('solver', SOLVERS)
def test_plain_sweep_over_columns_is_each_column_alone(solver):
    """The plain sweep over three columns of their own heights and
    boundaries equals, column by column and bit for bit, the plain sweep
    of that column alone (the batch adds rays, never mixes depths)."""
    C, Nk = 3, 20
    args = _rays(C, 6, 3, Nk, seed=3)
    out = _outputs(tsweep.formal_solve_sweep(**args, solver=solver))
    for c in range(C):
        one = _outputs(tsweep.formal_solve_sweep(**_column(args, c, Nk),
                                                 solver=solver))
        for name, a, b in zip(NAMES, out, one):
            assert torch.equal(_slice(a, c, Nk), b), (name, c)


@pytest.mark.parametrize('bcs', [('zero', 'therm'), ('therm', 'data'),
                                 ('data', 'zero')])
def test_plain_fused_over_columns_is_each_column_alone(bcs):
    """The plain fused step over three columns equals, column by column
    and bit for bit, that column alone, with each boundary kind."""
    C, Nk = 3, 20
    args = _slots(C, 2, 8, 3, Nk, bcs, seed=5)
    out = _outputs(tfused.fused_lambda_step(**args))
    for c in range(C):
        one = _outputs(tfused.fused_lambda_step(**_column(args, c, Nk)))
        for name, a, b in zip(NAMES, out, one):
            assert torch.equal(_slice(a, c, Nk), b), (name, c)


def test_column_inputs_are_checked():
    """Heights that do not split the depth axis, boundaries without the
    column axis, a column under 3 depths and a ray tensor past the
    kernels' 2^31 - 1 elements raise, naming what is wrong."""
    args = _rays(3, 4, 2, 10)
    with pytest.raises(ValueError, match='Ncol NkCol = 30'):
        tsweep.formal_solve_sweep(**{**args, 'height': args['height'][:2]})
    with pytest.raises(ValueError, match='IupwD'):
        tsweep.formal_solve_sweep(**{**args, 'IupwD': args['IupwD'][..., 0]})
    short = {**args, 'chi': args['chi'][..., :6],
             'srcNum': args['srcNum'][..., :6],
             'height': args['height'][:, :2]}
    with pytest.raises(ValueError, match='Nk >= 3 per column'):
        tsweep.formal_solve_sweep(**short)
    big = {k: torch.empty(v.shape[:-1] + (v.shape[-1] * 2 ** 24,)
                          if k in ('chi', 'srcNum') else v.shape,
                          device='meta') for k, v in args.items()}
    big['height'] = torch.empty((3 * 2 ** 24, 10), device='meta')
    big['IupwD'] = big['IupwU'] = torch.empty((4, 2, 3 * 2 ** 24),
                                              device='meta')
    with pytest.raises(ValueError, match='2147483647'):
        tsweep.formal_solve_sweep(**big)
    f = _slots(3, 2, 8, 2, 10, ('therm', 'data'))
    with pytest.raises(ValueError, match='upper must be'):
        tfused.fused_lambda_step(**{**f, 'upper': ('therm',
                                                   f['upper'][1][:, 0])})


_NO_JAX = """
import sys
from lightweaver_tpu_torch.parallel import ColumnBatch
from lightweaver_tpu_torch.problems import column_batch
b = column_batch(2, Nk=12, Nrays=2, activeSpecies=('Ca',), device='cpu')
b.formal_sol_gamma_matrices()
b.stat_equil()
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))
             or m == 'lightweaver_tpu' or m.startswith('lightweaver_tpu.'))
print('LOADED', bad)
"""


def test_column_batch_runs_without_jax():
    """A fresh interpreter builds a two-column batch on the CPU and takes
    a MALI step and stat_equil without loading jax or the JAX package
    (the machine with the card has no jax)."""
    env = dict(os.environ, OMP_NUM_THREADS='1')
    res = subprocess.run([sys.executable, '-c', _NO_JAX],
                         cwd=Path(__file__).resolve().parent.parent, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert 'LOADED []' in res.stdout, res.stdout


def _max_rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


COLUMNS = [1, 3, 64]


def _check_against_plain(kern, plain, tol):
    for name, a, b in zip(NAMES, _outputs(kern), _outputs(plain)):
        assert torch.isfinite(a).all(), name
        assert _max_rel(a, b) < tol, (name, _max_rel(a, b))


def _check_columns_bitwise(kern, args, Nk, call):
    """Each column of the batch launch equals its own single-column
    launch (height [Nk], boundaries without the column axis) bit for bit
    (first, middle and last column; at Ncol = 1 the column form against
    the plain form of the same column)."""
    C = args['height'].shape[0]
    out = _outputs(kern)
    for c in sorted({0, C // 2, C - 1}):
        one = _outputs(call(_column(args, c, Nk)))
        for name, a, b in zip(NAMES, out, one):
            assert torch.equal(_slice(a, c, Nk), b), (name, c)


@pytest.mark.gpu
@pytest.mark.parametrize('solver', SOLVERS)
@pytest.mark.parametrize('Ncol', COLUMNS)
def test_sweep_kernel_over_columns_matches_plain(Ncol, solver):
    """The sweep kernel's instance for each solver (float64) over Ncol
    columns of 82 depths in one launch (heights [Ncol, 82], Ncol = 1
    too): against the plain version within 1e-9 of each output's maximum
    (the single-column kernel's bar), and every column bit for bit its
    own single-column launch."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    Nk = 82
    args = _rays(Ncol, 200, 5, Nk, seed=Ncol, device='cuda')
    attr = tsweep.launch_attr(solver, torch.float64)
    before = getattr(tsweep.sweep_cuda, attr)
    kern = tsweep.formal_solve_sweep(**args, solver=solver)
    torch.cuda.synchronize()
    assert getattr(tsweep.sweep_cuda, attr) == before + 1
    plain = tsweep.formal_solve_sweep_plain(**args, solver=solver)
    _check_against_plain(kern, plain, 1e-9)
    _check_columns_bitwise(kern, args, Nk, lambda a: tsweep.formal_solve_sweep(
        **a, solver=solver))


@pytest.mark.gpu
@pytest.mark.parametrize('Ncol', COLUMNS)
def test_f32_sweep_kernel_over_columns_matches_plain(Ncol):
    """The float32 Bezier-3 instance over Ncol columns: each output
    within err(kernel f32, plain f64) <= 2 err(plain f32, plain f64) +
    1e-6 (the float32 rule), every column bit for bit its own launch."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    Nk = 82
    args = _rays(Ncol, 200, 5, Nk, seed=Ncol, device='cuda',
                 dtype=torch.float32)
    args64 = {k: v.double() for k, v in args.items()}
    kern = tsweep.formal_solve_sweep(**args)
    plain = tsweep.formal_solve_sweep_plain(**args)
    ref = tsweep.formal_solve_sweep_plain(**args64)
    for name, k, p, r in zip(NAMES, _outputs(kern), _outputs(plain),
                             _outputs(ref)):
        ek, ep = _max_rel(k.double(), r), _max_rel(p.double(), r)
        assert ek <= 2 * ep + 1e-6, (name, ek, ep)
    _check_columns_bitwise(kern, args, Nk, lambda a:
                           tsweep.formal_solve_sweep(**a))


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize('bcs', [('zero', 'therm'), ('therm', 'data'),
                                 ('data', 'zero')])
@pytest.mark.parametrize('Ncol', COLUMNS)
def test_fused_kernel_over_columns_matches_plain(Ncol, bcs, dtype):
    """The fused kernel over Ncol columns with each boundary kind at each
    end: float64 within 1e-9 of the plain version, float32 by the float32
    rule, every column bit for bit its own single-column launch."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    Nk = 82
    args = _slots(Ncol, 2, 200, 5, Nk, bcs, seed=Ncol, device='cuda',
                  dtype=dtype)
    attr = 'launches' if dtype == torch.float64 else 'launches_f32'
    before = getattr(tfused.fused_cuda, attr)
    kern = tfused.fused_lambda_step(**args)
    torch.cuda.synchronize()
    assert getattr(tfused.fused_cuda, attr) == before + 1
    plain = tfused.fused_lambda_step_plain(**args)
    if dtype == torch.float64:
        _check_against_plain(kern, plain, 1e-9)
    else:
        up = {k: ((v[0], None if v[1] is None else v[1].double())
                  if isinstance(v, tuple) else v.double())
              for k, v in args.items()}
        ref = tfused.fused_lambda_step_plain(**up)
        for name, k, p, r in zip(NAMES, _outputs(kern), _outputs(plain),
                                 _outputs(ref)):
            ek, ep = _max_rel(k.double(), r), _max_rel(p.double(), r)
            assert ek <= 2 * ep + 1e-6, (name, ek, ep)
    _check_columns_bitwise(kern, args, Nk, lambda a:
                           tfused.fused_lambda_step(**a))
