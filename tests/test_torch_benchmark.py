"""benchmark, the IterationScheme rc key and the GammaAccum repair of the
port's config (no jax).

benchmark runs on a 20-depth FALC problem on the CPU (_build_ctx is
monkeypatched; the kernel schemes race their plain versions here), writes
its winners to a lightweaverrc under a temporary XDG_CONFIG_HOME and
working directory, and a fresh ConfigDict, and a fresh interpreter's
import of the port, load it back; a Context built then takes the written
precision and scheme.  The JAX package's config refuses its own
GammaAccum key, which its benchmark writes; the port's takes it.
"""
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lightweaver_tpu_torch as tlw
import lightweaver_tpu_torch.config as tconfig
from lightweaver_tpu_torch.atomic_set import RadiativeSet
from lightweaver_tpu_torch.context import Context
from lightweaver_tpu_torch.problems import falc_decimated, h6ca_context
from lightweaver_tpu_torch.rh_atoms import H_6_atom

# the module: the package's ``benchmark`` is the function, as in the JAX
# package
tbench = importlib.import_module('lightweaver_tpu_torch.benchmark')
ROOT = Path(__file__).resolve().parent.parent
PALLAS = 'mali_full_precond_pallas'
FUSED = 'mali_full_precond_fused'

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


@pytest.fixture
def rc_home(tmp_path, monkeypatch):
    """A temporary XDG_CONFIG_HOME and working directory, with no
    lightweaverrc, and a fresh config.params the test may change."""
    monkeypatch.setenv('XDG_CONFIG_HOME', str(tmp_path))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tconfig, 'params', tconfig.ConfigDict())
    return tmp_path


def small_ctx(scheme=None, **kwargs):
    return h6ca_context(falc_decimated(20), 2, device='cpu',
                        fsIterScheme=scheme, **kwargs)


def test_benchmark_writes_a_config_the_next_import_loads(rc_home,
                                                         monkeypatch):
    built = []
    real = tbench._build_ctx

    def build(dtype=None, recurrenceMode='scan', device='cuda', **kw):
        ctx = real(Nspace=20, Nrays=2, dtype=dtype,
                   recurrenceMode=recurrenceMode, device='cpu')
        built.append(ctx)
        return ctx
    monkeypatch.setattr(tbench, '_build_ctx', build)
    # an rc scheme must not leak into the variants the race builds
    tconfig.params['IterationScheme'] = FUSED
    res = tlw.benchmark(Niter=1, writeConfig=True, verbose=False,
                        schemes=[PALLAS, FUSED], device='cpu')
    monkeypatch.setattr(tbench, '_build_ctx', real)

    assert set(res) == {'timings', 'best', 'accumTimings', 'bestAccum',
                        'schemeTimings', 'bestScheme'}
    assert set(res['timings']) == {('scan', 'f64'), ('scan', 'mixed')}
    assert set(res['schemeTimings']) == {'mali_full_precond', PALLAS, FUSED}
    assert all(t > 0 for t in res['timings'].values())
    mixed = res['best'][1] == 'mixed'
    assert set(res['accumTimings']) == ({'exact', 'blocked'} if mixed
                                       else {'exact'})
    # every Context of the race was built as it says
    assert [c.dtype for c in built[:2]] == [torch.float64, torch.float32]
    assert all(c.cfg.gammaAccum == 'exact' for c in built[:2])
    assert all(c.cfg.fsIterScheme == 'mali_full_precond' for c in built[:2])

    rc = rc_home / 'lightweaver_tpu' / 'lightweaverrc'
    assert rc.is_file()
    fresh = tconfig.ConfigDict()
    expect = {'RecurrenceMode': 'scan', 'Precision': res['best'][1],
              'GammaAccum': res['bestAccum'],
              'IterationScheme': res['bestScheme']}
    assert {k: fresh[k] for k in expect} == expect

    # the next import of the port, in a fresh interpreter
    env = dict(os.environ, XDG_CONFIG_HOME=str(rc_home),
               PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    out = subprocess.run(
        [sys.executable, '-c', 'import lightweaver_tpu_torch.config as c; '
         'print(sorted(c.params.items()))'], cwd=rc_home, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert str(sorted(fresh.items())) in out.stdout

    # a Context built now runs the written precision and scheme
    monkeypatch.setattr(tconfig, 'params', fresh)
    ctx = small_ctx()
    assert ctx.get_fs_iter_scheme_properties()['name'] == res['bestScheme']
    assert ctx.dtype == (torch.float32 if mixed else torch.float64)
    assert ctx.cfg.gammaAccum == res['bestAccum']
    ctx.formal_sol_gamma_matrices()
    assert torch.isfinite(ctx.J).all()


@pytest.mark.parametrize('scheme', [PALLAS, FUSED])
def test_rc_scheme_is_taken(rc_home, scheme):
    """lightweaverrc's IterationScheme selects the scheme of a Context
    built without fsIterScheme; an explicit fsIterScheme wins."""
    tconfig.params['IterationScheme'] = scheme
    assert small_ctx().cfg.fsIterScheme == scheme
    assert small_ctx('mali_full_precond').cfg.fsIterScheme == \
        'mali_full_precond'


def hprd_ctx(scheme=None):
    atmos = falc_decimated(12)
    atmos.vlos[:] = np.linspace(5e3, 0.0, atmos.Nspace)
    atmos.quadrature(2)
    rs = RadiativeSet([H_6_atom()])
    rs.set_active('H')
    return Context(atmos, rs.compute_wavelength_grid(),
                   rs.compute_eq_pops(atmos), hprd=True, device='cpu',
                   fsIterScheme=scheme)


@pytest.mark.parametrize('scheme', [PALLAS, FUSED])
def test_rc_scheme_the_configuration_refuses_leaves_the_default(rc_home,
                                                                scheme):
    """The kernel schemes do not take hybrid PRD: an rc scheme leaves the
    default (best-effort, as the JAX Context), an explicit one raises."""
    tconfig.params['IterationScheme'] = scheme
    ctx = hprd_ctx()
    assert ctx.cfg.hprd
    assert ctx.get_fs_iter_scheme_properties()['name'] == 'mali_full_precond'
    with pytest.raises(ValueError, match='does not support'):
        hprd_ctx(scheme)


def test_gamma_accum_key_round_trips(rc_home, monkeypatch):
    """GammaAccum is a key of the port's config: save() and a fresh load
    keep it, and the Context reads it."""
    tconfig.params['GammaAccum'] = 'blocked'
    tconfig.params['Precision'] = 'mixed'
    tconfig.params.save()
    fresh = tconfig.ConfigDict()
    assert fresh['GammaAccum'] == 'blocked'
    monkeypatch.setattr(tconfig, 'params', fresh)
    ctx = small_ctx()
    assert (ctx.dtype, ctx.cfg.gammaAccum) == (torch.float32, 'blocked')
