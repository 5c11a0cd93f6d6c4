"""Spectrum synthesis on the port's 2D Context against the JAX package's:
compute_rays, the state dict and pickling, and full-Stokes synthesis
(ops/stokes2d.py through single_stokes_fs).

A 12 x 4 slab (problems.slab_2d_atmos: FAL-C at 12 depths, the golden
problem's +-5% temperature perturbation and 1 km/s x flow) with the
callable HalfPlanck x boundaries, Ca II active.  Both Contexts take
three MALI steps; the port then takes the JAX state (J, populations), so
that the synthesis of each package starts from the same numbers.

- compute_rays(mus=[0.7, 1.0]): [Nlam, 2, Nx], within 1e-10 of each
  wavelength's maximum.
- single_stokes_fs in a uniform 0.1 T field (problems.magnetise): I and
  Q, U, V within 1e-10 of Stokes I's maximum at each wavelength
  (amplitude-normalised, as the golden Stokes test normalises them), and
  each within 1e-10 of its own maximum (4e-12 measured; the field
  polarises the slab's spectrum to ~1e-6 of I); the polarised profiles
  within 1e-12.  Without a field the Stokes I of the
  DELO-linear plane sweep is the scalar linear 2D solution (1e-10) and
  Q = U = V = 0, the port analogue of tests/test_stokes_2d.py:59.  updateJ
  and J20 raise on 2D, as in the JAX package.
- The state dict's kwargs carry the 2D solver and interpolation; a
  pickled 2D Context resumes bit for bit.
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from lightweaver_tpu_torch.problems import magnetise, slab_2d_atmos

from tests.test_torch_2d_context import (jax_atmos, jax_context,
                                         port_context, row_err)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'scripts',
                                'refgold'))
import export_inputs  # noqa: E402

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)

NZ, NX = 12, 4


def _pair(field=False, **kw):
    """(JAX Context, port Context) on the 12 x 4 slab with callable x
    boundaries after three MALI steps, the port holding the JAX state."""
    atmos = slab_2d_atmos(NZ, NX, periodic=False)
    if field:
        magnetise(atmos)
    jbcs = (export_inputs.HalfPlanckXBc(0),
            export_inputs.HalfPlanckXBc(NX - 1))
    jctx = jax_context(jax_atmos(atmos, xBc=jbcs),
                       formalSolver='piecewise_linear_2d', **kw)
    tctx = port_context(atmos, formalSolver='piecewise_linear_2d', **kw)
    for it in range(3):
        jctx.formal_sol_gamma_matrices()
        jctx.stat_equil()
    tctx.J = torch.tensor(np.asarray(jctx.J))
    tctx.popsState[0]['n'] = torch.tensor(np.asarray(
        jctx.popsState[0]['n']))
    return jctx, tctx


@pytest.fixture(scope='module')
def pair():
    return _pair()


@pytest.fixture(scope='module')
def field_pair():
    return _pair(field=True)


def test_compute_rays_matches_jax(pair):
    jctx, tctx = pair
    ref = np.asarray(jctx.compute_rays(mus=[0.7, 1.0]))
    ours = tctx.compute_rays(mus=[0.7, 1.0])
    assert isinstance(ours, np.ndarray) and ours.shape == ref.shape
    assert ours.shape == (tctx.cfg.Nlam, 2, NX)
    assert row_err(ours, ref) < 1e-10


def test_single_stokes_fs_matches_jax(field_pair):
    jctx, tctx = field_pair
    jctx.compute_polarised_profiles()
    tctx.compute_polarised_profiles()
    for ai, row in enumerate(jctx.phi7):
        for ti, p7 in enumerate(row):
            if p7 is None:
                assert tctx.phi7[ai][ti] is None
                continue
            for key, ref in p7.items():
                ours = tctx.phi7[ai][ti][key].numpy()
                ref = np.asarray(ref)
                assert np.abs(ours - ref).max() <= 1e-12 * np.abs(ref).max()
    jctx.single_stokes_fs()
    tctx.single_stokes_fs()
    Ij, Qj = np.asarray(jctx.I), np.asarray(jctx.Quv)
    It, Qt = tctx.I.numpy(), tctx.Quv.numpy()
    assert It.shape == Ij.shape == (tctx.cfg.Nlam, tctx.cfg.Nmu, NX)
    assert Qt.shape == Qj.shape == (3,) + Ij.shape
    amp = np.abs(Ij).reshape(len(Ij), -1).max(axis=1)
    assert np.abs(Qj).max() > 1e-8 * np.abs(Ij).max()
    for ours, ref in [(It, Ij)] + [(Qt[c], Qj[c]) for c in range(3)]:
        err = np.abs(ours - ref).reshape(len(ref), -1).max(axis=1) / amp
        assert err.max() < 1e-10
        assert np.abs(ours - ref).max() < 1e-10 * np.abs(ref).max()


def test_stokes_without_field_is_the_scalar_solution(pair):
    """No field: the Stokes plane sweep's I is the scalar linear 2D
    formal solution on the same J (1e-10), and Q = U = V = 0; updateJ and
    J20 raise on a 2D atmosphere."""
    _, tctx = pair
    Jsave = tctx.J.clone()
    tctx.formal_sol_gamma_matrices()
    Iscalar = tctx.I.clone()
    tctx.J = Jsave
    tctx.single_stokes_fs(recompute=True)
    assert row_err(tctx.I, Iscalar.numpy()) < 1e-10
    assert torch.all(tctx.Quv == 0.0)
    for kw in ({'updateJ': True}, {'J20': True}):
        with pytest.raises(ValueError, match='2D Stokes synthesis'):
            tctx.single_stokes_fs(**kw)


def test_state_dict_and_pickle_keep_the_2d_schemes():
    """The kwargs of a 2D Context's state dict name its 2D solver and
    interpolation; pickling goes through them, and the resumed Context
    takes its next two MALI steps bit for bit as the original."""
    atmos = slab_2d_atmos(NZ, NX, periodic=True)
    ctx = port_context(atmos, formalSolver='piecewise_besser_2d',
                       interpFn2d='interp_besser_2d')
    for it in range(3):
        ctx.formal_sol_gamma_matrices()
        ctx.stat_equil()
    kw = ctx.state_dict()['kwargs']
    assert kw['formalSolver'] == 'piecewise_besser_2d'
    assert kw['interpFn2d'] == 'interp_besser_2d'
    resumed = pickle.loads(pickle.dumps(ctx))
    assert resumed.cfg.Ndim == 2
    assert resumed.cfg.formalSolver == 'piecewise_besser_2d'
    assert resumed.cfg.interpFn2d == 'interp_besser_2d'
    assert torch.equal(resumed.I, ctx.I)
    for c in (ctx, resumed):
        for it in range(2):
            c.formal_sol_gamma_matrices()
            c.stat_equil()
    assert torch.equal(resumed.J, ctx.J)
    assert torch.equal(resumed.popsState[0]['n'], ctx.popsState[0]['n'])
