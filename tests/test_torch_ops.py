"""Leaf ops and the depth sweep of lightweaver_tpu_torch against the JAX
package, on the same numpy inputs made from a seed.

On the CPU the sweep runs its plain PyTorch version; the CUDA kernel is
compared with it on the card in tests/test_torch_kernels.py.  The kernel
sums the depth recurrence as a chunked warp scan; affine_solve's
'chunked' mode is its plain twin, held here to the sequential loop and to
the JAX package's parallel and blocked scans.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightweaver_tpu.ops import faddeeva as jfaddeeva
from lightweaver_tpu.ops.formal_solver import _affine_solve as j_affine_solve
from lightweaver_tpu.ops.formal_solver import formal_sol_1d as j_formal_sol_1d
from lightweaver_tpu.ops.linalg import solve_KxK_over_depth as j_solve
from lightweaver_tpu.ops.pallas_sweep import \
    formal_solve_sweep as j_formal_solve_sweep
from lightweaver_tpu.ops.planck import planck_nu as j_planck_nu
from lightweaver_tpu_torch.ops import sweep as tsweep
from lightweaver_tpu_torch.ops.faddeeva import voigt_H
from lightweaver_tpu_torch.ops.formal_solver import (_sweep_coeffs_bezier3,
                                                     affine_solve,
                                                     formal_sol_1d)
from lightweaver_tpu_torch.ops.linalg import solve_KxK_over_depth
from lightweaver_tpu_torch.ops.planck import planck_nu
from lightweaver_tpu_torch.problems import random_rays

T64 = torch.float64

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def _t(x):
    return torch.tensor(np.asarray(x), dtype=T64)


def _relmax(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    return (np.abs(ours - ref) / np.abs(ref)).max()


def test_planck_matches_jax():
    """Same formula, elementwise: 1e-12 relative (exp rounding)."""
    rng = np.random.default_rng(1)
    T = rng.uniform(3e3, 1e5, 64)[None, :]
    lam = np.geomspace(10.0, 1e5, 200)[:, None]
    ours = planck_nu(_t(T), _t(lam)).numpy()
    ref = np.asarray(j_planck_nu(jnp.asarray(T), jnp.asarray(lam)))
    mask = ref > 0
    assert np.array_equal(ours > 0, mask)
    assert _relmax(ours[mask], ref[mask]) < 1e-12


def _voigt_grid():
    a = np.geomspace(1e-5, 10.0, 40)[:, None]
    v = np.linspace(-500.0, 500.0, 2001)[None, :]
    return np.broadcast_arrays(a, v)


def test_voigt_matches_jax_formula():
    """The port evaluates the JAX Weideman formula op by op, so against
    the JAX formula evaluated op by op it agrees to 1e-12 relative (it is
    bitwise equal on this machine)."""
    A, V = _voigt_grid()
    ours = voigt_H(_t(A), _t(V)).numpy()
    ref = np.asarray(jfaddeeva._wofz_parts_impl(jnp.asarray(V),
                                                jnp.asarray(A))[0])
    assert _relmax(ours, ref) < 1e-12


def test_voigt_matches_jax_voigt_H():
    """Against the JAX voigt_H itself (jitted: XLA fuses the Horner steps):
    1e-12 of the peak of each damping row; pointwise 1e-9, the Weideman
    approximation's accuracy, reached only in the far wings where Re w is
    ~a/v of |w| (see test_torch_model_layer.py)."""
    A, V = _voigt_grid()
    ours = voigt_H(_t(A), _t(V)).numpy()
    ref = np.asarray(jfaddeeva.voigt_H(jnp.asarray(A), jnp.asarray(V)))
    amp = (np.abs(ours - ref).max(axis=1) / np.abs(ref).max(axis=1)).max()
    assert amp < 1e-12
    assert _relmax(ours, ref) < 1e-9


def _random_systems(rng, N=6, Nk=50):
    G = rng.uniform(-1.0, 1.0, (N, N, Nk))
    G += 4.0 * N * np.eye(N)[:, :, None] * rng.uniform(0.5, 2.0, (1, 1, Nk))
    # permute rows so partial pivoting has to swap
    G = G[rng.permutation(N)]
    rhs = rng.uniform(0.0, 1.0, (N, Nk))
    return G, rhs


def test_solve_matches_jax():
    """Same unrolled partial-pivot elimination on well-conditioned
    systems: 1e-12 relative (back-substitution dot order)."""
    G, rhs = _random_systems(np.random.default_rng(2))
    ours = solve_KxK_over_depth(_t(G), _t(rhs)).numpy()
    ref = np.asarray(j_solve(jnp.asarray(G), jnp.asarray(rhs)))
    assert _relmax(ours, ref) < 1e-12
    np.testing.assert_allclose(np.einsum('ijk,jk->ik', G, ours), rhs,
                               rtol=1e-12, atol=1e-12)


def test_solve_singular_is_non_finite():
    """A singular system gives non-finite values (the Context turns them
    into ExplodingMatrixError), as in the JAX package."""
    G = np.zeros((5, 5, 7))
    G[0] = 1.0
    rhs = np.ones((5, 7))
    ours = solve_KxK_over_depth(_t(G), _t(rhs)).numpy()
    ref = np.asarray(j_solve(jnp.asarray(G), jnp.asarray(rhs)))
    assert not np.all(np.isfinite(ours))
    assert not np.all(np.isfinite(ref))


@pytest.mark.parametrize('toObs', [False, True])
def test_formal_sol_1d_matches_jax_scan(toObs):
    """The port's sequential Bezier-3 solve against JAX formal_sol_1d in
    'scan' mode (the same recurrence order), on the rough random case of
    tests/test_pallas_sweep.py: 1e-11 of each quantity's maximum.  XLA's
    vectorised exp is not glibc's, and on this case a few ulps in the
    coefficients grow through the Steffen limiter and the recurrence:
    the port differs from jitted JAX by up to 6.5e-12, and jitted JAX
    from JAX run op by op by up to 6.8e-12."""
    c = random_rays(37, 3, 83)
    d = int(toObs)
    Nk = c['height'].size
    chi = c['chi'][d].reshape(-1, Nk)
    S = (c['srcNum'][d] / c['chi'][d]).reshape(-1, Nk)
    muzB = np.broadcast_to(c['muz'][None, :], c['chi'].shape[1:3]).reshape(-1)
    Iupw = (c['IupwU'] if toObs else c['IupwD']).reshape(-1)
    ours = formal_sol_1d(_t(chi), _t(S), _t(c['height']), _t(muzB), _t(Iupw),
                         to_obs=toObs)
    ref = j_formal_sol_1d(jnp.asarray(chi), jnp.asarray(S),
                          jnp.asarray(c['height']), jnp.asarray(muzB),
                          jnp.asarray(Iupw), to_obs=toObs,
                          method='piecewise_bezier3_1d', mode='scan')
    for name, a, b in zip(('I', 'Psi', 'IeffBase'), ours, ref):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert err < 1e-11, (name, err)


def test_sweep_plain_matches_jax_pallas_sweep():
    """The plain sweep (I, Psi, IeffBase and the four moments) against
    the JAX Pallas sweep kernel in interpret mode, at a small size.  The
    kernel's Kogge-Stone prefix reorders the b-accumulation along depth
    and it forms IeffSrcBar from psiN*S, so the bar is 1e-10 of each
    quantity's maximum."""
    c = random_rays(12, 3, 40, seed=3)
    ours = tsweep.formal_solve_sweep(**{k: _t(v) for k, v in c.items()})
    S = c['srcNum'] / c['chi']
    I, Psi, IeffB, mom = j_formal_solve_sweep(
        jnp.asarray(np.moveaxis(c['chi'], 0, 2)),
        jnp.asarray(np.moveaxis(S, 0, 2)), jnp.asarray(c['height']),
        jnp.asarray(c['muz']), jnp.asarray(c['IupwD']),
        jnp.asarray(c['IupwU']), wmu=c['wmu'])
    ref = [np.moveaxis(np.asarray(x), 2, 0) for x in (I, Psi, IeffB)]
    J = sum(np.asarray(mom[k][d]) for k in ('Jhi', 'Jlo') for d in (0, 1))
    refMoments = {'J': J, 'IBar': np.asarray(mom['IBar']),
                  'PsiBar': np.asarray(mom['PsiBar']),
                  'IeffSrcBar': np.asarray(mom['IeffSrcBar'])}
    for name, a, b in zip(('I', 'Psi', 'IeffBase'), ours[:3], ref):
        err = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert err < 1e-10, (name, err)
    for name, b in refMoments.items():
        a = ours[3][name].numpy()
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err < 1e-10, (name, err)


@pytest.mark.parametrize('toObs', [False, True])
@pytest.mark.parametrize('Nk', [3, 31, 32, 33, 82, 500])
def test_affine_solve_chunked_matches_sequential_and_jax(Nk, toObs):
    """The sweep kernel's recurrence order (32-wide Kogge-Stone chunks with
    a carry) against the sequential loop and the JAX package's
    _affine_solve in modes 'parallel' (associative_scan) and 'blocked'
    (two-level scan), on the Bezier-3 maps of random rays in either
    sweep direction: 1e-12 of the largest I, in float64."""
    c = random_rays(6, 2, Nk, seed=Nk)
    d = int(toObs)
    chi = _t(c['chi'][d].reshape(-1, Nk))
    S = _t((c['srcNum'][d] / c['chi'][d]).reshape(-1, Nk))
    h = _t(c['height'])
    muz = _t(np.broadcast_to(c['muz'][None, :], (6, 2)).reshape(-1))
    Iupw = _t((c['IupwU'] if toObs else c['IupwD']).reshape(-1))
    if toObs:
        chi, S, h = chi.flip(-1), S.flip(-1), h.flip(-1)
    ds = torch.abs(h[1:] - h[:-1])[None, :] / muz[:, None]
    A, b, _, _ = _sweep_coeffs_bezier3(chi, S, ds)
    b[..., 0] = Iupw
    seq = affine_solve(A, b, 'sequential').numpy()
    scale = np.abs(seq).max()
    refs = {'chunked': affine_solve(A, b, 'chunked').numpy()}
    for mode in ('parallel', 'blocked'):
        refs[mode] = np.asarray(j_affine_solve(jnp.asarray(A.numpy()),
                                               jnp.asarray(b.numpy()), mode))
    for mode, x in refs.items():
        err = np.abs(x - seq).max() / scale
        assert err < 1e-12, (mode, err)
    # the sweep start is the boundary value exactly
    assert np.array_equal(refs['chunked'][:, 0], Iupw.numpy())


def test_affine_solve_rejects_unknown_mode():
    with pytest.raises(ValueError, match='unknown recurrence mode'):
        affine_solve(torch.ones(1, 3), torch.ones(1, 3), 'tree')
