"""The port's 2D short-characteristics solver (ops/formal_solver2d.py,
ops/stokes2d.py) against the JAX package's, and the physics oracles of
tests/test_formal_solver2d.py.

- build_geometry_2d: the port vectorises the JAX package's double loop
  with the same IEEE operations per element, so every array is equal bit
  for bit; the x-reversed frame in which the port sweeps rays with
  mux < 0 (flip_geometry) equals the geometry built on the reversed grid.
- The ring solves: the port scans the affine maps with a log-step
  (Hillis-Steele) scan, JAX with associative_scan, which associate in
  another order: 1e-12 relative, not bit for bit.
- formal_sol_2d: with the port's elementary exp replaced by XLA's (the
  only function whose last ulps differ between the two), I, Psi and
  IeffBase agree within 1e-12 of each output's maximum (4e-14 measured:
  what remains is the scan order); with torch's own exp within 1e-11 of
  the maximum, the bar of the 1D solvers (tests/test_torch_solvers.py),
  since the ulp differences of exp(-dtau) are carried along the planes
  and through the ring closure 1 / (1 - A_tot).
- One plane loop per direction: sweep_rays_2d of a group of rays with
  both signs of mux, periodic and fixed x columns and a vertical ray is
  each ray's formal_sol_2d bit for bit.
- Stokes: formal_sol_stokes_2d within 1e-12 of Stokes I's maximum
  (9e-14 measured).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightweaver_tpu.ops import formal_solver2d as jfs2d
from lightweaver_tpu.ops import stokes2d as jst2d
from lightweaver_tpu_torch.ops import formal_solver2d as fs2d
from lightweaver_tpu_torch.ops import stokes2d as st2d
from lightweaver_tpu_torch.ops.formal_solver import formal_sol_1d

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def _grid(Nz=12, Nx=10, seed=0):
    """A non-uniform x grid and decreasing heights."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 4e5, Nx))
    z = np.sort(rng.uniform(0.0, 2e6, Nz))[::-1].copy()
    return x, z


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return np.abs(ours - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize('periodic', [True, False], ids=['periodic', 'fixed'])
@pytest.mark.parametrize('toObs', [True, False], ids=['up', 'down'])
@pytest.mark.parametrize('mux', [0.7, -0.7, 0.05, 0.0])
def test_geometry_matches_jax(mux, toObs, periodic):
    x, z = _grid()
    muz = 0.4 if toObs else -0.4
    sgn = 1.0 if toObs else -1.0
    ref = jfs2d.build_geometry_2d(x, z, sgn * mux, muz, toObs, periodic)
    ours = fs2d.build_geometry_2d(x, z, sgn * mux, muz, toObs, periodic)
    assert set(ours) == set(ref)
    for key in ref:
        a, b = np.asarray(ours[key]), np.asarray(ref[key])
        assert a.dtype == b.dtype and np.array_equal(a, b), key


@pytest.mark.parametrize('periodic', [True, False], ids=['periodic', 'fixed'])
@pytest.mark.parametrize('toObs', [True, False], ids=['up', 'down'])
@pytest.mark.parametrize('mux', [-0.7, -0.05])
def test_flipped_frame_is_the_reversed_geometry(mux, toObs, periodic):
    """A ray with mux < 0 swept in the x-reversed frame: flip_geometry of
    its geometry is build_geometry_2d on the grid -x[::-1] with |mux|."""
    x, z = _grid()
    muz = 0.4 if toObs else -0.4
    g = fs2d.build_geometry_2d(x, z, mux, muz, toObs, periodic)
    assert g['dj'] == -1
    flipped = fs2d.flip_geometry(g)
    ref = fs2d.build_geometry_2d(-x[::-1], z, -mux, muz, toObs, periodic)
    for key in ref:
        assert np.array_equal(np.asarray(flipped[key]),
                              np.asarray(ref[key])), key


@pytest.mark.parametrize('N', [2, 7, 8, 33])
def test_ring_affine_solve_matches_jax(N):
    """The scalar ring (A in [0, 0.99)) and the 4x4 one, 1e-12 relative
    (pointwise for the scalar ring, of the maximum for the matrix one)."""
    rng = np.random.default_rng(N)
    A = rng.uniform(0.0, 0.99, (3, N))
    b = rng.normal(size=(3, N))
    ref = np.asarray(jfs2d._ring_affine_solve(jnp.asarray(A),
                                              jnp.asarray(b)))
    ours = fs2d._ring_affine_solve(torch.tensor(A), torch.tensor(b)).numpy()
    assert (np.abs(ours - ref) / np.abs(ref)).max() < 1e-12
    A4 = rng.uniform(-0.3, 0.3, (3, N, 4, 4))
    b4 = rng.normal(size=(3, N, 4))
    ref = np.asarray(jst2d._ring_affine_solve_mat(jnp.asarray(A4),
                                                  jnp.asarray(b4)))
    ours = st2d._ring_affine_solve_mat(torch.tensor(A4),
                                       torch.tensor(b4)).numpy()
    assert _rel(ours, ref) < 1e-12


def _random_slab(B=3, Nz=12, Nx=10, seed=3):
    rng = np.random.default_rng(seed)
    chi = 10 ** rng.uniform(-8, -5, (B, Nz, Nx))
    S = 10 ** rng.uniform(-2, 2, (B, Nz, Nx))
    return chi, S, rng.uniform(0, 1, (B, Nx)), rng.uniform(0, 1, (B, Nz))


def _solve_both(x, z, mux, toObs, interp, alongRay, periodic):
    """formal_sol_2d of the JAX package and of the port on the same random
    slab, (I, Psi, IeffBase) as numpy pairs."""
    chi, S, Iupw, Ibc = _random_slab(Nz=len(z), Nx=len(x))
    muz = 0.4 if toObs else -0.4
    g = fs2d.build_geometry_2d(x, z, mux, muz, toObs, periodic)
    kw = dict(interp=interp, periodic=periodic, alongRay=alongRay)
    ref = jfs2d.formal_sol_2d(jnp.asarray(chi), jnp.asarray(S), g,
                              jnp.asarray(Iupw),
                              Ibc=None if periodic else jnp.asarray(Ibc),
                              **kw)
    ours = fs2d.formal_sol_2d(torch.tensor(chi), torch.tensor(S), g,
                              torch.tensor(Iupw),
                              Ibc=None if periodic else torch.tensor(Ibc),
                              **kw)
    return [(np.asarray(o), np.asarray(r)) for o, r in zip(ours, ref)]


@pytest.mark.parametrize('sign', [1.0, -1.0], ids=['mux+', 'mux-'])
@pytest.mark.parametrize('periodic', [True, False],
                         ids=['periodic', 'callable'])
@pytest.mark.parametrize('alongRay', ['linear', 'besser'])
@pytest.mark.parametrize('interp', ['linear', 'besser'])
def test_formal_sol_2d_matches_jax(monkeypatch, interp, alongRay, periodic,
                                   sign):
    """Both sweep directions of a ray on random chi (three decades) and S
    (four): 1e-12 of each output's maximum with XLA's exp in the port,
    1e-11 with torch's (module docstring)."""
    x, z = _grid()
    cases = [(sign * 0.7, True), (sign * 0.6, False)]
    for mux, toObs in cases:
        for ours, ref in _solve_both(x, z, mux, toObs, interp, alongRay,
                                     periodic):
            assert _rel(ours, ref) < 1e-11
    monkeypatch.setattr(torch, 'exp', lambda t: torch.as_tensor(
        np.array(jnp.exp(jnp.asarray(t.numpy()))), dtype=t.dtype))
    for mux, toObs in cases:
        for ours, ref in _solve_both(x, z, mux, toObs, interp, alongRay,
                                     periodic):
            assert _rel(ours, ref) < 1e-12


def test_group_of_rays_is_each_ray_alone():
    """sweep_rays_2d over six rays of one direction (mux of both signs,
    one vertical; callable x columns except the vertical ray, which is
    never fixed) is each ray's own formal_sol_2d, bit for bit, under both
    interpolations and both along-ray schemes."""
    x, z = _grid(Nz=10, Nx=8)
    muxs = [0.7, -0.7, 0.3, -0.05, 0.0, 0.9]
    muzs = [0.5, 0.5, 0.9, 0.95, 1.0, 0.3]
    rng = np.random.default_rng(11)
    NL, R, Nz, Nx = 2, len(muxs), len(z), len(x)
    chi = torch.tensor(10 ** rng.uniform(-8, -5, (NL, R, Nz, Nx)))
    S = torch.tensor(10 ** rng.uniform(-2, 2, (NL, R, Nz, Nx)))
    Iupw = torch.tensor(rng.uniform(0, 1, (NL, R, Nx)))
    Ibc = torch.tensor(rng.uniform(0, 1, (NL, R, Nz)))
    geoms = [fs2d.build_geometry_2d(x, z, m, u, True, periodic=False)
             for m, u in zip(muxs, muzs)]
    periodic = [m == 0.0 for m in muxs]
    group = fs2d.ray_group(geoms, periodic, chi.device, chi.dtype)
    for interp in ('linear', 'besser'):
        for alongRay in ('linear', 'besser'):
            outs = fs2d.sweep_rays_2d(chi, group, Iupw, S=S, Ibc=Ibc,
                                      interp=interp, alongRay=alongRay)
            for r in range(R):
                ref = fs2d.formal_sol_2d(
                    chi[:, r], S[:, r], geoms[r], Iupw[:, r],
                    interp=interp, periodic=periodic[r],
                    Ibc=None if periodic[r] else Ibc[:, r],
                    alongRay=alongRay)
                for o, e in zip(outs, ref):
                    assert torch.equal(o[:, r], e), (interp, alongRay, r)


def _const(shape, value):
    return torch.full(shape, value, dtype=torch.float64)


def _uniform_grid(Nz=40, Nx=16, Lx=1e6):
    return (np.linspace(0.0, Lx, Nx, endpoint=False),
            np.linspace(2e6, 0.0, Nz))


def test_x_uniform_matches_1d():
    """An x-uniform slab with shallow rays (every upwind point on a
    z-plane) is the 1D linear solver's column (1e-12)."""
    x, z = _uniform_grid()
    Nz, Nx = len(z), len(x)
    rng = np.random.default_rng(1)
    chi1 = 10.0 ** rng.uniform(-7.0, -5.0, Nz)
    S1 = 10.0 ** rng.uniform(-9.0, -8.0, Nz)
    chi = torch.tensor(np.broadcast_to(chi1[None, :, None], (1, Nz, Nx)))
    S = torch.tensor(np.broadcast_to(S1[None, :, None], (1, Nz, Nx)))
    muz, mux = 0.9, 0.05
    geom = fs2d.build_geometry_2d(x, z, mux, muz, toObs=True)
    assert not geom['axisZ'].any()
    I2, Psi2, _ = fs2d.formal_sol_2d(chi, S, geom, torch.zeros((1, Nx)))
    I1, Psi1, _ = formal_sol_1d(torch.tensor(chi1)[None],
                                torch.tensor(S1)[None], torch.tensor(z),
                                torch.tensor([muz], dtype=torch.float64),
                                torch.zeros(1, dtype=torch.float64),
                                to_obs=True, method='piecewise_linear_1d')
    for j in range(Nx):
        np.testing.assert_allclose(I2[0, :, j], I1[0], rtol=1e-12)
        np.testing.assert_allclose(Psi2[0, :, j], Psi1[0], rtol=1e-12)


def _constant_slab(mux, muz, chi0, S0, I0, interp='linear'):
    """I [Nz, Nx] of the up sweep through a slab of constant chi0 and S0
    from I0 at the bottom, and the analytic S0 + (I0 - S0) exp(-tau)
    [Nz]; whether some upwind point lies on an x side face."""
    x, z = _uniform_grid(Nz=30, Nx=12)
    Nz, Nx = len(z), len(x)
    geom = fs2d.build_geometry_2d(x, z, mux, muz, toObs=True)
    I, _, _ = fs2d.formal_sol_2d(_const((1, Nz, Nx), chi0),
                                 _const((1, Nz, Nx), S0), geom,
                                 _const((1, Nx), I0), interp=interp)
    tau = chi0 * np.abs(z - z[-1]) / abs(muz)
    return I[0].numpy(), S0 + (I0 - S0) * np.exp(-tau), geom['axisZ'].any()


@pytest.mark.parametrize('mux,muz', [(0.05, 0.9), (0.7, 0.3), (-0.7, 0.3),
                                     (0.95, 0.2)])
def test_constant_slab_analytic(mux, muz):
    """Constant chi and S, for any mux.  From I0 = S the solution is S at
    every point to 1e-13: the cyclic in-plane solve's closure keeps the
    fixed point.  From I0 != S it is S + (I0 - S) exp(-tau): to 1e-12
    where every upwind point lies on a z-plane (x-uniform, so the
    interpolation along x is exact); where rays hit the x side faces the
    intensity is interpolated linearly along the upwind column, a
    truncation error O(dtau^2), within 1e-3 on an optically thin slab
    (7.5e-4 measured; 0.16 at the JAX test's chi = 3e-6, whose np.allclose
    passes on its default atol of 1e-8, above these intensities)."""
    I, _, _ = _constant_slab(mux, muz, 3e-6, 2e-9, 2e-9)
    np.testing.assert_allclose(I, 2e-9, rtol=1e-13)
    I, expected, side = _constant_slab(mux, muz, 3e-8, 2e-9, 7e-9)
    rel = np.abs(I / expected[:, None] - 1.0).max()
    assert rel < (1e-3 if side else 1e-12), (side, rel)


@pytest.mark.parametrize('mux,muz', [(0.6, 0.4), (-0.6, 0.4)])
def test_besser_constant_slab_exact(mux, muz):
    """BESSER upwind interpolation of constant chi, S and I is exact: from
    I0 = S the solution is S to 1e-13.  From I0 != S (optically thin), the
    analytic solution within 2e-3 (6.5e-4 measured: the monotonic
    quadratic through the upwind column's three planes, with its control
    point frozen at the linear pass, is not more accurate than linear
    here)."""
    I, _, _ = _constant_slab(mux, muz, 3e-6, 2e-9, 2e-9, 'besser')
    np.testing.assert_allclose(I, 2e-9, rtol=1e-13)
    I, expected, side = _constant_slab(mux, muz, 3e-8, 2e-9, 7e-9, 'besser')
    assert side
    assert np.abs(I / expected[:, None] - 1.0).max() < 2e-3


def test_downward_sweep():
    """toObs=False sweeps top to bottom from a zero upper boundary."""
    x, z = _uniform_grid(Nz=30, Nx=8)
    Nz, Nx = len(z), len(x)
    chi0, S0 = 3e-6, 2e-9
    geom = fs2d.build_geometry_2d(x, z, -0.5, -0.6, toObs=False)
    I, _, _ = fs2d.formal_sol_2d(_const((1, Nz, Nx), chi0),
                                 _const((1, Nz, Nx), S0), geom,
                                 torch.zeros((1, Nx), dtype=torch.float64))
    tau = chi0 * np.abs(z - z[0]) / 0.6
    np.testing.assert_allclose(I[0, :, 3], S0 * (1.0 - np.exp(-tau)),
                               rtol=1e-10)


def test_periodic_translation_invariance():
    """Rolling the atmosphere in x rolls the solution (1e-8)."""
    x, z = _uniform_grid(Nz=25, Nx=16)
    Nz, Nx = len(z), len(x)
    rng = np.random.default_rng(3)
    chi = 10.0 ** rng.uniform(-7.0, -5.0, (1, Nz, Nx))
    S = 10.0 ** rng.uniform(-10.0, -8.0, (1, Nz, Nx))
    geom = fs2d.build_geometry_2d(x, z, 0.8, 0.4, toObs=True)
    Iupw = torch.zeros((1, Nx), dtype=torch.float64)
    I, _, _ = fs2d.formal_sol_2d(torch.tensor(chi), torch.tensor(S), geom,
                                 Iupw)
    Ishift, _, _ = fs2d.formal_sol_2d(torch.tensor(np.roll(chi, 5, axis=2)),
                                      torch.tensor(np.roll(S, 5, axis=2)),
                                      geom, Iupw)
    np.testing.assert_allclose(Ishift, np.roll(I.numpy(), 5, axis=2),
                               rtol=1e-8)


@pytest.mark.parametrize('periodic', [True, False],
                         ids=['periodic', 'callable'])
@pytest.mark.parametrize('mux', [0.7, -0.7, 0.0])
def test_formal_sol_stokes_2d_matches_jax(mux, periodic):
    """The DELO-linear Stokes plane sweep on random chi7 (|chi_QUV|,
    |rho_QUV| <= 0.3 chi_I) and S4: each Stokes component within 1e-12
    of Stokes I's maximum."""
    rng = np.random.default_rng(5)
    B, Nz, Nx = 2, 12, 8
    x, z = np.arange(Nx) * 4e4, np.linspace(2e6, 0.0, Nz)
    chiI = 10 ** rng.uniform(-8, -6, (B, Nz, Nx, 1))
    chi7 = chiI * np.concatenate(
        [np.ones((B, Nz, Nx, 1)), rng.uniform(-0.3, 0.3, (B, Nz, Nx, 6))],
        axis=-1)
    S4 = 10 ** rng.uniform(-2, 0, (B, Nz, Nx, 1)) * np.concatenate(
        [np.ones((B, Nz, Nx, 1)), rng.uniform(-0.1, 0.1, (B, Nz, Nx, 3))],
        axis=-1)
    Iupw = rng.uniform(0, 1, (B, Nx, 4))
    Ibc = rng.uniform(0, 1, (B, Nz))
    g = fs2d.build_geometry_2d(x, z, mux, 0.5, True, periodic)
    ref = np.asarray(jst2d.formal_sol_stokes_2d(
        jnp.asarray(chi7), jnp.asarray(S4), g, jnp.asarray(Iupw),
        periodic=periodic, Ibc=None if periodic else jnp.asarray(Ibc)))
    ours = st2d.formal_sol_stokes_2d(
        torch.tensor(chi7), torch.tensor(S4), g, torch.tensor(Iupw),
        periodic=periodic,
        Ibc=None if periodic else torch.tensor(Ibc)).numpy()
    amp = np.abs(ref[..., 0]).max()
    for c in range(4):
        assert np.abs(ours[..., c] - ref[..., c]).max() / amp < 1e-12, c


_NO_JAX_2D = """
import sys
from lightweaver_tpu_torch.problems import magnetise, slab_2d
ctx = slab_2d(12, 4, periodic=False, device='cpu',
              formalSolver='piecewise_besser_2d',
              interpFn2d='interp_besser_2d')
ctx.formal_sol_gamma_matrices()
ctx.stat_equil()
magnetise(ctx.atmos)
ctx.single_stokes_fs()
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))
             or m == 'lightweaver_tpu' or m.startswith('lightweaver_tpu.'))
print('LOADED', bad)
"""


def test_2d_path_runs_without_jax():
    """A fresh interpreter runs a 2D MALI step and the 2D Stokes
    synthesis of the port without loading jax or the JAX package."""
    env = dict(os.environ, OMP_NUM_THREADS='1')
    res = subprocess.run([sys.executable, '-c', _NO_JAX_2D],
                         cwd=Path(__file__).resolve().parent.parent, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert 'LOADED []' in res.stdout, res.stdout
