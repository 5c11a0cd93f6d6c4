"""The port's PRD operators (ops/prd.py) and its Ng copy (ops/ng.py)
against the JAX package, on seeded numpy inputs.

gII, the scattering range and the scattering integral agree with
lightweaver_tpu.ops.prd to 1e-12 of each output's maximum (the same
formulas; torch's and XLA's exp/sqrt and reduction orders differ in the
last ulps).  ``interp`` reproduces jnp.interp's formula to 1 ulp.  The
JAX package's own analytic oracles (tests/test_prd.py) are re-run on the
port, and the Ng copy matches the JAX Ng iterate for iterate.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightweaver_tpu.ops import ng as jng
from lightweaver_tpu.ops import prd as jprd
from lightweaver_tpu_torch.ops import ng as tng
from lightweaver_tpu_torch.ops import prd as tprd

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)

T = torch.as_tensor


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    return np.abs(ours - ref).max() / np.abs(ref).max()


def test_constants_match_jax():
    for name in ('PrdQWing', 'PrdQCore', 'PrdQSpread', 'PrdDQ', 'NFINE'):
        assert getattr(tprd, name) == getattr(jprd, name), name
    assert tprd.NFINE == 88


@pytest.mark.parametrize('seed', [0, 1])
def test_gII_matches_jax(seed):
    """Over emission frequencies on both sides of every branch (core,
    blend, wing, far wing) and absorption frequencies in and out of the
    integration range."""
    rng = np.random.default_rng(seed)
    a = 10 ** rng.uniform(-4, -1, (1, 1, 7))
    qE = rng.uniform(-12, 12, (40, 1, 1))
    qA = rng.uniform(-20, 20, (1, 50, 1))
    ours = tprd.gII(T(a), T(qE), T(qA))
    ref = jprd.gII(jnp.asarray(a), jnp.asarray(qE), jnp.asarray(qA))
    assert _rel(ours, ref) < 1e-12


def test_scattering_range_start_matches_jax():
    q = np.concatenate([np.linspace(-12, 12, 97), [-4.0, -2.0, 0.0, 2.0,
                                                   4.0]])
    for ours, ref in zip(tprd._scattering_range_start(T(q)),
                         jprd._scattering_range_start(jnp.asarray(q))):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize('W, Nk, seed', [(41, 6, 0), (120, 9, 1)])
def test_prd_scatter_rho_matches_jax(W, Nk, seed):
    """Seeded qWave (window grids stretched per depth), damping, J on the
    window and the rate prefactors: rho to 1e-12 of its maximum."""
    rng = np.random.default_rng(seed)
    q = np.sort(rng.uniform(-60, 60, W))
    qWave = q[:, None] * rng.uniform(0.7, 1.3, Nk)[None, :]
    aDamp = 10 ** rng.uniform(-3.5, -1, Nk)
    Jw = 10 ** rng.uniform(-9, -7, (W, Nk))
    gp = rng.uniform(0.5, 3.0, Nk)
    Jbar = 10 ** rng.uniform(-9, -7, Nk)
    args = (qWave, aDamp, Jw, gp, Jbar)
    ours = tprd.prd_scatter_rho(*map(T, args))
    ref = jprd.prd_scatter_rho(*map(jnp.asarray, args))
    assert ours.shape == (W, Nk)
    assert _rel(ours, ref) < 1e-12


def _ulps(ours, ref, fp):
    """|ours - ref| in ulps of the larger of |ref| and the values
    interpolated between (a result near 0 is the sum of larger terms)."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    return (np.abs(ours - ref)
            / np.spacing(np.maximum(np.abs(ref), np.abs(fp).max()))).max()


@pytest.mark.parametrize('case', ['nodes', 'ties', 'outside', 'random',
                                  'single'])
def test_interp_matches_jnp(case):
    """jnp.interp's formula, on the nodes, on repeated nodes (dx = 0),
    left of xp[0] and right of xp[-1], at random points, and on a single
    node (its value everywhere): equal to
    1 ulp (XLA contracts fp[i-1] + t df into an FMA, as the port does
    with addcmul; the two agree bit for bit here)."""
    rng = np.random.default_rng(3)
    xp = np.sort(rng.uniform(0.0, 1.0, 30))
    fp = rng.uniform(-1.0, 1.0, 30)
    if case == 'ties':
        xp[7] = xp[8] = xp[9]
        xp[20] = xp[21]
        x = np.concatenate([xp[5:12], xp[19:23], rng.uniform(xp[6], xp[10],
                                                            20)])
    elif case == 'nodes':
        x = xp.copy()
    elif case == 'outside':
        x = np.concatenate([xp[0] - rng.uniform(0, 1, 10),
                            xp[-1] + rng.uniform(1e-12, 1, 10),
                            [xp[0], xp[-1]]])
    elif case == 'single':
        xp, fp = xp[12:13], fp[12:13]
        x = np.concatenate([xp, rng.uniform(-0.2, 1.2, 20)])
    else:
        x = rng.uniform(-0.2, 1.2, 200)
    ours = tprd.interp(T(x), T(xp), T(fp))
    ref = jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp))
    assert _ulps(ours, ref, fp) <= 1.0


def test_interp_is_batched_over_rows():
    """Leading dimensions of xp/fp are independent rows; x broadcasts."""
    rng = np.random.default_rng(4)
    xp = np.sort(rng.uniform(0, 1, (2, 3, 25)), axis=-1)
    fp = rng.uniform(0, 1, (2, 3, 25))
    x = rng.uniform(-0.1, 1.1, 40)
    ours = tprd.interp(T(x), T(xp), T(fp)).numpy()
    assert ours.shape == (2, 3, 40)
    for i in range(2):
        for j in range(3):
            ref = jnp.interp(jnp.asarray(x), jnp.asarray(xp[i, j]),
                             jnp.asarray(fp[i, j]))
            assert _ulps(ours[i, j], ref, fp[i, j]) <= 1.0


# ---- the JAX package's oracles (tests/test_prd.py:14-72) on the port ----
def test_gII_line_centre():
    # G_zero(0) = 1/sqrt(1.273239545) = sqrt(pi)/2
    v = float(tprd.gII(T(1e-3), T(0.0), T(0.0)))
    assert np.isclose(v, np.sqrt(np.pi) / 2.0, rtol=1e-6)


def test_gII_symmetry():
    a = T(0.01)
    qE = torch.linspace(-8.0, 8.0, 33, dtype=torch.float64)
    qA = torch.linspace(-8.0, 8.0, 41, dtype=torch.float64)
    g1 = tprd.gII(a, qE[:, None], qA[None, :]).numpy()
    g2 = tprd.gII(a, -qE[:, None], -qA[None, :]).numpy()
    assert np.allclose(g1, g2, rtol=1e-12)


@pytest.mark.parametrize('qEmit', [0.0, 1.0, 3.0, 6.0, 20.0])
def test_gII_normalisation(qEmit):
    """Integral of gII over absorption frequency ~ 1 (photon conservation;
    the Gouttebroze approximation is accurate to a few percent)."""
    qA = np.arange(-60.0, 60.0, 0.02)
    g = tprd.gII(T(1e-3), T(qEmit), T(qA)).numpy()
    integral = np.sum(0.5 * (g[1:] + g[:-1]) * np.diff(qA))
    assert abs(integral - 1.0) < 0.08, integral


def test_scatter_rho_flat_J_fixed_point():
    """With J flat in frequency and Jbar equal to that value, the
    normalised scattering integral returns exactly J, so rho == 1."""
    W, Nk = 21, 5
    qWave = np.tile(np.linspace(-1.0, 1.0, W)[:, None] * 30.0, (1, Nk))
    Jval = 3.7e-9
    rho = tprd.prd_scatter_rho(T(qWave), T(np.full(Nk, 1e-2)),
                               T(np.full((W, Nk), Jval)),
                               T(np.full(Nk, 2.0e5)), T(np.full(Nk, Jval)))
    assert np.allclose(rho.numpy(), 1.0, atol=1e-10)


def test_scatter_rho_sign():
    """If J in the wings exceeds Jbar, rho > 1 at wing frequencies (more
    scattered photons than the CRD mean)."""
    W, Nk = 41, 3
    q = np.linspace(-50.0, 50.0, W)
    qWave = np.tile(q[:, None], (1, Nk))
    Jw = np.tile((1.0 + 0.5 * (q / 50.0) ** 2)[:, None], (1, Nk))
    rho = tprd.prd_scatter_rho(T(qWave), T(np.full(Nk, 1e-2)), T(Jw),
                               T(np.ones(Nk)), T(np.ones(Nk))).numpy()
    assert rho[0, 0] > 1.0 and rho[-1, 0] > 1.0
    # at line centre the local J ~ Jbar, so rho ~ 1
    assert abs(rho[W // 2, 0] - 1.0) < 0.1


# ---- the Ng copy against the JAX Ng (tests/test_ng.py's cases) ---------
def _linear_problem(n=50, seed=0, rho=0.95):
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    lam = rng.uniform(0.5, rho, n)
    A = Q @ np.diag(lam) @ Q.T
    xStar = rng.uniform(5.0, 15.0, n)
    return A, (np.eye(n) - A) @ xStar, xStar


@pytest.mark.parametrize('opts', [(2, 4, 10), (3, 2, 5), (0, 0, 0)])
def test_ng_matches_jax_ng(opts):
    """Both accelerators on the same linear fixed-point iteration: the
    same iterates, flags and max_change at every step (identical numpy
    code), and the accelerated ones converge at least twice as fast."""
    A, b, xStar = _linear_problem()
    ngs = [mod.Ng(*opts, np.ones(len(b))) for mod in (tng, jng)]
    x = np.ones(len(b))
    for it in range(200):
        x = A @ x + b
        (acc, out), (jacc, jout) = (ng.accelerate(x) for ng in ngs)
        assert acc == jacc
        np.testing.assert_array_equal(out, jout)
        assert ngs[0].max_change() == ngs[1].max_change()
        x = out
        if np.max(np.abs(x - xStar) / np.abs(xStar)) < 1e-10:
            break
    if opts == (2, 4, 10):
        assert it + 1 < 100
    assert tng.NgOptions(*opts) == tng.NgOptions(Norder=opts[0],
                                                 Nperiod=opts[1],
                                                 Ndelay=opts[2])


def test_ng_disabled_is_identity_and_tracks_change():
    ng = tng.Ng(0, 0, 0, np.ones(4))
    acc, out = ng.accelerate(np.full(4, 2.0))
    assert not acc
    np.testing.assert_array_equal(out, np.full(4, 2.0))
    np.testing.assert_allclose(ng.max_change(), 0.5)
