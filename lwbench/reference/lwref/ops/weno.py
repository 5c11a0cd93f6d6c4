"""WENO-4 interpolation on non-uniform 1D grids.

Fourth-order weighted essentially non-oscillatory interpolation after
Janett et al. (2019, A&A 624, A104): in each cell the two neighbouring
quadratic (Lagrange) interpolants are blended with weights that combine
the ideal linear weights (which reconstruct the unique cubic through the
4-point stencil in smooth regions) with Jiang-Shu-style smoothness
indicators (the scaled integral of the squared derivatives over the
cell), so discontinuities and kinks do not ring.

The reference consumes this via the `weno4` PyPI package for tabulated
collisional rates and explicit photoionisation cross-sections
(ref: lightweaver/collisional_rates.py:83,
     lightweaver/atomic_model.py:751); this is an
independent numpy implementation of the published scheme.  Host-side
(setup-time) code: rates/cross-sections are evaluated in numpy before
entering the traced path.
"""
from typing import Optional

import numpy as np

__all__ = ['weno4']


def _newton2(xa, xb, xc, ya, yb, yc):
    """Divided differences of the quadratic through three points:
    q(x) = ya + d1 (x-xa) + d2 (x-xa)(x-xb)."""
    d1 = (yb - ya) / (xb - xa)
    d2 = ((yc - yb) / (xc - xb) - d1) / (xc - xa)
    return d1, d2


def _eval2(x, xa, xb, ya, d1, d2):
    return ya + (x - xa) * (d1 + d2 * (x - xb))


def _beta(xl, h, xa, xb, d1, d2):
    """Smoothness indicator of the quadratic over the cell [xl, xl+h]:
    sum_l h^(2l-1) * int (q^(l))^2 dx, evaluated in closed form
    (q'' = 2 d2 is constant; q'(xl) = d1 + d2 (2 xl - xa - xb))."""
    b = d1 + d2 * (2.0 * xl - xa - xb)
    a = d2
    return (16.0 / 3.0) * a * a * h ** 4 + 2.0 * a * b * h ** 3 + b * b * h * h


def weno4(xs, xp, fp, left: Optional[float] = None,
          right: Optional[float] = None, eps_rel: float = 1e-6):
    """Interpolate fp(xp) at xs.  xp must be strictly increasing.

    Outside the grid the edge quadratic extrapolates, unless `left` /
    `right` override the value beyond the first/last node (matching the
    reference's usage for cross-sections, which pass left=0, right=0).
    """
    xs = np.asarray(xs, dtype=np.float64)
    xp = np.asarray(xp, dtype=np.float64)
    fp = np.asarray(fp, dtype=np.float64)
    N = xp.shape[0]
    scalar = xs.ndim == 0
    x = np.atleast_1d(xs)

    if N == 1:
        out = np.full_like(x, fp[0])
    elif N == 2:
        t = (x - xp[0]) / (xp[1] - xp[0])
        out = fp[0] + t * (fp[1] - fp[0])
    elif N == 3:
        d1, d2 = _newton2(xp[0], xp[1], xp[2], fp[0], fp[1], fp[2])
        out = _eval2(x, xp[0], xp[1], fp[0], d1, d2)
    else:
        i = np.clip(np.searchsorted(xp, x, side='right') - 1, 0, N - 2)
        hasL = i >= 1            # left quadratic stencil {i-1, i, i+1}
        hasR = i <= N - 3        # right quadratic stencil {i, i+1, i+2}
        iL = np.where(hasL, i - 1, 0)
        iR = np.where(hasR, i, N - 3)

        d1L, d2L = _newton2(xp[iL], xp[iL + 1], xp[iL + 2],
                            fp[iL], fp[iL + 1], fp[iL + 2])
        d1R, d2R = _newton2(xp[iR], xp[iR + 1], xp[iR + 2],
                            fp[iR], fp[iR + 1], fp[iR + 2])
        qL = _eval2(x, xp[iL], xp[iL + 1], fp[iL], d1L, d2L)
        qR = _eval2(x, xp[iR], xp[iR + 1], fp[iR], d1R, d2R)

        xl = xp[i]
        h = xp[i + 1] - xl
        bL = _beta(xl, h, xp[iL], xp[iL + 1], d1L, d2L)
        bR = _beta(xl, h, xp[iR], xp[iR + 1], d1R, d2R)
        # ideal weights: reconstruct the 4-point cubic in smooth regions
        span = xp[np.minimum(i + 2, N - 1)] - xp[np.maximum(i - 1, 0)]
        gL = (xp[np.minimum(i + 2, N - 1)] - x) / span
        gR = (x - xp[np.maximum(i - 1, 0)]) / span
        eps = eps_rel * (np.abs(bL) + np.abs(bR)) + 1e-300
        with np.errstate(invalid='ignore', divide='ignore', over='ignore'):
            aL = gL / (bL + eps) ** 2
            aR = gR / (bR + eps) ** 2
            wL = aL / (aL + aR)
        # both indicators zero (locally constant data): ideal weights
        wL = np.where(np.isfinite(wL), wL, gL)
        wR = 1.0 - wL
        both = hasL & hasR
        out = np.where(both, wL * qL + wR * qR, np.where(hasL, qL, qR))

    if left is not None:
        out = np.where(x < xp[0], left, out)
    if right is not None:
        out = np.where(x > xp[-1], right, out)
    return out[()] if scalar else out
