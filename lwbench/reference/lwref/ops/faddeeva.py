"""Faddeeva function w(z) and the Voigt profile H(a, v).

Port of lightweaver_tpu/ops/faddeeva.py: Weideman's (1994, SIAM J.
Numer. Anal. 31, 1497) single rational approximation with N=48 terms,
one branch-free Horner evaluation, <1e-9 relative accuracy in H over the
physical damping range (a >= 1e-5).  The arithmetic stays on explicit
(real, imag) pairs, operation for operation as the JAX version, so both
packages give the same profiles to rounding; torch's complex128 would
evaluate the divisions with another algorithm.
"""
import numpy as np
import torch

_N_WEIDEMAN = 48


def _weideman_coeffs(N):
    """Polynomial coefficients a_1..a_N of Weideman's rational approximation
    w(z) ~= (1/sqrt(pi) + 2 p(Z) / (L - iz)) / (L - iz), Z = (L+iz)/(L-iz),
    computed by the FFT construction of the original paper."""
    M = 2 * N
    L = np.sqrt(N / np.sqrt(2.0))
    theta = np.arange(-M + 1, M) * np.pi / M
    t = L * np.tan(theta / 2.0)
    f = np.exp(-t * t) * (L * L + t * t)
    f = np.concatenate([[0.0], f])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / (2.0 * M)
    return L, np.flipud(a[1:N + 1])   # highest order first


_WEIDEMAN_L, _A_ARR = _weideman_coeffs(_N_WEIDEMAN)
_WEIDEMAN_L = float(_WEIDEMAN_L)
_WEIDEMAN_A = [float(c) for c in _A_ARR]
_ISQRTPI = float(1.0 / np.sqrt(np.pi))


def _cdiv(ar, ai, br, bi):
    d = br * br + bi * bi
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def wofz_parts(x, y):
    """(Re, Im) of w(z) for z = x + iy with y >= 0."""
    L = _WEIDEMAN_L
    # d = L - iz = (L + y) - i x
    dr = L + y
    di = -x
    # Z = (L + iz) / (L - iz)
    zr, zi = _cdiv(L - y, x, dr, di)

    # p(Z) by Horner on (re, im) pairs; coefficients are real
    pr = torch.full_like(x, _WEIDEMAN_A[0])
    pi = torch.zeros_like(x)
    for c in _WEIDEMAN_A[1:]:
        pr, pi = pr * zr - pi * zi + c, pr * zi + pi * zr

    # w = (2 p / d + 1/sqrt(pi)) / d
    nr, ni = _cdiv(2.0 * pr, 2.0 * pi, dr, di)
    return _cdiv(nr + _ISQRTPI, ni, dr, di)


def voigt_H(a, v):
    """Voigt function H(a, v) = Re[w(v + ia)], normalized so that
    integral over v of H dv = sqrt(pi).

    ref: Source/LwMisc.hpp:13-19
    """
    a, v = torch.broadcast_tensors(a, v)
    return wofz_parts(v, a)[0]


def voigt_HF(a, v):
    """Voigt and dispersion profiles as a real pair (H, F), H + iF =
    w(v + ia): the anomalous dispersion of Zeeman-polarised lines.

    ref: Source/LwMisc.hpp:21-27
    """
    a, v = torch.broadcast_tensors(a, v)
    return wofz_parts(v, a)
