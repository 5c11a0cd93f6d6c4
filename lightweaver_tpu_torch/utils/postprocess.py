"""Depth-resolved diagnostics from a Context with depthData.fill = True.

A jax-free copy of the JAX package's utils/postprocess.py for the port's
Context, whose depthData, J and background are tensors on its device (the
card by default): each function copies what it reads to the host itself
and computes in numpy, as the original does.
ref: lightweaver/utils.py:314-470
"""
import numpy as np

from .. import constants as Const

# np.trapz is np.trapezoid from numpy 2.0 on
_trapezoid = getattr(np, 'trapezoid', None) or np.trapz


def _host(x) -> np.ndarray:
    """x as a numpy array on the host (a torch tensor on any device is
    copied there, in its dtype)."""
    if hasattr(x, 'detach'):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _source_fn(ctx):
    chi = _host(ctx.depthData.chi)
    eta = _host(ctx.depthData.eta)
    sca = _host(ctx.bgSca)
    J = _host(ctx.J)
    return (eta + (sca * J)[:, None, None, :]) / chi


def compute_radiative_losses(ctx) -> np.ndarray:
    """Radiative gains(+)/losses(-) per (wavelength, depth) in J/s/m3/Hz:
    angle-integrated chi*(S - I).
    ref: lightweaver/utils.py:314-340"""
    if ctx.depthData.chi is None:
        raise ValueError('Set ctx.depthData.fill = True and run a formal '
                         'solution first')
    chi = _host(ctx.depthData.chi)
    S = _source_fn(ctx)
    I = _host(ctx.depthData.I)
    wmu = np.asarray(ctx.atmos.wmu)
    # sum over the two directions, quadrature over mu
    loss = np.einsum('lmdk,m->lk', chi * (S - I) * 0.5, wmu)
    return loss


def integrate_line_losses(ctx, loss: np.ndarray, lines,
                          extendGridNm: float = 0.0):
    """Integrate gains/losses over each line's wavelength band -> J/s/m3.
    ref: lightweaver/utils.py:343-404"""
    from ..atomic_model import AtomicLine
    if isinstance(lines, AtomicLine):
        lines = [lines]
    spect = ctx.spect
    wavelength = np.asarray(spect.wavelength)
    loss = _host(loss)

    out = []
    for line in lines:
        ident = line.transId
        blueIdx = spect.blueIdx[ident]
        redIdx = spect.redIdx[ident]
        blue = wavelength[blueIdx]
        red = wavelength[redIdx - 1]
        if extendGridNm != 0.0:
            wav = np.concatenate(((blue - extendGridNm,),
                                  wavelength[blueIdx:redIdx],
                                  (red + extendGridNm,)))
        else:
            wav = wavelength[blueIdx:redIdx]
        nu = Const.CLight / (wav * Const.NM_TO_M)       # [Hz], decreasing
        lineLoss = np.empty((loss.shape[1], wav.shape[0]))
        for k in range(loss.shape[1]):
            lineLoss[k] = np.interp(wav, wavelength, loss[:, k])
        # integrate over frequency (nu decreasing -> negate)
        out.append(-_trapezoid(lineLoss, nu, axis=1))
    return out[0] if len(out) == 1 else out


def compute_contribution_fn(ctx, mu: int = -1,
                            outgoing: bool = True) -> np.ndarray:
    """Contribution function Cfn(lambda, k) = chi/mu * exp(-tau/mu) * S
    for one angular index.
    ref: lightweaver/utils.py:406-451"""
    if ctx.depthData.chi is None:
        raise ValueError('Set ctx.depthData.fill = True and run a formal '
                         'solution first')
    upDown = 1 if outgoing else 0
    chiFull = _host(ctx.depthData.chi)
    chi = chiFull[:, mu, upDown, :]                     # [Nlam, Nk]
    height = np.asarray(ctx.atmos.height)
    muz = np.asarray(ctx.atmos.muz)[mu]

    tau = np.empty_like(chi)
    tau[:, 0] = 1e-20
    dh = height[:-1] - height[1:]                       # positive downward
    mid = 0.5 * (chi[:, 1:] + chi[:, :-1]) * dh[None, :]
    tau[:, 1:] = 1e-20 + np.cumsum(mid, axis=1)

    S = _source_fn(ctx)[:, mu, upDown, :]
    return chi / muz * np.exp(-tau / muz) * S


def compute_wavelength_edges(ctx) -> np.ndarray:
    """Edges of the wavelength bins (for pcolormesh-style plots).
    ref: lightweaver/utils.py:453-470"""
    wav = np.asarray(ctx.spect.wavelength)
    edges = np.concatenate((
        (wav[0] - 0.5 * (wav[1] - wav[0]),),
        0.5 * (wav[1:] + wav[:-1]),
        (wav[-1] + 0.5 * (wav[-1] - wav[-2]),)))
    return edges
