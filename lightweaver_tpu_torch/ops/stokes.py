"""Full-Stokes polarised formal solution: the 4x4 propagation matrix and
the DELO-Bezier3 integrator.

Port of lightweaver_tpu/ops/stokes.py.  The per-step 4x4 system
I_k = Md^-1 (Ma I_{k-1} + rhs_k) has Md, Ma and rhs independent of I, so
every matrix is formed as a dense batched tensor, the 4x4 systems are
solved in one batch (ops/linalg.py:batched_solve), and the sweep is the
affine matrix recurrence I_m = A_m I_{m-1} + b_m, a loop over depth of
batched 4x4 mat-vecs.  With K = 0 the matrices collapse to the scalar
Bezier-3 coefficients, so unpolarised wavelengths need no other path.
The JAX package leaves all of this to XLA; here it is plain torch ops on
the tensors' device, with no kernel of its own.
ref: Source/FormalStokes.cpp:119-341
"""
import torch

from .formal_solver import _point_derivs, bezier3_coeffs
from .linalg import batched_solve


def stokes_K(chi7):
    """Normalised 4x4 propagation matrix (minus the diagonal) from the
    7-component opacity vector [chiI, chiQ, chiU, chiV, psiQ, psiU, psiV].

    chi7: [..., 7] -> K: [..., 4, 4]
    ref: Source/FormalStokes.cpp:119-142
    """
    chiI = chi7[..., 0]
    eQ = chi7[..., 1] / chiI
    eU = chi7[..., 2] / chiI
    eV = chi7[..., 3] / chiI
    rQ = chi7[..., 4] / chiI
    rU = chi7[..., 5] / chiI
    rV = chi7[..., 6] / chiI
    z = torch.zeros_like(chiI)
    return torch.stack([
        torch.stack([z, eQ, eU, eV], dim=-1),
        torch.stack([eQ, z, rV, -rU], dim=-1),
        torch.stack([eU, -rV, z, rQ], dim=-1),
        torch.stack([eV, rU, -rQ, z], dim=-1),
    ], dim=-2)


def delo_bezier_stokes(chi7, S4, height, muz, I_upw, to_obs=True):
    """DELO-Bezier3 polarised formal solution for a batch of rays.

    chi7: [B, 7, N]; S4: [B, 4, N]; height: [N] (k=0 top, decreasing);
    muz: [B]; I_upw: [B, 4] boundary Stokes vector at the sweep start.
    Returns I: [B, 4, N] in the original depth indexing.
    """
    B, _, N = chi7.shape
    if to_obs:
        chi7, S4, h_s = chi7.flip(-1), S4.flip(-1), height.flip(-1)
    else:
        h_s = height

    chiI = chi7[:, 0]                                    # [B, N]
    ds = torch.abs(h_s[1:] - h_s[:-1])[None, :] / muz[:, None]   # [B, N-1]

    # Bezier optical depth per interval (as the scalar solver's)
    dchi = _point_derivs(chiI, ds)
    Cuw = chiI[..., :-1] + (ds / 3.0) * dchi[..., :-1]
    C0 = chiI[..., 1:] - (ds / 3.0) * dchi[..., 1:]
    dtau = ds * (chiI[..., :-1] + chiI[..., 1:] + Cuw + C0) * 0.25  # [B, N-1]

    # K and S with their tau-derivatives at every point
    K = stokes_K(torch.movedim(chi7, 1, -1))             # [B, N, 4, 4]
    S = torch.movedim(S4, 1, -1)                         # [B, N, 4]
    dsK = dtau[..., None, None]
    dK = torch.movedim(_point_derivs(torch.movedim(K, 1, -1),
                                     torch.movedim(dsK, 1, -1)), -1, 1)
    dS = torch.movedim(_point_derivs(torch.movedim(S, 1, -1),
                                     torch.movedim(dtau[..., None], 1, -1)),
                       -1, 1)

    # interval m = 1..N-1: upwind index m-1, local index m
    Ku, K0 = K[:, :-1], K[:, 1:]
    dKu, dK0 = dK[:, :-1], dK[:, 1:]
    Su, S0 = S[:, :-1], S[:, 1:]
    dSu, dS0 = dS[:, :-1], dS[:, 1:]
    dt = dtau[..., None, None]                           # [B, N-1, 1, 1]

    alpha, beta, gamma, delta, edt = bezier3_coeffs(dt)
    eye = torch.eye(4, dtype=chi7.dtype, device=chi7.device)

    Ku2 = Ku @ Ku
    K02 = K0 @ K0
    d = dt / 3.0 * (Ku2 + Ku - dKu) - Ku
    e = dt / 3.0 * (K02 + K0 - dK0) + K0
    Md = eye + beta * K0 + delta * e
    Ma = edt * eye - alpha * Ku + gamma * d
    Mb = alpha * eye + gamma * (eye - dt / 3.0 * Ku)
    Mc = beta * eye + delta * (eye + dt / 3.0 * K0)

    rhs = (torch.einsum('bnij,bnj->bni', Mb, Su)
           + torch.einsum('bnij,bnj->bni', Mc, S0)
           + dtau[..., None] / 3.0 * (gamma[..., 0] * dSu
                                      - delta[..., 0] * dS0))

    # I_m = A_m I_{m-1} + b_m through batched 4x4 solves
    MdF = Md.reshape(-1, 4, 4)
    MaF = Ma.reshape(-1, 4, 4)
    A = torch.stack([batched_solve(MdF, MaF[:, :, c]) for c in range(4)],
                    dim=-1).reshape(B, N - 1, 4, 4)
    b = batched_solve(MdF, rhs.reshape(-1, 4)).reshape(B, N - 1, 4)

    I = torch.empty((B, 4, N), dtype=chi7.dtype, device=chi7.device)
    Iprev = I_upw
    I[:, :, 0] = Iprev
    for m in range(N - 1):
        Iprev = torch.einsum('bij,bj->bi', A[:, m], Iprev) + b[:, m]
        I[:, :, m + 1] = Iprev
    if to_obs:
        I = I.flip(-1)
    return I
