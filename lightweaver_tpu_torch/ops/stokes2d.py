"""Full-Stokes polarised formal solution on 2D (x, z) atmospheres, in
PyTorch.

Port of lightweaver_tpu/ops/stokes2d.py (a capability the reference's
Stokes solver lacks, ref: Source/FormalStokes.cpp:606-621).  The scalar
2D plane sweep (ops/formal_solver2d.py) generalised to 4-vectors: the
along-ray step is DELO-linear, the polarised transfer equation with the
Stokes-I optical depth and the normalised off-diagonal propagation matrix
K' (ops/stokes.py:stokes_K) integrated with S - K' I linearly
interpolated, so each cell steps

    (1 + a0 K'_0) I_0 = (e^{-dt} 1 - aU K'_uw) I_uw + aU S_uw + a0 S_0

with the scalar short-characteristic weights aU = w1/dt, a0 = w0 - w1/dt.
In-plane x coupling on axis-Z cells makes each z-plane a cyclic affine
recurrence of 4-vectors, I_j = A_j I_{j-1} + b_j with 4x4 A_j, solved by a
log-step scan of the matrix affine maps around the ring
(_ring_affine_solve_mat).  Upwind chi7/S4/I are interpolated linearly.
Synthesis only (the upgoing sweep, no Psi), batched over every ray of the
upgoing direction in one plane loop in the dj = +1 frame of
ops/formal_solver2d.py:ray_group.  The JAX package leaves this to XLA;
here it is plain torch ops, with no kernel of its own.
"""
import torch

from .formal_solver import w2
from .formal_solver2d import _take_x, ray_group
from .linalg import batched_solve
from .stokes import stokes_K


def affine_scan_mat(A, b):
    """The inclusive log-step (Hillis-Steele) scan of the matrix affine
    maps I_i = A_i I_{i-1} + b_i along axis -3 of A [..., N, 4, 4] (b
    [..., N, 4]): lane i takes A_i A_{i-s}, A_i b_{i-s} + b_i, so it ends
    with the composition of lanes 0..i, (A_cum, b_cum)."""
    N = A.shape[-3]
    s = 1
    while s < N:
        A, b = (torch.cat([A[..., :s, :, :],
                           A[..., s:, :, :] @ A[..., :-s, :, :]], dim=-3),
                torch.cat([b[..., :s, :],
                           (A[..., s:, :, :] @ b[..., :-s, :, None])[..., 0]
                           + b[..., s:, :]], dim=-2))
        s *= 2
    return A, b


def _ring_affine_solve_mat(A, b):
    """Solve the cyclic matrix affine recurrence I_i = A_i I_{i-1} + b_i
    around a ring (indices in ring order along axis -3 of A).
    A: [..., N, 4, 4]; b: [..., N, 4] -> I [..., N, 4].

    affine_scan_mat composes the maps, then (1 - A_tot) I_last = b_tot is
    solved per ring (ops/linalg.py:batched_solve) and I = A_cum I_last +
    b_cum."""
    A, b = affine_scan_mat(A, b)
    eye = torch.eye(4, dtype=A.dtype, device=A.device)
    lead = A.shape[:-3]
    Ilast = batched_solve((eye - A[..., -1, :, :]).reshape(-1, 4, 4),
                          b[..., -1, :].reshape(-1, 4)).reshape(*lead, 4)
    return (A @ Ilast[..., None, :, None])[..., 0] + b


def _plane_step_stokes(chi7P, chi7C, S4P, S4C, Iprev, m, group, IbcP,
                       ring=_ring_affine_solve_mat):
    """One computed plane (sweep index m >= 1) of the upgoing group in
    the dj = +1 frame: chi7 [NL, R, Nx, 7], S4 and I [NL, R, Nx, 4];
    IbcP [NL, R] the fixed column's Stokes-I inflow or None; ``ring``
    solves the plane's cyclic recurrence (the x-sharded sweep's closes
    it across the ranks).  The JAX package's _sweep_stokes_2d.plane_step."""
    g = m - 1
    axisZ, w, ds = group['axisZ'][g], group['w'][g], group['ds'][g]
    aZ = axisZ[..., None]
    wE = w[..., None]
    omwE = 1.0 - wE

    def prev(x):
        return torch.roll(x, 1, dims=-2)

    chi7PP, S4PP = prev(chi7P), prev(S4P)
    chi7Uw = torch.where(aZ, omwE * prev(chi7C) + wE * chi7PP,
                         omwE * chi7P + wE * chi7PP)
    S4Uw = torch.where(aZ, omwE * prev(S4C) + wE * S4PP,
                       omwE * S4P + wE * S4PP)

    dtau = 0.5 * (chi7Uw[..., 0] + chi7C[..., 0]) * ds
    w0, w1 = w2(dtau)
    aU = w1 / dtau
    a0 = w0 - w1 / dtau
    edt = 1.0 - w0

    eye = torch.eye(4, dtype=chi7C.dtype, device=chi7C.device)
    Kuw = stokes_K(chi7Uw)                    # [NL, R, Nx, 4, 4]
    K0 = stokes_K(chi7C)
    Md = eye + a0[..., None, None] * K0
    Ma = edt[..., None, None] * eye - aU[..., None, None] * Kuw
    rhs = aU[..., None] * S4Uw + a0[..., None] * S4C

    shape = Md.shape
    MdF = Md.reshape(-1, 4, 4)
    MaF = Ma.reshape(-1, 4, 4)
    Amat = torch.stack([batched_solve(MdF, MaF[:, :, c]) for c in range(4)],
                       dim=-1).reshape(shape)
    bBase = batched_solve(MdF, rhs.reshape(-1, 4)).reshape(rhs.shape)

    # known part of the upwind Stokes vector; the (current, j-1) term is
    # the in-plane matrix affine coupling
    IPP = prev(Iprev)
    IuwX = omwE * Iprev + wE * IPP
    knownUw = torch.where(aZ, wE * IPP, IuwX)
    bKnown = bBase + (Amat @ knownUw[..., None])[..., 0]
    Aring = torch.where(aZ[..., None], Amat * (1.0 - w)[..., None, None],
                        torch.zeros_like(Amat))
    if IbcP is not None:
        # fixed boundary column: breaks the ring into a plain chain, with
        # Stokes-I inflow and Q = U = V = 0
        fixed = group['fixed'][..., None]
        Aring = torch.where(fixed[..., None], 0.0, Aring)
        bcVec = torch.cat([IbcP[..., None],
                           IbcP.new_zeros((*IbcP.shape, 3))], dim=-1)
        bKnown = torch.where(fixed, bcVec[..., None, :], bKnown)
    return ring(Aring, bKnown)


def sweep_stokes_rays_2d(chi7, S4, group, Iupw, Ibc=None):
    """2D Stokes formal solution of a group of upgoing rays over a
    [Nz, Nx] grid, in one loop over the Nz - 1 planes.

    chi7: [NL, R, Nz, Nx, 7]; S4: [NL, R, Nz, Nx, 4] (natural z order,
    index 0 = top; natural x); group: ray_group of the R upgoing rays;
    Iupw: [NL, R, Nx, 4] the Stokes vectors of the start (bottom) plane;
    Ibc: [NL, R, Nz] the Stokes-I inflow of the fixed x column (natural z)
    of the rays group['fixed'] marks (None: zero).  Returns I [NL, R, Nz,
    Nx, 4] in natural order."""
    NL, R, Nz, Nx, _ = chi7.shape
    sweepZ = group['sweepZ']
    xIdx = group['xIdx'][..., None]

    def frame(x):
        """x [NL, R, Nx, c] between the natural and the dj = +1 frame."""
        return _take_x(x.movedim(-1, -2), xIdx.transpose(-1, -2)).movedim(
            -2, -1) if group['anyFlip'] else x

    fixedIbc = None
    if group['anyFixed']:
        fixedIbc = Ibc if Ibc is not None else chi7.new_zeros((NL, R, Nz))
    Iout = torch.empty_like(S4)
    Iprev = frame(Iupw)
    Iout[:, :, sweepZ[0]] = Iupw
    chi7P, S4P = frame(chi7[:, :, sweepZ[0]]), frame(S4[:, :, sweepZ[0]])
    for m in range(1, Nz):
        k = sweepZ[m]
        chi7C, S4C = frame(chi7[:, :, k]), frame(S4[:, :, k])
        IbcP = None if fixedIbc is None else fixedIbc[:, :, k]
        Iprev = _plane_step_stokes(chi7P, chi7C, S4P, S4C, Iprev, m, group,
                                   IbcP)
        Iout[:, :, k] = frame(Iprev)
        chi7P, S4P = chi7C, S4C
    return Iout


def formal_sol_stokes_2d(chi7, S4, geom, Iupw, periodic=True, Ibc=None):
    """2D Stokes formal solution for one upgoing (mu, toObs=True) ray over
    a [Nz, Nx] grid: the JAX package's function, a group of one ray.

    chi7: [B, Nz, Nx, 7]; S4: [B, Nz, Nx, 4] (natural z order, index 0 =
    top); geom from build_geometry_2d for (mu, toObs=True); Iupw: [B, Nx,
    4] the Stokes vector at the sweep start (bottom) plane; Ibc: [B, Nz]
    Stokes-I inflow at the fixed x column (natural z order) when
    periodic=False.  Returns I [B, Nz, Nx, 4] in natural order."""
    group = ray_group([geom], [periodic], chi7.device, chi7.dtype)
    return sweep_stokes_rays_2d(
        chi7[:, None], S4[:, None], group, Iupw[:, None],
        None if Ibc is None else Ibc[:, None])[:, 0]
