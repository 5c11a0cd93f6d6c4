"""2D short-characteristics formal solver (x periodic or fixed, z
stratified), in PyTorch.

Port of lightweaver_tpu/ops/formal_solver2d.py.  The JAX package leaves
the plane sweep to XLA (no Pallas kernel); here a CUDA tensor runs it in
the kernel csrc/sweep2d.cu (sweep2d_cuda, one launch per ray group) and a
CPU tensor in plain torch ops (sweep_rays_2d_plain), the function the
kernel is held to.

- build_geometry_2d: the upwind, start-plane downwind and interior
  downwind intersections of one ray direction, host numpy (the same
  arrays as the JAX package's, its double loop vectorised).
- _ring_affine_solve: the cyclic affine recurrence I_i = A_i I_{i-1} + b_i
  around the x ring, as a log-step (Hillis-Steele) scan of the affine
  maps over x closed with I_last = b_tot / (1 - A_tot): 3 log2(Nx) ops per
  ring, not Nx.
- sweep_rays_2d: the z-plane sweep of a GROUP of rays of one direction
  (every mu of a (mu, toObs) set), batched over wavelength and ray: the
  kernel for a CUDA tensor, else sweep_rays_2d_plain, one Python loop
  over the Nz - 1 planes.  The rays whose x step is negative are swept in
  the x-reversed frame (flip_geometry), where every ray steps with
  dj = +1 and its fixed x column (non-periodic mode) is column 0; planes
  are read into that frame and written back out of it.
- formal_sol_2d: the JAX package's per-ray function (one geometry), a
  group of one ray.

ref: Source/FormalScalar2d.cpp:434-706 (sweep), :1188-1327 (intersections)
"""
import ctypes

import numpy as np
import torch

from . import _build
from .formal_solver import besser_coeffs, besser_control_point, w2
from .planck import planck_nu

INTERP_2D = ('linear', 'besser')
ALONG_RAY_2D = ('linear', 'besser')


def _besser_interp(yM, yO, yP, u):
    """Monotonic quadratic-Bezier interpolation between yM (u=0) and yO
    (u=1) with the third upwind point yP shaping the control point
    (uniform spacing).  ref: interp_besser_2d,
    Source/FormalScalar2d.cpp:297-434"""
    cM = besser_control_point(1.0, 1.0, yM, yO, yP)
    return (1.0 - u) ** 2 * yM + 2.0 * u * (1.0 - u) * cM + u ** 2 * yO


def _face(t, tz):
    """(axisZ, weight, ds) of intersections whose x path is t and z path
    tz (broadcast): the x side face where t < tz (weight t/tz), else the
    z-plane (weight tz/t, 0 for a vertical ray)."""
    side = t < tz
    with np.errstate(divide='ignore', invalid='ignore'):
        r = t / tz
        q = np.where(np.isfinite(t), tz / t, 0.0)
    return side, np.where(side, r, q), np.where(side, t, tz)


def build_geometry_2d(x, z, mux, muz, toObs, periodic=True):
    """Upwind-intersection geometry for one ray direction over the grid.

    x: [Nx] (increasing), z: [Nz] (decreasing with index, like height);
    mux, muz: ray direction for this (mu, toObs) (muz sign included).
    Returns a dict of numpy arrays in SWEEP order over planes (sweepZ[0]
    is the starting plane):
      axisZ [Nz-1, Nx] bool: upwind on the x side face (couples in-plane),
      w      [Nz-1, Nx]: interpolation weight of the previous plane (side
             face) or of column j-dj (z-plane),
      ds     [Nz-1, Nx]: upwind path length,
      sweepZ [Nz]: z indices in sweep order, dj: x-sweep direction,
    the starting plane's DOWNWIND intersections (the thermalised z
    boundary, ref: FormalScalar2d.cpp:567-612):
      sAxisZ, sW, sDs [Nx], sJ/sJn [Nx] int (anchor column and its
      dw-side neighbour; sJ != j only at the most-downwind column in
      non-periodic mode, which borrows its neighbour's intersection -- the
      reference's FormalScalar2d.cpp:586),
    and the interior downwind intersections of the BESSER along-ray
    scheme (row m: plane m towards m+1; dwZero marks the non-periodic
    most-downwind column, which has none): dwAxisZ, dwW, dwDs, dwZero
    [Nz-1, Nx], jn [Nx].
    The values are the JAX package's bit for bit: the same IEEE operations
    per element, over arrays instead of a double loop.
    ref: Source/FormalScalar2d.cpp:102-142
    """
    x = np.asarray(x, np.float64)
    z = np.asarray(z, np.float64)
    Nx, Nz = len(x), len(z)
    dj = 1 if mux >= 0 else -1
    sweepZ = np.arange(Nz - 1, -1, -1) if toObs else np.arange(Nz)
    vertical = mux == 0.0
    muzSafe = max(abs(muz), 1e-30)

    dx = np.empty(Nx)
    dxDw = np.empty(Nx)
    if dj > 0:
        dx[1:] = x[1:] - x[:-1]
        dx[0] = x[1] - x[0]                      # periodic: uniform seam
        dxDw[:-1] = x[1:] - x[:-1]
        dxDw[-1] = x[-1] - x[-2]
    else:
        dx[:-1] = x[1:] - x[:-1]
        dx[-1] = x[-1] - x[-2]
        dxDw[1:] = x[1:] - x[:-1]
        dxDw[0] = x[1] - x[0]
    tx = np.full(Nx, np.inf) if vertical else dx / abs(mux)
    txDw = np.full(Nx, np.inf) if vertical else dxDw / abs(mux)

    # upwind: plane m against m-1 (m = 1..Nz-1)
    dz = np.abs(z[sweepZ[1:]] - z[sweepZ[:-1]])
    tz = (dz / muzSafe)[:, None]
    axisZ, wgt, ds = _face(np.broadcast_to(tx, (Nz - 1, Nx)), tz)

    # starting-plane downwind intersections
    tzS = abs(z[sweepZ[1]] - z[sweepZ[0]]) / muzSafe
    sJ = np.arange(Nx)
    jEndIdx = Nx - 1 if dj > 0 else 0
    downwindEdge = not periodic and not vertical
    if downwindEdge:
        sJ[jEndIdx] = jEndIdx - dj
    sAxisZ, sW, sDs = _face(txDw[sJ], tzS)
    sJn = (sJ + dj) % Nx

    # interior downwind intersections: plane m towards m+1 (m = 0..Nz-2)
    dwAxisZ, dwW, dwDs = _face(np.broadcast_to(txDw, (Nz - 1, Nx)), tz)
    dwZero = np.zeros((Nz - 1, Nx), bool)
    if downwindEdge:
        dwZero[:, jEndIdx] = True
        dwAxisZ[:, jEndIdx] = False
        dwW[:, jEndIdx] = 0.0
        dwDs[:, jEndIdx] = 0.0
    jn = (np.arange(Nx) + dj) % Nx
    return {'axisZ': axisZ, 'w': wgt, 'ds': ds, 'sweepZ': sweepZ, 'dj': dj,
            'sAxisZ': sAxisZ, 'sW': sW, 'sDs': sDs, 'sJ': sJ, 'sJn': sJn,
            'dwAxisZ': dwAxisZ, 'dwW': dwW, 'dwDs': dwDs, 'dwZero': dwZero,
            'jn': jn}


def flip_geometry(geom):
    """The geometry of a ray with dj = -1 in the x-reversed frame (column
    j' = Nx - 1 - j), where it steps with dj = +1: every per-column array
    reversed along x and the column indices (sJ, sJn, jn) mapped through
    the reversal.  For dj = +1 the geometry itself.  It equals
    build_geometry_2d on the reversed grid -x[::-1] with |mux|."""
    if geom['dj'] > 0:
        return geom
    Nx = geom['axisZ'].shape[-1]
    out = {'sweepZ': geom['sweepZ'], 'dj': 1}
    for key in ('axisZ', 'w', 'ds', 'sAxisZ', 'sW', 'sDs', 'dwAxisZ', 'dwW',
                'dwDs', 'dwZero'):
        out[key] = geom[key][..., ::-1].copy()
    for key in ('sJ', 'sJn', 'jn'):
        out[key] = (Nx - 1 - geom[key])[::-1].copy()
    return out


def _ring_affine_solve(A, b):
    """Solve the cyclic affine recurrence I_i = A_i I_{i-1} + b_i around a
    ring (indices in ring order along the last axis).  A, b: [..., N].

    An inclusive log-step (Hillis-Steele) scan composes the maps (step s:
    lane i takes A_i A_{i-s}, A_i b_{i-s} + b_i), then the ring closes
    with I_last = b_tot / (1 - A_tot) and I = A_cum I_last + b_cum, the
    JAX package's closure (its associative_scan composes in another order,
    so the two agree to rounding, not bit for bit)."""
    A, b = affine_scan(A, b)
    Ilast = b[..., -1:] / (1.0 - A[..., -1:])
    return A * Ilast + b


def affine_scan(A, b):
    """The inclusive log-step scan of _ring_affine_solve: lane i's map
    composed of the maps of lanes 0..i, (A_cum, b_cum) [..., N]."""
    N = A.shape[-1]
    s = 1
    while s < N:
        A, b = (torch.cat([A[..., :s], A[..., s:] * A[..., :-s]], dim=-1),
                torch.cat([b[..., :s], torch.addcmul(b[..., s:], A[..., s:],
                                                     b[..., :-s])], dim=-1))
        s *= 2
    return A, b


def ray_group(geoms, periodic, device, dtype):
    """The device form of the geometries of a group of R rays of one
    direction (one sweepZ), for sweep_rays_2d: each ray's geometry in its
    dj = +1 frame (flip_geometry), stacked ray-minor per plane as
    [Nz-1, R, Nx] (the rows the plane loop reads), the starting-plane
    arrays in the NATURAL frame [R, Nx] (thermalised_start_2d), the x
    maps, and the fixed x column of the non-periodic rays (``periodic``:
    one bool per ray, the ray's effective x periodicity).
    Keys: 'sweepZ', 'flip' [R] bool, 'xIdx' [R, Nx] (the column of frame
    position j', an involution), 'fixed' [R, Nx] bool (the fixed column
    j' = 0 of the non-periodic rays), 'fixedNat' [R, Nx] (the same column
    in the natural frame), 'axisZ', 'w', 'ds', 'dwAxisZ', 'dwW', 'dwDs',
    'dwZero' [Nz-1, R, Nx] (the downwind rows shifted to the computed
    planes 1..Nz-1 with the final plane's dummy row, dwZero there: the
    JAX package's formal_sol_2d), 'sAxisZ', 'sW', 'sDs', 'sJ', 'sJn'
    [R, Nx] natural."""
    sweepZ = geoms[0]['sweepZ']
    for g in geoms:
        if not np.array_equal(g['sweepZ'], sweepZ):
            raise ValueError('a ray group shares one sweep direction')
    Nx = geoms[0]['axisZ'].shape[-1]
    flips = [flip_geometry(g) for g in geoms]
    flip = np.array([g['dj'] < 0 for g in geoms])
    xIdx = np.where(flip[:, None], np.arange(Nx)[::-1], np.arange(Nx))
    fixed = np.zeros((len(geoms), Nx), bool)
    fixed[:, 0] = ~np.asarray(periodic, bool)
    fixedNat = np.take_along_axis(fixed, xIdx, axis=1)

    def ray_minor(key, pad=None):
        rows = []
        for g in flips:
            a = g[key][1:] if pad is not None else g[key]
            if pad is not None:
                a = np.concatenate([a, np.full((1, Nx), pad, a.dtype)])
            rows.append(a)
        return np.stack(rows, axis=1)

    def t_(a, dt=dtype):
        return torch.tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    bool_ = torch.bool
    long_ = torch.int64
    out = {'sweepZ': [int(k) for k in sweepZ],
           'flip': t_(flip, bool_), 'anyFlip': bool(flip.any()),
           'xIdx': t_(xIdx, long_), 'fixed': t_(fixed, bool_),
           'fixedNat': t_(fixedNat, bool_), 'anyFixed': bool(fixed.any()),
           'axisZ': t_(ray_minor('axisZ'), bool_),
           'w': t_(ray_minor('w')), 'ds': t_(ray_minor('ds')),
           'dwAxisZ': t_(ray_minor('dwAxisZ', False), bool_),
           'dwW': t_(ray_minor('dwW', 0.0)),
           'dwDs': t_(ray_minor('dwDs', 1.0)),
           'dwZero': t_(ray_minor('dwZero', True), bool_)}
    for key, dt in (('sAxisZ', bool_), ('sW', dtype), ('sDs', dtype),
                    ('sJ', long_), ('sJn', long_)):
        out[key] = t_(np.stack([g[key] for g in geoms]), dt)
    return out


def group_as(group, dtype):
    """The ray group with its real arrays in ``dtype``; the group itself
    where they are already (the sweep kernel takes one dtype)."""
    if group['w'].dtype == dtype:
        return group
    return {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
            else v for k, v in group.items()}


def _take_x(x, idx):
    """x [..., R, Nx] with each ray's columns taken at idx [R, n]."""
    return torch.gather(x, -1, idx.expand(*x.shape[:-1], idx.shape[-1]))


def thermalised_start_2d(chi0, chi1, T0, T1, lam, group, own=None):
    """The thermalised start plane of every ray of a group, from each
    ray's DOWNWIND intersection with fractional-x interpolation of chi and
    T, as the reference (ref: FormalScalar2d.cpp:567-612):
    I = B(T0) - (B(T_dw) - B(T0)) / dtau.  chi0, chi1 [NL, R, Nx] the
    start plane and the next one, T0, T1 [Nx] their temperatures, lam
    [NL]; natural x frame.  Returns [NL, R, Nx]; with ``own`` (a slice of
    the columns, parallel/xshard2d.py's block between its halos) the
    group's per-column arrays are those columns' and the result is
    [NL, R, own]."""
    sA, sW, sDs = group['sAxisZ'], group['sW'], group['sDs']
    sJ, sJn = group['sJ'], group['sJn']
    chiDw = torch.where(
        sA, (1.0 - sW) * _take_x(chi0, sJn) + sW * _take_x(chi1, sJn),
        (1.0 - sW) * _take_x(chi1, sJ) + sW * _take_x(chi1, sJn))
    TDw = torch.where(sA, (1.0 - sW) * T0[sJn] + sW * T1[sJn],
                      (1.0 - sW) * T1[sJ] + sW * T1[sJn])      # [R, Nx]
    if own is not None:
        chi0, T0 = chi0[..., own], T0[own]
    dtau = 0.5 * (chi0 + chiDw) * sDs
    Bn = planck_nu(T0[None, None, :], lam[:, None, None])
    BnDw = planck_nu(TDw[None], lam[:, None, None])
    return Bn - (BnDw - Bn) / dtau


def _plane_step(planes, Iprev, Iprev2, m, group, IbcP, interp, alongRay,
                ring=_ring_affine_solve):
    """One computed plane (sweep index m >= 1) of a group in the dj = +1
    frame.  planes = (chiP2, chiP, chiC, chiN, SP2, SP, SC, SN), each
    [NL, R, Nx] (chiN/SN: the next plane, for the BESSER along-ray
    scheme); Iprev, Iprev2 the intensities of planes m-1, m-2; IbcP
    [NL, R] the fixed column's intensity on this plane or None; ``ring``
    solves the in-plane recurrence (parallel/xshard2d.py passes its
    distributed solve, over a rank's block of columns between halos).
    Returns (I, Psi undivided, IeffBase) of the plane, the JAX package's
    _sweep_2d.plane_step."""
    chiP2, chiP, chiC, chiN, SP2, SP, SC, SN = planes
    g = m - 1
    axisZ, w, ds = group['axisZ'][g], group['w'][g], group['ds'][g]
    omw = 1.0 - w

    def prev(x, s=1):
        """Column j - s of each row (ring order)."""
        return torch.roll(x, s, dims=-1)

    # axis-Z (side face): upwind = (1-w)*(current, j-1) + w*(prev, j-1)
    # axis-X (prev plane): upwind = (1-w)*(prev, j) + w*(prev, j-1)
    chiPP, SPP, IPP = prev(chiP), prev(SP), prev(Iprev)
    chiCP, SCP = prev(chiC), prev(SC)
    if interp == 'besser':
        chiUw = torch.where(axisZ,
                            _besser_interp(chiCP, chiPP, prev(chiP2), w),
                            _besser_interp(chiP, chiPP, prev(chiP, 2), w))
        SUw = torch.where(axisZ, _besser_interp(SCP, SPP, prev(SP2), w),
                          _besser_interp(SP, SPP, prev(SP, 2), w))
    else:
        chiUw = torch.where(axisZ, omw * chiCP + w * chiPP,
                            omw * chiP + w * chiPP)
        SUw = torch.where(axisZ, omw * SCP + w * SPP, omw * SP + w * SPP)

    dtau = 0.5 * (chiUw + chiC) * ds
    w0, w1 = w2(dtau)
    c1 = (SUw - SC) / dtau
    Acoef = 1.0 - w0
    base = w0 * SC + w1 * c1
    Psi = w0 - w1 / dtau
    IeffbS = w1 * SUw / dtau         # S-part of the compensated split

    if alongRay == 'besser':
        # BESSER along-ray integration (ref piecewise_besser_2d,
        # FormalScalar2d.cpp:955-1000): chi/S control points from the
        # downwind intersection; cells with no downwind (dwZero: final
        # plane, non-periodic most-downwind column) keep the linear step
        dwA, dwW, dwZero = (group['dwAxisZ'][g], group['dwW'][g],
                            group['dwZero'][g])
        dsDwSafe = torch.where(dwZero, 1.0, group['dwDs'][g])
        omdw = 1.0 - dwW
        chiNn = torch.roll(chiN, -1, dims=-1)
        SNn = torch.roll(SN, -1, dims=-1)
        chiDw = torch.where(dwA, omdw * torch.roll(chiC, -1, dims=-1)
                            + dwW * chiNn, omdw * chiN + dwW * chiNn)
        SDw = torch.where(dwA, omdw * torch.roll(SC, -1, dims=-1)
                          + dwW * SNn, omdw * SN + dwW * SNn)
        chiCtrl = besser_control_point(ds, dsDwSafe, chiUw, chiC, chiDw)
        dtauUw = (1.0 / 3.0) * (chiUw + chiCtrl + chiC) * ds
        dtauDw = 0.5 * (chiC + chiDw) * dsDwSafe
        SCtrl = besser_control_point(dtauUw, dtauDw, SUw, SC, SDw)
        M, O, Cc, edt = besser_coeffs(dtauUw)
        Acoef = torch.where(dwZero, Acoef, edt)
        base = torch.where(dwZero, base, M * SUw + O * SC + Cc * SCtrl)
        Psi = torch.where(dwZero, Psi, O + Cc)
        IeffbS = torch.where(dwZero, IeffbS, M * SUw + Cc * (SCtrl - SC))

    # known part of Acoef*Iuw; the (current, j-1) term is the in-plane
    # affine coupling with coefficient A
    IuwX = omw * Iprev + w * IPP
    bKnown = torch.where(axisZ, base + Acoef * w * IPP, base + Acoef * IuwX)
    A = torch.where(axisZ, Acoef * omw, 0.0)
    fixed = group['fixed'] if IbcP is not None else None
    if fixed is not None:
        # fixed boundary column: breaks the ring into a plain chain
        A = torch.where(fixed, 0.0, A)
        bKnown = torch.where(fixed, IbcP[..., None], bKnown)
    Icur = ring(A, bKnown)
    Iuw = torch.where(axisZ, omw * prev(Icur) + w * IPP, IuwX)

    if interp == 'besser':
        # second pass: BESSER-interpolated upwind intensity with the
        # control point frozen at the first pass's solution
        IuwXb = _besser_interp(Iprev, IPP, prev(Iprev, 2), w)
        cM = besser_control_point(1.0, 1.0, prev(Icur), IPP, prev(Iprev2))
        knownZ = 2.0 * w * omw * cM + w ** 2 * IPP
        bKnown2 = torch.where(axisZ, base + Acoef * knownZ,
                              base + Acoef * IuwXb)
        A2 = torch.where(axisZ, Acoef * omw ** 2, 0.0)
        if fixed is not None:
            A2 = torch.where(fixed, 0.0, A2)
            bKnown2 = torch.where(fixed, IbcP[..., None], bKnown2)
        Icur = ring(A2, bKnown2)
        Iuw = torch.where(axisZ, omw ** 2 * prev(Icur) + knownZ, IuwXb)

    # compensated split: I - Psi*S from non-cancelling terms
    Ieffb = IeffbS + Acoef * Iuw
    if fixed is not None:
        Psi = torch.where(fixed, 0.0, Psi)
        Ieffb = torch.where(fixed, Icur, Ieffb)
    return Icur, Psi, Ieffb


def _check_schemes(interp, alongRay, S, srcNum):
    if interp not in INTERP_2D or alongRay not in ALONG_RAY_2D:
        raise ValueError(f'unknown 2D scheme interp={interp!r}, '
                         f'alongRay={alongRay!r}; available: {INTERP_2D}')
    if (S is None) == (srcNum is None):
        raise ValueError('give exactly one of S and srcNum')


def sweep_rays_2d(chi, group, Iupw, S=None, srcNum=None, Ibc=None,
                  interp='linear', alongRay='linear', out=None):
    """2D formal solution of a group of rays of one direction over a
    [Nz, Nx] grid.

    chi: [NL, R, Nz, Nx] (natural z order, index 0 = top; natural x);
    S, or srcNum (S = srcNum / chi is formed plane by plane): the same
    shape; group: ray_group of the R rays; Iupw: [NL, R, Nx] intensity of
    the sweep's start plane (natural x); Ibc: [NL, R, Nz] the fixed x
    column's intensity per plane (natural z) for the rays group['fixed']
    marks (None: zero inflow); interp, alongRay: 'linear' or
    'besser' (the JAX package's _sweep_2d).  Returns (I, Psi, IeffBase)
    [NL, R, Nz, Nx] in natural order, Psi divided by chi (IeffBase = I -
    Psi S from the compensated split), written into ``out`` (three tensors
    of that shape) when given.

    On a CUDA device one launch of csrc/sweep2d.cu (sweep2d_cuda), which
    raises on what it cannot take; on the CPU the plain loop
    (sweep_rays_2d_plain)."""
    args = (chi, group, Iupw)
    kw = dict(S=S, srcNum=srcNum, Ibc=Ibc, interp=interp, alongRay=alongRay,
              out=out)
    if chi.device.type == 'cuda':
        return sweep2d_cuda(*args, **kw)
    if chi.device.type != 'cpu':
        raise RuntimeError(f'no 2D sweep kernel for device {chi.device}')
    return sweep_rays_2d_plain(*args, **kw)


def sweep_rays_2d_plain(chi, group, Iupw, S=None, srcNum=None, Ibc=None,
                        interp='linear', alongRay='linear', out=None):
    """Plain PyTorch version of the 2D sweep kernel (sweep_rays_2d's
    arguments and result): one Python loop over the Nz - 1 planes, each
    plane _plane_step's torch ops, batched over wavelength and ray."""
    _check_schemes(interp, alongRay, S, srcNum)
    NL, R, Nz, Nx = chi.shape
    sweepZ = group['sweepZ']
    if out is None:
        out = tuple(torch.empty_like(chi) for _ in range(3))
    Iout, PsiOut, IeffOut = out
    xIdx = group['xIdx']

    def frame(x):
        """x [NL, R, Nx] between the natural and the dj = +1 frame."""
        return _take_x(x, xIdx) if group['anyFlip'] else x

    def plane(k):
        """chi and S of z index k in the dj = +1 frame."""
        c = frame(chi[:, :, k])
        s = frame(S[:, :, k]) if S is not None else frame(
            srcNum[:, :, k]) / c
        return c, s

    def put(k, I, Psi, Ieff):
        Iout[:, :, k] = frame(I)
        PsiOut[:, :, k] = frame(Psi)
        IeffOut[:, :, k] = frame(Ieff)

    fixedIbc = None
    if group['anyFixed']:
        fixedIbc = Ibc if Ibc is not None else chi.new_zeros((NL, R, Nz))
    I0 = frame(Iupw)
    put(sweepZ[0], I0, torch.zeros_like(I0), I0)
    c0, s0 = plane(sweepZ[0])
    c1, s1 = plane(sweepZ[1])
    # planes m-2, m-1, m, m+1 (m-2 duplicated at the first interval, the
    # next plane duplicated past the last: the JAX package's padding)
    chiP2, chiP, chiC = c0, c0, c1
    SP2, SP, SC = s0, s0, s1
    Iprev = Iprev2 = I0
    for m in range(1, Nz):
        if m + 1 < Nz:
            chiN, SN = plane(sweepZ[m + 1])
        else:
            chiN, SN = chiC, SC
        IbcP = (None if fixedIbc is None
                else fixedIbc[:, :, sweepZ[m]])
        Icur, Psi, Ieffb = _plane_step(
            (chiP2, chiP, chiC, chiN, SP2, SP, SC, SN), Iprev, Iprev2, m,
            group, IbcP, interp, alongRay)
        put(sweepZ[m], Icur, Psi / chiC, Ieffb)
        chiP2, chiP, chiC = chiP, chiC, chiN
        SP2, SP, SC = SP, SC, SN
        Iprev, Iprev2 = Icur, Iprev
    return Iout, PsiOut, IeffOut


# rows up to NARROW_COLUMNS x 256 columns (csrc/sweep2d.cu: kMaxThreads,
# which refuses a wider block) take the narrow kernel, NARROW_COLUMNS to a
# thread (its fastest at the main path's Nx = 256), wider rows the wide
# kernel, which keeps WIDE_WORK_ROWS rows of [Nx] per (lambda, ray) row in
# a work array (csrc/sweep2d.cu: kWideFields, which it checks)
NARROW_COLUMNS = 2
NARROW_MAX_NX = NARROW_COLUMNS * 256
WIDE_WORK_ROWS = 7
# csrc/sweep2d.cu's name of each scheme (enum Scheme)
SCHEME_NAMES_2D = {'linear': 'kLinear', 'besser': 'kBesser'}
CUDA_ERROR_INVALID_VALUE = 1


def wide_kernel(Nx):
    """Whether rows of Nx columns take the wide kernel."""
    return Nx > NARROW_MAX_NX


def _sweep_order(Nz, Nx, sweepZ):
    """(z0, dz): the sweep's first plane and step; ValueError where the
    grid has no plane to sweep to or no ring."""
    if Nz < 2 or Nx < 2:
        raise ValueError(f'the 2D sweep kernel takes Nz >= 2 and Nx >= 2, '
                         f'got Nz={Nz}, Nx={Nx}')
    if list(sweepZ) == list(range(Nz)):
        return 0, 1
    if list(sweepZ) == list(range(Nz - 1, -1, -1)):
        return Nz - 1, -1
    raise ValueError(f'sweepZ must run over the {Nz} planes in order, '
                     f'either way, got {sweepZ}')


def sweep2d_cuda(chi, group, Iupw, S=None, srcNum=None, Ibc=None,
                 interp='linear', alongRay='linear', out=None):
    """Launch csrc/sweep2d.cu on sweep_rays_2d's arguments: one launch for
    the group, on the current stream, with nothing read back to the host,
    through the operator torch.ops.lightweaver.sweep2d (so that the
    profiler links the kernel to an operation).  Counts its launches in
    ``sweep2d_cuda.launches`` (float64) and ``sweep2d_cuda.launches_f32``.
    Raises TypeError on a dtype the kernel is not instantiated for and
    ValueError on a shape, a tensor that is not contiguous or not on chi's
    CUDA device, or a grid the kernel refuses."""
    _check_schemes(interp, alongRay, S, srcNum)
    if chi.dtype not in (torch.float64, torch.float32):
        raise TypeError(f'the 2D sweep kernel is instantiated for float64 '
                        f'and float32, got {chi.dtype}')
    if chi.dim() != 4:
        raise ValueError(f'chi must be [NL, R, Nz, Nx], got '
                         f'{tuple(chi.shape)}')
    NL, R, Nz, Nx = chi.shape
    z0, dz = _sweep_order(Nz, Nx, group['sweepZ'])
    src = S if S is not None else srcNum
    if out is None:
        out = tuple(torch.empty_like(chi) for _ in range(3))
    rows = (Nz - 1, R, Nx)
    real, flag = chi.dtype, torch.bool
    # name: (tensor or None, shape, dtype), in lw_sweep2d's order
    tensors = {'chi': (chi, chi.shape, real),
               'S' if S is not None else 'srcNum': (src, chi.shape, real),
               'Iupw': (Iupw, (NL, R, Nx), real),
               'Ibc': (Ibc, (NL, R, Nz), real),
               'axisZ': (group['axisZ'], rows, flag),
               'w': (group['w'], rows, real), 'ds': (group['ds'], rows, real),
               'dwAxisZ': (group['dwAxisZ'], rows, flag),
               'dwW': (group['dwW'], rows, real),
               'dwDs': (group['dwDs'], rows, real),
               'dwZero': (group['dwZero'], rows, flag),
               'fixed': (group['fixed'], (R, Nx), flag),
               'flip': (group['flip'], (R,), flag),
               'out[0]': (out[0], chi.shape, real),
               'out[1]': (out[1], chi.shape, real),
               'out[2]': (out[2], chi.shape, real)}
    for name, (x, shape, dtype) in tensors.items():
        if x is None:
            continue
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f'{name} must be {tuple(shape)}, got '
                             f'{tuple(x.shape)}')
        if x.dtype != dtype:
            raise TypeError(f'{name} is {x.dtype}, the kernel takes {dtype} '
                            f'beside chi {chi.dtype}')
        if not x.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
        if x.device != chi.device:
            raise ValueError(f'{name} is on {x.device}, chi on {chi.device}')
    if not chi.is_cuda:
        raise ValueError(f'sweep2d_cuda takes CUDA tensors, got {chi.device}')
    work = (torch.empty((NL, R, WIDE_WORK_ROWS, Nx), dtype=real,
                        device=chi.device) if wide_kernel(Nx) else None)
    ins = [x for x, _, _ in tensors.values()][:13]
    torch.ops.lightweaver.sweep2d(ins, list(out), work, z0, dz, S is None,
                                  interp, alongRay)
    attr = 'launches_f32' if chi.dtype == torch.float32 else 'launches'
    setattr(sweep2d_cuda, attr, getattr(sweep2d_cuda, attr) + 1)
    return out


sweep2d_cuda.launches = 0
sweep2d_cuda.launches_f32 = 0


def _sweep2d_launch(ins, outs, work, z0, dz, srcIsNum, interp, alongRay):
    """The launch of lw_sweep2d on sweep2d_cuda's checked tensors (ins in
    its order up to flip; outs I, Psi, IeffBase), the CUDA kernel of the
    operator lightweaver::sweep2d."""
    chi = ins[0]
    NL, R, Nz, Nx = chi.shape
    lib = load_library(chi.dtype, interp, alongRay, Nx)
    ptrs = [None if x is None else x.data_ptr() for x in [*ins, *outs]]
    err = lib.lw_sweep2d(*ptrs, None if work is None else work.data_ptr(),
                         0 if work is None else work.numel(), NL, R, Nz, Nx,
                         z0, dz, int(srcIsNum), _build.cuda_stream(chi))
    if err == CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f'the 2D sweep kernel refused the grid NL={NL}, '
                         f'R={R}, Nz={Nz}, Nx={Nx} (csrc/sweep2d.cu: '
                         'launch)')
    _build.check_launch(err, '2D sweep')


# the operator, registered through torch.library.Library: custom_op's
# first call imports torch._dynamo, seconds of a run's set-up
_OPS = torch.library.Library('lightweaver', 'DEF')
_OPS.define('sweep2d(Tensor?[] ins, Tensor(a!)[] outs, Tensor(b!)? work, '
            'int z0, int dz, bool srcIsNum, str interp, str alongRay) -> ()')
_OPS.impl('sweep2d', _sweep2d_launch, 'CUDA')


# no multiply-add contraction: the kernel rounds each operation as the
# plain version's separate torch ops do (csrc/sweep2d.cu)
NVCC_FLAGS_2D = ('-fmad=false',)


def instance_flags(dtype, interp, alongRay, Nx):
    """The nvcc flags that build the instance of csrc/sweep2d.cu for the
    working dtype, the two schemes and rows of Nx columns (the narrow
    kernel or the wide one): one kernel a library, so that a scheme's
    first use builds one kernel."""
    real = 'float' if dtype == torch.float32 else 'double'
    cols = 0 if wide_kernel(Nx) else NARROW_COLUMNS
    return NVCC_FLAGS_2D + (f'-DLW_SWEEP2D_REAL={real}',
                            f'-DLW_SWEEP2D_INTERP={SCHEME_NAMES_2D[interp]}',
                            f'-DLW_SWEEP2D_ALONG={SCHEME_NAMES_2D[alongRay]}',
                            f'-DLW_SWEEP2D_COLS={cols}')


def load_library(dtype, interp, alongRay, Nx):
    """Build csrc/sweep2d.cu's instance (instance_flags) with nvcc, once
    per source hash and flags, and load it."""
    sig = ([_build.PTR] * 17 + [ctypes.c_longlong] + [_build.INT] * 7
           + [_build.PTR])
    return _build.load('sweep2d', {'lw_sweep2d': sig},
                       flags=instance_flags(dtype, interp, alongRay, Nx))


def formal_sol_2d(chi, S, geom, Iupw, interp='linear', periodic=True,
                  Ibc=None, alongRay='linear'):
    """2D formal solution for one (mu, toObs) ray over a [Nz, Nx] grid:
    the JAX package's function, a group of one ray.

    chi, S: [B, Nz, Nx] (natural z order, index 0 = top); geom from
    build_geometry_2d; Iupw: [B, Nx] boundary intensity at the sweep start
    plane; interp: 'linear' | 'besser' upwind interpolation of chi, S and
    I; periodic: cyclic x (False = fixed callable x BC with per-plane
    intensities Ibc [B, Nz] in natural z order); alongRay: 'linear' |
    'besser' along-ray integration.  Returns I, Psi, IeffBase ([B, Nz,
    Nx], natural order; Psi divided by chi)."""
    group = ray_group([geom], [periodic], chi.device, chi.dtype)
    I, Psi, Ieff = sweep_rays_2d(
        chi[:, None], group, Iupw[:, None], S=S[:, None],
        Ibc=None if Ibc is None else Ibc[:, None], interp=interp,
        alongRay=alongRay)
    return I[:, 0], Psi[:, 0], Ieff[:, 0]
