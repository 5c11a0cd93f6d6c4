"""The x-sharded 2D formal solver: the x axis of a 2D grid block-sharded
over the ranks of a mesh dimension.

Port of lightweaver_tpu/parallel/xshard2d.py, the replacement for the
reference's ZPlaneDecomposition hook (ref:
Source/SimdFullIterationTemplates.hpp:253-281).  The JAX package runs a
restated plane sweep under shard_map with ppermute halos; here every rank
runs the single-card pieces of ops/formal_solver2d.py (_plane_step and
its log-step ring scan) on its block of Nx / p columns widened by HALO
columns on each side, and the collectives are all_gathers over the x
group:

- the chi and S (or srcNum) halos and the start plane's: one all_gather
  of every rank's edge columns per sweep;
- per plane and ring solve, one all_gather of every rank's edge columns
  of the inclusive affine scan (_ring_solve_sharded).  The last column
  of each is the rank's affine total, from which every rank closes the
  ring I_j = A_j I_{j-1} + b_j exactly (the JAX package's distributed
  associative scan) and forms its own entry value AND the values of its
  neighbours' edge columns, which are the previous plane's I halos of the
  next plane; no lagged halo.

The Stokes synthesis sweep (ops/stokes2d.py) is sharded the same way
(sweep_stokes_rays_2d_xsharded): one halo exchange of chi7, S4 and the
start plane, and per plane one all_gather of the 4 x 4 matrix scan's
edges (_ring_solve_sharded_mat).

Each ray is swept in its dj = +1 frame (ops/formal_solver2d.py:
flip_geometry): for a ray with dj = -1 the ranks' order along the ring is
reversed, so each rank's place in the ring is per ray (shard_ray_group's
'fpos').  Sharded and unsharded sweeps agree to the reassociation of the
affine compositions.
"""
import torch
import torch.distributed as dist

from ..ops import formal_solver2d as fs2d
from ..ops.collectives import all_gather
from ..ops.linalg import batched_solve
from ..ops.stokes2d import _plane_step_stokes, affine_scan_mat
from .multihost import rank_device

# the columns of a neighbour's block a rank's stencils read on each side
HALO = 2


class XShard:
    """This rank's block of the x axis: ``size`` ranks of ``group``, the
    rank ``index`` of them holding the Nx / size columns from x0.
    ``collectives`` counts the all_gathers of the sweeps."""

    def __init__(self, group, index: int, size: int, Nx: int):
        if Nx % size != 0 or Nx // size < 2:
            # the 2-column upwind halo reaches one block back only
            raise ValueError(f'Nx={Nx} must be divisible by the {size} x '
                             'shards with >= 2 columns per shard')
        self.group, self.s, self.p, self.Nx = group, index, size, Nx
        self.Nxl = Nx // size
        self.x0 = index * self.Nxl
        self.collectives = 0

    @classmethod
    def from_mesh(cls, mesh, axisName: str, Nx: int) -> 'XShard':
        """The block of this rank on ``mesh``'s dimension ``axisName`` (a
        torch DeviceMesh)."""
        names = getattr(mesh, 'mesh_dim_names', None) or ()
        if axisName not in names:
            raise ValueError(f'mesh= takes a DeviceMesh with a dimension '
                             f'named {axisName!r} (got {mesh!r})')
        dim = names.index(axisName)
        return cls(mesh.get_group(axisName), mesh.get_local_rank(axisName),
                   mesh.size(dim), Nx)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """x of every rank of the x group, [p, *x.shape]."""
        self.collectives += 1
        return all_gather(x, self.group)


def make_x_mesh(n=None, device='cuda', axisName: str = 'x'):
    """A one-dimensional DeviceMesh named ``axisName`` over the first n
    ranks of the default group (default: all of them), on the rank's card
    unless device='cpu'."""
    from torch.distributed.device_mesh import DeviceMesh
    n = dist.get_world_size() if n is None else n
    device = rank_device(device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    return DeviceMesh(device.type, torch.arange(n),
                      mesh_dim_names=(axisName,))


def shard_ray_group(group, shard: XShard):
    """A ray group (ops/formal_solver2d.py:ray_group) for the sweep of
    ``shard``'s block: the geometry on the block's columns widened by HALO
    on each side, W = Nx / p + 2 HALO, in each ray's frame ([Nz-1, R, W],
    'fixed' [R, W]); 'fpos' [R] the block's place in each ray's ring,
    'xIdx' [R, W] and 'xIdxOwn' [R, Nx / p] the frame maps of the widened
    block and of the block itself; the start-plane arrays on the block's
    natural columns with 'sJ'/'sJn' as positions in the widened natural
    block, and 'fixedNat' on those columns."""
    flip = group['flip']
    dev = flip.device
    Nx, Nxl, s, p = shard.Nx, shard.Nxl, shard.s, shard.p
    W = Nxl + 2 * HALO
    i = torch.arange(W, device=dev)
    j = torch.arange(Nxl, device=dev)
    fpos = torch.where(flip, p - 1 - s, s)
    cols = (fpos[:, None] * Nxl - HALO + i[None, :]) % Nx
    out = dict(group)
    for key in ('axisZ', 'w', 'ds', 'dwAxisZ', 'dwW', 'dwDs', 'dwZero'):
        g = group[key]
        out[key] = torch.gather(g, -1, cols.expand(g.shape[0], *cols.shape))
    out['fixed'] = torch.gather(group['fixed'], -1, cols)
    out['fpos'] = fpos
    out['xIdx'] = torch.where(flip[:, None], W - 1 - i, i)
    out['xIdxOwn'] = torch.where(flip[:, None], Nxl - 1 - j, j)
    own = shard.x0 + j
    out['fixedNat'] = group['fixedNat'][:, own]
    for key in ('sAxisZ', 'sW', 'sDs'):
        out[key] = group[key][:, own]
    for key in ('sJ', 'sJn'):
        delta = (group[key][:, own] - own + 1) % Nx - 1          # -1, 0, 1
        out[key] = HALO + j + delta
    return out


def prep_xshard_geometry(geoms, periodic, shard: XShard, device, dtype):
    """The geometry of a group of rays of one direction (each from
    build_geometry_2d; ``periodic`` one bool per ray) for the x-sharded
    sweep of ``shard``'s block, on ``device``: shard_ray_group of
    ops/formal_solver2d.py:ray_group (the JAX package's function prepares
    one ray's)."""
    return shard_ray_group(fs2d.ray_group(geoms, periodic, device, dtype),
                           shard)


def _exchange(shard: XShard, *tensors):
    """The halos of each tensor [..., Nx / p] (natural x), in ONE
    all_gather of every rank's HALO first and last columns: per tensor
    (left, right), the ring-previous rank's last and the ring-next rank's
    first HALO columns."""
    edges = [torch.cat([t[..., :HALO], t[..., -HALO:]], dim=-1)
             for t in tensors]
    G = shard.gather(torch.cat([e.reshape(-1) for e in edges]))
    out, off = [], 0
    for t, e in zip(tensors, edges):
        g = G[:, off:off + e.numel()].view(shard.p, *e.shape).to(t.dtype)
        off += e.numel()
        out.append((g[(shard.s - 1) % shard.p][..., HALO:],
                    g[(shard.s + 1) % shard.p][..., :HALO]))
    return out


def _edges(x, dim):
    """x's HALO first and HALO last entries along ``dim``, concatenated
    (slices: an index list would be copied from the host on each call)."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 0, HALO), x.narrow(dim, n - HALO, HALO)],
                     dim=dim)


def _pick(T, idx):
    """T [p, NL, R, ...] at each ray's entry idx [R] of the first axis:
    [NL, R, ...]."""
    shape = (1, 1, idx.shape[0]) + (1,) * (T.dim() - 3)
    return torch.gather(T, 0, idx.view(shape).expand(1, *T.shape[1:]))[0]


def _ring_solve_sharded(A, b, group, shard: XShard):
    """The exact solve of the cyclic recurrence I_j = A_j I_{j-1} + b_j
    whose ring is block-sharded over the x group.  A, b [NL, R, Nx / p]
    are this rank's block in each ray's frame.  Returns I on the block
    widened by the HALO columns of the ring-previous and ring-next blocks
    [NL, R, Nx / p + 2 HALO].

    The inclusive scan of the block (affine_scan), one all_gather of every
    block's scan at its HALO first and last columns (the last is the
    block's total), the p-step composition of the totals in ring order and
    the closure I_end = b_tot / (1 - A_tot): every rank then has each
    block's entry value, so its own I and its neighbours' edge columns."""
    Ac, bc = fs2d.affine_scan(A, b)
    G = shard.gather(torch.stack([_edges(Ac, -1), _edges(bc, -1)]))
    # [p, 2, .., 4]
    if group['anyFlip']:
        # ring order: the ranks reversed for the rays with dj = -1
        G = torch.where(group['flip'][:, None], G.flip(0), G)
    GA, Gb = G[:, 0], G[:, 1]
    Aacc = torch.ones_like(GA[0, ..., 3])
    bacc = torch.zeros_like(Gb[0, ..., 3])
    cums = []
    for f in range(shard.p):
        At, bt = GA[f, ..., 3], Gb[f, ..., 3]
        Aacc, bacc = Aacc * At, At * bacc + bt
        cums.append((Aacc, bacc))
    Iend = bacc / (1.0 - Aacc)
    # the entry value of each block in ring order: I at the end of the
    # block before it
    E = torch.stack([Iend] + [Acf * Iend + bcf for Acf, bcf in cums[:-1]])
    fpos = group['fpos']
    I = Ac * _pick(E, fpos)[..., None] + bc
    fprev, fnext = (fpos - 1) % shard.p, (fpos + 1) % shard.p
    left = (_pick(GA[..., HALO:], fprev) * _pick(E, fprev)[..., None]
            + _pick(Gb[..., HALO:], fprev))
    right = (_pick(GA[..., :HALO], fnext) * _pick(E, fnext)[..., None]
             + _pick(Gb[..., :HALO], fnext))
    return torch.cat([left, I, right], dim=-1)


def thermalised_start_xsharded(chi0, chi1, T0, T1, lam, group,
                               shard: XShard):
    """ops/formal_solver2d.py:thermalised_start_2d on this rank's block
    (natural x, [NL, R, Nx / p] and [Nx / p]), the downwind neighbours'
    chi and T from one halo exchange."""
    halos = _exchange(shard, chi0, chi1, T0, T1)
    c0, c1, t0, t1 = (torch.cat([lft, x, rgt], dim=-1)
                      for x, (lft, rgt) in zip((chi0, chi1, T0, T1), halos))
    return fs2d.thermalised_start_2d(c0, c1, t0, t1, lam, group,
                                     own=slice(HALO, HALO + shard.Nxl))


def sweep_rays_2d_xsharded(chi, group, Iupw, shard: XShard, S=None,
                           srcNum=None, Ibc=None, interp='linear',
                           alongRay='linear', out=None):
    """ops/formal_solver2d.py:sweep_rays_2d on this rank's block of x
    columns: chi, S or srcNum [NL, R, Nz, Nx / p] and Iupw [NL, R, Nx / p]
    in natural order, ``group`` from shard_ray_group, Ibc [NL, R, Nz] (the
    fixed column's inflow, on whichever rank holds it).  One halo
    exchange of chi, S and Iupw, then the plane loop of _plane_step on the
    widened block with the distributed ring solve.  Returns (I, Psi,
    IeffBase) of the block [NL, R, Nz, Nx / p], into ``out`` if given."""
    if interp not in fs2d.INTERP_2D or alongRay not in fs2d.ALONG_RAY_2D:
        raise ValueError(f'unknown 2D scheme interp={interp!r}, '
                         f'alongRay={alongRay!r}; available: '
                         f'{fs2d.INTERP_2D}')
    if (S is None) == (srcNum is None):
        raise ValueError('give exactly one of S and srcNum')
    NL, R, Nz, Nxl = chi.shape
    src = srcNum if S is None else S
    (chiL, chiR), (srcL, srcR), (IL, IR) = _exchange(shard, chi, src, Iupw)
    own = slice(HALO, HALO + Nxl)
    sweepZ = group['sweepZ']
    if out is None:
        out = tuple(torch.empty_like(chi) for _ in range(3))
    Iout, PsiOut, IeffOut = out
    flip = group['anyFlip']

    def frame(x):
        """The widened natural block [NL, R, W] in each ray's frame."""
        return fs2d._take_x(x, group['xIdx']) if flip else x

    def back(x):
        """The block's own columns of x [NL, R, W], natural order."""
        x = x[..., own]
        return fs2d._take_x(x, group['xIdxOwn']) if flip else x

    def plane(k):
        c = frame(torch.cat([chiL[:, :, k], chi[:, :, k], chiR[:, :, k]],
                            dim=-1))
        v = frame(torch.cat([srcL[:, :, k], src[:, :, k], srcR[:, :, k]],
                            dim=-1))
        return c, (v if S is not None else v / c)

    def put(k, I, Psi, Ieff):
        Iout[:, :, k] = back(I)
        PsiOut[:, :, k] = back(Psi)
        IeffOut[:, :, k] = back(Ieff)

    def ring(A, b):
        return _ring_solve_sharded(A[..., own], b[..., own], group, shard)

    fixedIbc = None
    if group['anyFixed']:
        fixedIbc = Ibc if Ibc is not None else chi.new_zeros((NL, R, Nz))
    I0 = frame(torch.cat([IL, Iupw, IR], dim=-1))
    put(sweepZ[0], I0, torch.zeros_like(I0), I0)
    c0, s0 = plane(sweepZ[0])
    c1, s1 = plane(sweepZ[1])
    chiP2, chiP, chiC = c0, c0, c1
    SP2, SP, SC = s0, s0, s1
    Iprev = Iprev2 = I0
    for m in range(1, Nz):
        if m + 1 < Nz:
            chiN, SN = plane(sweepZ[m + 1])
        else:
            chiN, SN = chiC, SC
        IbcP = None if fixedIbc is None else fixedIbc[:, :, sweepZ[m]]
        Icur, Psi, Ieffb = fs2d._plane_step(
            (chiP2, chiP, chiC, chiN, SP2, SP, SC, SN), Iprev, Iprev2, m,
            group, IbcP, interp, alongRay, ring=ring)
        put(sweepZ[m], Icur, Psi / chiC, Ieffb)
        chiP2, chiP, chiC = chiP, chiC, chiN
        SP2, SP, SC = SP, SC, SN
        Iprev, Iprev2 = Icur, Iprev
    return Iout, PsiOut, IeffOut


def formal_sol_2d_xsharded(chi, S, geom, Iupw, mesh, axisName='x',
                           interp='linear', periodic=True, Ibc=None,
                           alongRay='linear'):
    """x-sharded 2D formal solution of one (mu, toObs) ray, the JAX
    package's function: ops/formal_solver2d.py:formal_sol_2d's contract
    (chi, S [B, Nz, Nx] of the whole grid, natural z order; geom from
    build_geometry_2d; Iupw [B, Nx]; Ibc [B, Nz]) with the x axis
    block-sharded over ``mesh``'s dimension ``axisName``, whose ranks call
    it together.  Nx must split into blocks of >= 2 columns.  Returns this
    rank's block of I, Psi, IeffBase [B, Nz, Nx / p] (Psi divided by
    chi)."""
    B, Nz, Nx = chi.shape
    shard = XShard.from_mesh(mesh, axisName, Nx)
    group = prep_xshard_geometry([geom], [periodic], shard, chi.device,
                                 chi.dtype)
    blk = slice(shard.x0, shard.x0 + shard.Nxl)
    I, Psi, Ieff = sweep_rays_2d_xsharded(
        chi[:, None, :, blk], group, Iupw[:, None, blk], shard,
        S=S[:, None, :, blk], Ibc=None if Ibc is None else Ibc[:, None],
        interp=interp, alongRay=alongRay)
    return I[:, 0], Psi[:, 0], Ieff[:, 0]


def _ring_solve_sharded_mat(A, b, group, shard: XShard):
    """_ring_solve_sharded for the 4-vector ring of the Stokes sweep
    (ops/stokes2d.py:_ring_affine_solve_mat): A [NL, R, Nx / p, 4, 4], b
    [NL, R, Nx / p, 4] this rank's block in each ray's frame.  Returns I
    on the block widened by the HALO columns of the ring-previous and
    ring-next blocks [NL, R, Nx / p + 2 HALO, 4].  One all_gather of
    every block's scan at its HALO first and last columns, the p-step
    composition of the totals in ring order and the closure (1 - A_tot)
    I_end = b_tot solved per ray and row."""
    Ac, bc = affine_scan_mat(A, b)
    NL, R = A.shape[:2]
    sizes = (NL * R * 4 * 16, NL * R * 4 * 4)
    G = shard.gather(torch.cat([_edges(Ac, 2).reshape(-1),
                                _edges(bc, 2).reshape(-1)]))
    GA = G[:, :sizes[0]].view(shard.p, NL, R, 4, 4, 4)
    Gb = G[:, sizes[0]:].view(shard.p, NL, R, 4, 4)
    if group['anyFlip']:
        # ring order: the ranks reversed for the rays with dj = -1
        flip = group['flip']
        GA = torch.where(flip[:, None, None, None], GA.flip(0), GA)
        Gb = torch.where(flip[:, None, None], Gb.flip(0), Gb)
    eye = torch.eye(4, dtype=A.dtype, device=A.device)
    Aacc = eye.expand(NL, R, 4, 4)
    bacc = torch.zeros_like(Gb[0, :, :, 3])
    cums = []
    for f in range(shard.p):
        At, bt = GA[f, :, :, 3], Gb[f, :, :, 3]
        Aacc, bacc = At @ Aacc, (At @ bacc[..., None])[..., 0] + bt
        cums.append((Aacc, bacc))
    Iend = batched_solve((eye - Aacc).reshape(-1, 4, 4),
                         bacc.reshape(-1, 4)).view(NL, R, 4)
    # the entry value of each block in ring order
    E = torch.stack([Iend] + [(Acf @ Iend[..., None])[..., 0] + bcf
                              for Acf, bcf in cums[:-1]])

    def apply(Am, bv, x):
        """Am [NL, R, c, 4, 4] x [NL, R, 4] + bv [NL, R, c, 4]."""
        return (Am @ x[:, :, None, :, None])[..., 0] + bv
    fpos = group['fpos']
    fprev, fnext = (fpos - 1) % shard.p, (fpos + 1) % shard.p
    I = apply(Ac, bc, _pick(E, fpos))
    left = apply(_pick(GA[:, :, :, HALO:], fprev),
                 _pick(Gb[:, :, :, HALO:], fprev), _pick(E, fprev))
    right = apply(_pick(GA[:, :, :, :HALO], fnext),
                  _pick(Gb[:, :, :, :HALO], fnext), _pick(E, fnext))
    return torch.cat([left, I, right], dim=-2)


def sweep_stokes_rays_2d_xsharded(chi7, S4, group, Iupw, shard: XShard,
                                  Ibc=None):
    """ops/stokes2d.py:sweep_stokes_rays_2d on this rank's block of x
    columns: chi7 [NL, R, Nz, Nx / p, 7], S4 [NL, R, Nz, Nx / p, 4] and
    Iupw [NL, R, Nx / p, 4] in natural order, ``group`` from
    shard_ray_group, Ibc [NL, R, Nz] (the fixed column's Stokes-I inflow,
    on whichever rank holds it).  One halo exchange of chi7, S4 and Iupw
    (no rank holds more than its block and the halos), then the plane
    loop of _plane_step_stokes on the widened block with the distributed
    ring solve.  Returns I of the block [NL, R, Nz, Nx / p, 4]."""
    NL, R, Nz, Nxl, _ = chi7.shape
    halos = _exchange(shard, chi7.movedim(-1, -2), S4.movedim(-1, -2),
                      Iupw.movedim(-1, -2))
    (c7L, c7R), (s4L, s4R), (IL, IR) = (
        (lft.movedim(-1, -2), rgt.movedim(-1, -2)) for lft, rgt in halos)
    own = slice(HALO, HALO + Nxl)
    sweepZ = group['sweepZ']
    flip = group['anyFlip']
    xIdx, xIdxOwn = group['xIdx'][:, None, :], group['xIdxOwn'][:, None, :]

    def frame(x):
        """The widened natural block [NL, R, W, c] in each ray's frame."""
        return (fs2d._take_x(x.movedim(-1, -2), xIdx).movedim(-2, -1)
                if flip else x)

    def back(x):
        """The block's own columns of x [NL, R, W, c], natural order."""
        x = x[:, :, own]
        return (fs2d._take_x(x.movedim(-1, -2), xIdxOwn).movedim(-2, -1)
                if flip else x)

    def plane(k):
        return (frame(torch.cat([c7L[:, :, k], chi7[:, :, k], c7R[:, :, k]],
                                dim=-2)),
                frame(torch.cat([s4L[:, :, k], S4[:, :, k], s4R[:, :, k]],
                                dim=-2)))

    def ring(A, b):
        return _ring_solve_sharded_mat(A[:, :, own], b[:, :, own], group,
                                       shard)

    fixedIbc = None
    if group['anyFixed']:
        fixedIbc = Ibc if Ibc is not None else chi7.new_zeros((NL, R, Nz))
    Iout = torch.empty_like(S4)
    Iout[:, :, sweepZ[0]] = Iupw
    Iprev = frame(torch.cat([IL, Iupw, IR], dim=-2))
    chi7P, S4P = plane(sweepZ[0])
    for m in range(1, Nz):
        k = sweepZ[m]
        chi7C, S4C = plane(k)
        IbcP = None if fixedIbc is None else fixedIbc[:, :, k]
        Iprev = _plane_step_stokes(chi7P, chi7C, S4P, S4C, Iprev, m, group,
                                   IbcP, ring=ring)
        Iout[:, :, k] = back(Iprev)
        chi7P, S4P = chi7C, S4C
    return Iout
