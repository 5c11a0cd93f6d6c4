"""Line Gamma/rate accumulation per same-atom overlap group of lines
(iteration scheme 'mali_full_precond_pallas').

Counterpart of lightweaver_tpu/ops/pallas_gamma.py.  The CUDA kernel
``csrc/gamma.cu`` replaces the TPU kernel ``group_gamma_rates`` there; the
plain PyTorch versions below compute the same function and are what runs
for tensors on the CPU.  For one group of K same-atom lines whose windows
overlap (so that the level sums chi_i/chi_j/U_i/U_j and the atomic eta are
exact) it reads phi once and returns

    G4      [K, 4, nBlk, Nk]  lambda-block partials of Gij, Gji, Rij, Rji
    PPB     [K, Wu, Nk]       sum_mu wmu/2 Psi phi_m
    PairPPB [P, Wu, Nk]       sum_mu wmu/2 Psi phi_m phi_m', m < m'
                              (P = K(K-1)/2; one zero row when K == 1)

on the group's union window of Wu rows starting at global row ``row0``.
Blocks are BW rows of the window; the caller sums them.  The moments feed
the continuum transitions' cross terms with the group's lines.

One launch covers every group of every active atom: ``LineTable`` packs
the groups' iteration-constant inputs (profiles, coefficient rows, wphi,
a rho buffer of ones, the level statics) and their offsets into packed
outputs once per Context; ``line_gamma_rates`` takes the table and this
call's rho, ray tensors and the active atoms' stacked continuum rows and
populations, and returns the packed G4, PPB and PairPPB, which
``LineTable.views`` cuts into each group's.  ``group_gamma_rates`` is the
same for one group.

Layouts are the port's: ray tensors direction-major [2, Nlam, Nmu, Nk],
a group's profiles [K, 2, Wu, Nmu, Nk] with zeros outside each member's
own window.  Where the JAX kernel takes S and chiTot, this one takes
srcNum (= S chiTot to one rounding), which the gather emits.

Groups of up to KMAX = 16 lines: the kernel has paths templated on K =
1..4 and one where K is a runtime value; a larger group raises.

The kernel is pointwise in depth, so a batch of columns laid end to end
along Nk (parallel/columns.py) runs through it unchanged.  Its packed
offsets are int32: LineTable refuses packed inputs or outputs of 2^31
elements or more, and line_gamma_rates a ray tensor of more than 2^31 - 1
(ops/sweep.py:MAX_RAY_ELEMENTS; ~2,400 falc_h6ca columns); ray, continuum
and eta offsets are size_t in the kernel.

Two instances, float64 and float32 (the f32 state).  In float32 G4 holds
float partials of at most BW rows x 2 Nmu rays, as the TPU kernel's; the
caller finishes the lambda sum in float64.  A CUDA tensor launches the
instance of its dtype or raises.
"""
import copy
from typing import List, NamedTuple, Tuple

import torch

from . import _build
from .sweep import check_ray_elements

BW = 8         # rows per lambda block of G4
TK = 32        # depths per thread block of the kernel
KMAX = 16      # largest group the kernel's table holds (csrc/gamma.cu)
# int32 fields per group of the kernel's table (csrc/gamma.cu:LineGroup):
# K, row0, Wu, nBlk, atom, seven offsets, levels[KMAX][2], masks[KMAX][3]
_META = 12 + 5 * KMAX


def line_groups(atom) -> List[List[int]]:
    """Connected components of the atom's line window-overlap graph, as
    sorted lists of transition indices, ordered by their smallest root
    (the grouping of pallas_gamma.py:line_groups)."""
    lines = [(ti, t) for ti, t in enumerate(atom.trans) if t.isLine]
    parent = {ti: ti for ti, _ in lines}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a in range(len(lines)):
        for b in range(a + 1, len(lines)):
            ta, tb = lines[a][1], lines[b][1]
            if max(ta.Nblue, tb.Nblue) < min(ta.Nred, tb.Nred):
                parent[find(lines[a][0])] = find(lines[b][0])
    groups = {}
    for ti, _ in lines:
        groups.setdefault(find(ti), []).append(ti)
    return [sorted(g) for _, g in sorted(groups.items())]


def gamma_scheme_supported(cfg) -> bool:
    """Whether the line Gamma kernel covers this configuration: a 1D
    atmosphere (the JAX package's scheme needs 1D), float64 or float32
    (the two instances built), no hybrid PRD (its comoving-frame rho
    varies per ray, the kernel's per row) and no line group above KMAX
    members.  The port's Context refuses dense Gamma at construction,
    pallas_scheme_supported's other check."""
    return (cfg.dtype in (torch.float64, torch.float32) and not cfg.hprd
            and getattr(cfg, 'Ndim', 1) == 1
            and all(len(g) <= KMAX for a in cfg.activeAtoms
                    for g in line_groups(a)))


class GroupStatics(NamedTuple):
    """Level bookkeeping of one group: levels[m] = (i, j) of member m;
    signs[m][m2] = (sI, sJ), the sign of member m2's chi in member m's
    chi_i / chi_j; uIn[m][m2] = (inI, inJ), whether member m2's Uji is
    in member m's U_i / U_j."""
    levels: Tuple
    signs: Tuple
    uIn: Tuple


def group_statics(ts) -> GroupStatics:
    """GroupStatics of the member transitions ``ts`` (objects with i, j)."""
    return GroupStatics(
        levels=tuple((t.i, t.j) for t in ts),
        signs=tuple(tuple(((t2.i == t.i) - (t2.j == t.i),
                           (t2.i == t.j) - (t2.j == t.j)) for t2 in ts)
                    for t in ts),
        uIn=tuple(tuple((int(t2.j == t.i), int(t2.j == t.j)) for t2 in ts)
                  for t in ts))


def _pairs(K):
    return [(m, m2) for m in range(K) for m2 in range(m + 1, K)]


def _block_sums(x, nBlk):
    """[Wu, Nk] -> [nBlk, Nk] sums over BW consecutive rows."""
    Wu, Nk = x.shape
    x = torch.cat([x, x.new_zeros((nBlk * BW - Wu, Nk))])
    return x.reshape(nBlk, BW, Nk).sum(dim=1)


def group_gamma_rates_plain(phi, rho, Psi, IeffBase, I, srcNum, chiCL, UCL,
                            etaC, n, coef, wphi, wmuHalf,
                            st: GroupStatics, row0: int):
    """Plain PyTorch version of the kernel for one group, in its order of
    terms (see the module docstring for the arguments and results)."""
    K, _, Wu, Nmu, Nk = phi.shape
    nBlk = -(-Wu // BW)
    rows = slice(row0, row0 + Wu)
    psi, ieffb, Iw, src = (x[:, rows] for x in (Psi, IeffBase, I, srcNum))
    w = wmuHalf[None, None, :, None]

    def row(x):                       # [Wu, Nk] -> [1, Wu, 1, Nk]
        return x[None, :, None, :]

    v1, v2, u2, chiM = [], [], [], []
    etaA = row(etaC[rows])
    for m in range(K):
        iL, jL = st.levels[m]
        a1, gR, uR = (coef[m, :, c][None, :, None, None] for c in range(3))
        v1.append(a1 * phi[m])
        v2.append(gR * v1[m] * row(rho[m]))
        u2.append(uR * v2[m])
        chiM.append(row(n[iL][None, :]) * v1[m] - row(n[jL][None, :]) * v2[m])
        etaA = etaA + row(n[jL][None, :]) * u2[m]
    Ieff = ieffb + psi * (src - etaA)

    G4 = []
    for m in range(K):
        iL, jL = st.levels[m]
        chi_i, chi_j = row(chiCL[iL, rows]), row(chiCL[jL, rows])
        U_i, U_j = row(UCL[iL, rows]), row(UCL[jL, rows])
        for m2 in range(K):
            sI, sJ = st.signs[m][m2]
            if sI:
                chi_i = chi_i + sI * chiM[m2]
            if sJ:
                chi_j = chi_j + sJ * chiM[m2]
            inI, inJ = st.uIn[m][m2]
            if inI:
                U_i = U_i + u2[m2]
            if inJ:
                U_j = U_j + u2[m2]
        wlw = w * row(coef[m, :, 3][:, None] * wphi[m][None, :])
        terms = (((u2[m] + v2[m] * Ieff) - psi * chi_i * U_j) * wlw,
                 (v1[m] * Ieff - psi * chi_j * U_i) * wlw,
                 Iw * v1[m] * wlw,
                 (u2[m] + Iw * v2[m]) * wlw)
        G4.append(torch.stack([_block_sums(x.sum(dim=(0, 2)), nBlk)
                               for x in terms]))
    PPB = torch.stack([(w * phi[m] * psi).sum(dim=(0, 2)) for m in range(K)])
    pairs = _pairs(K)
    PairPPB = (torch.stack([(w * phi[m] * phi[m2] * psi).sum(dim=(0, 2))
                            for m, m2 in pairs]) if pairs
               else phi.new_zeros((1, Wu, Nk)))
    return torch.stack(G4), PPB, PairPPB


class LineGroup(NamedTuple):
    """One group of a LineTable: its atom ``ai`` (index into the active
    atoms), member transitions, size, window, level statics (the atom's
    own level indices), the atom's first row ``levOff`` and level count
    ``nLev`` in the stacked populations and continuum rows, and its
    element offsets into the packed inputs and outputs."""
    ai: int
    members: Tuple[int, ...]
    K: int
    row0: int
    Wu: int
    nBlk: int
    statics: GroupStatics
    levOff: int
    nLev: int
    phiOff: int
    coefOff: int
    wphiOff: int
    rhoOff: int
    g4Off: int
    ppbOff: int
    pairOff: int


def _masks(st: GroupStatics):
    """csrc/gamma.cu:LineGroup.masks: per member m, three int32 words whose
    bit m2 of the low / high 16 bits says: word 0, member m2's chi enters
    member m's chi_i with + / -; word 1, the same for chi_j; word 2, member
    m2's Uji is in U_i / U_j."""
    def word(lo, hi):
        w = sum(int(b) << m2 for m2, b in enumerate(lo)) \
            | sum(int(b) << (16 + m2) for m2, b in enumerate(hi))
        return w - (1 << 32) if w >= 1 << 31 else w
    out = []
    for signs, uIn in zip(st.signs, st.uIn):
        out += [word([sI > 0 for sI, _ in signs], [sI < 0 for sI, _ in signs]),
                word([sJ > 0 for _, sJ in signs], [sJ < 0 for _, sJ in signs]),
                word([i for i, _ in uIn], [j for _, j in uIn])]
    return out + [0] * (3 * KMAX - len(out))


def _flat(xs):
    return xs[0].reshape(-1) if len(xs) == 1 else torch.cat(
        [x.reshape(-1) for x in xs])


class LineTable:
    """The line groups of the active atoms packed for one launch (module
    docstring).  Built once per Context (context.py:line_pack):

    groups      tuple of LineGroup
    phi, coef, wphi, rho   the groups' [K, 2, Wu, Nmu, Nk], [K, Wu, 4],
                [K, Nk] and [K, Wu, Nk] flattened end to end; rho holds
                ones, and the caller writes a PRD member's window per call
    meta        int32 [nGroups, 24], the kernel's group table
    items       int32 [nItems, 3], (group, row block, depth tile) per
                thread block
    sizes       (G4, PPB, PairPPB) element counts of the packed outputs
    """

    def __init__(self, groups, nLevels, Nmu, Nk):
        """groups: dicts with 'ai', 'members', 'row0', 'phi', 'coef',
        'wphi' and 'statics' (the layouts above); nLevels: the level count
        of each active atom."""
        if not groups:
            raise ValueError('a line table needs at least one group')
        self.Nmu, self.Nk = Nmu, Nk
        self.levOffs = [sum(nLevels[:ai]) for ai in range(len(nLevels))]
        self.nLev = sum(nLevels)
        self.nAtoms = len(nLevels)
        offs = dict.fromkeys(('phi', 'coef', 'wphi', 'rho', 'g4', 'ppb',
                              'pair'), 0)
        entries = []
        for g in groups:
            K, _, Wu = g['phi'].shape[:3]
            if not 1 <= K <= KMAX:
                raise ValueError(f'a line group of {K} members is outside '
                                 f'the kernel (1..{KMAX})')
            nBlk = -(-Wu // BW)
            ai = g['ai']
            entries.append(LineGroup(
                ai, tuple(g['members']), K, g['row0'], Wu, nBlk,
                g['statics'], self.levOffs[ai], nLevels[ai],
                *(offs[k] for k in offs)))
            for key, size in (('phi', K * 2 * Wu * Nmu * Nk),
                              ('coef', K * Wu * 4), ('wphi', K * Nk),
                              ('rho', K * Wu * Nk), ('g4', K * 4 * nBlk * Nk),
                              ('ppb', K * Wu * Nk),
                              ('pair', max(1, K * (K - 1) // 2) * Wu * Nk)):
                offs[key] += size
        if max(offs.values()) >= 2 ** 31:
            key = max(offs, key=offs.get)
            raise ValueError(f'the packed line {key} has {offs[key]} '
                             'elements, past the 2^31 - 1 of the kernel\'s '
                             'int32 offsets; split the batch of columns')
        self.groups = tuple(entries)
        self.phi = _flat([g['phi'] for g in groups])
        self.coef = _flat([g['coef'] for g in groups])
        self.wphi = _flat([g['wphi'] for g in groups])
        self.rho = self.phi.new_ones(offs['rho'])
        self.sizes = (offs['g4'], offs['ppb'], offs['pair'])
        meta, items = [], []
        for gi, e in enumerate(self.groups):
            levels = [e.levOff + lv for ij in e.statics.levels for lv in ij]
            meta += ([e.K, e.row0, e.Wu, e.nBlk, e.ai, e.phiOff, e.coefOff,
                      e.wphiOff, e.rhoOff, e.g4Off, e.ppbOff, e.pairOff]
                     + levels + [0] * (2 * KMAX - len(levels))
                     + _masks(e.statics))
        # the largest groups' blocks first: they run longest
        for gi in sorted(range(len(entries)), key=lambda i: -entries[i].K):
            items += [(gi, b, t) for b in range(entries[gi].nBlk)
                      for t in range(-(-Nk // TK))]
        dev = self.phi.device
        self.meta = torch.tensor(meta, dtype=torch.int32,
                                 device=dev).view(-1, _META)
        self.items = torch.tensor(items, dtype=torch.int32, device=dev)
        self.nItems = len(items)
        self.maxK = max(e.K for e in entries)

    def to(self, dtype):
        """A copy with the packed floating inputs in ``dtype`` (the same
        groups, offsets and work items)."""
        t = copy.copy(self)
        t.phi, t.coef, t.wphi, t.rho = (x.to(dtype) for x in (
            self.phi, self.coef, self.wphi, self.rho))
        return t

    def inputs(self, gi, rho=None):
        """Group ``gi``'s views (phi, rho, coef, wphi) into the packed
        inputs; rho into ``rho`` (default: the table's buffer)."""
        e = self.groups[gi]
        rho = self.rho if rho is None else rho
        K, Wu, Nmu, Nk = e.K, e.Wu, self.Nmu, self.Nk
        return (self.phi[e.phiOff:e.phiOff + K * 2 * Wu * Nmu * Nk]
                .view(K, 2, Wu, Nmu, Nk),
                rho[e.rhoOff:e.rhoOff + K * Wu * Nk].view(K, Wu, Nk),
                self.coef[e.coefOff:e.coefOff + K * Wu * 4].view(K, Wu, 4),
                self.wphi[e.wphiOff:e.wphiOff + K * Nk].view(K, Nk))

    def views(self, G4, PPB, PairPPB):
        """Per group, its (G4 [K, 4, nBlk, Nk], PPB [K, Wu, Nk], PairPPB
        [max(P, 1), Wu, Nk]) views into the packed outputs."""
        out = []
        for e in self.groups:
            K, Wu, Nk = e.K, e.Wu, self.Nk
            P = max(1, K * (K - 1) // 2)
            out.append((
                G4[e.g4Off:e.g4Off + K * 4 * e.nBlk * Nk]
                .view(K, 4, e.nBlk, Nk),
                PPB[e.ppbOff:e.ppbOff + K * Wu * Nk].view(K, Wu, Nk),
                PairPPB[e.pairOff:e.pairOff + P * Wu * Nk].view(P, Wu, Nk)))
        return out

    def group_args(self, gi, rho, Psi, IeffBase, I, srcNum, chiCL, UCL, etaC,
                   n, wmuHalf):
        """The arguments of group_gamma_rates for group ``gi`` of one call
        of line_gamma_rates (its atom's rows of the stacked inputs)."""
        e = self.groups[gi]
        phi, rhoG, coef, wphi = self.inputs(gi, rho)
        lev = slice(e.levOff, e.levOff + e.nLev)
        return (phi, rhoG, Psi, IeffBase, I, srcNum, chiCL[lev], UCL[lev],
                etaC[e.ai], n[lev], coef, wphi, wmuHalf, e.statics, e.row0)


def _check_line_inputs(table, rho, Psi, IeffBase, I, srcNum, chiCL, UCL,
                       etaC, n, wmuHalf):
    Nmu, Nk = table.Nmu, table.Nk
    if Psi.dim() != 4 or Psi.shape[0] != 2 or tuple(Psi.shape[2:]) != (
            Nmu, Nk):
        raise ValueError(f'Psi must be [2, Nlam, {Nmu}, {Nk}], got '
                         f'{tuple(Psi.shape)}')
    Nlam = Psi.shape[1]
    check_ray_elements(Psi, 'Psi')
    if any(e.row0 < 0 or e.row0 + e.Wu > Nlam for e in table.groups):
        raise ValueError(f'a group window lies outside the {Nlam} '
                         'wavelength rows')
    shapes = {'rho': (rho, table.rho.shape), 'IeffBase': (IeffBase,
                                                          Psi.shape),
              'I': (I, Psi.shape), 'srcNum': (srcNum, Psi.shape),
              'chiCL': (chiCL, (table.nLev, Nlam, Nk)),
              'UCL': (UCL, (table.nLev, Nlam, Nk)),
              'etaC': (etaC, (table.nAtoms, Nlam, Nk)),
              'n': (n, (table.nLev, Nk)), 'wmuHalf': (wmuHalf, (Nmu,)),
              'table.phi': (table.phi, table.phi.shape)}
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f'{name} must be {tuple(shape)}, got '
                             f'{tuple(x.shape)}')
        if x.device != Psi.device or x.dtype != Psi.dtype:
            raise ValueError(f'{name} is {x.dtype} on {x.device}, Psi is '
                             f'{Psi.dtype} on {Psi.device}')


def line_gamma_rates_plain(table, rho, Psi, IeffBase, I, srcNum, chiCL, UCL,
                           etaC, n, wmuHalf):
    """Plain PyTorch version of the packed kernel: group_gamma_rates_plain
    of every group written into the packed outputs."""
    G4, PPB, PairPPB = (Psi.new_zeros(s) for s in table.sizes)
    for gi, dst in enumerate(table.views(G4, PPB, PairPPB)):
        out = group_gamma_rates_plain(*table.group_args(
            gi, rho, Psi, IeffBase, I, srcNum, chiCL, UCL, etaC, n, wmuHalf))
        for d, o in zip(dst, out):
            d.copy_(o)
    return G4, PPB, PairPPB


def line_gamma_rates(table, rho, Psi, IeffBase, I, srcNum, chiCL, UCL, etaC,
                     n, wmuHalf):
    """The packed G4, PPB, PairPPB of every group of ``table`` (module
    docstring; ``table.views`` cuts them per group).  chiCL/UCL
    [nLev, Nlam, Nk], etaC [nAtoms, Nlam, Nk] and n [nLev, Nk] stack the
    active atoms' rows; rho is the table's packed layout.  On the CPU this
    is the plain PyTorch version; on a CUDA device it launches the
    instance of csrc/gamma.cu for the dtype (float64 or float32) once, or
    raises."""
    args = (table, rho, Psi, IeffBase, I, srcNum, chiCL, UCL, etaC, n,
            wmuHalf)
    _check_line_inputs(*args)
    if Psi.device.type == 'cpu':
        return line_gamma_rates_plain(*args)
    if Psi.device.type != 'cuda':
        raise RuntimeError(f'no line Gamma kernel for device {Psi.device}')
    return line_gamma_rates_cuda(*args)


def load_library():
    """Build csrc/gamma.cu with nvcc (once per source hash) and load it."""
    sig = [_build.PTR] * 18 + [_build.INT] * 5 + [_build.PTR]
    return _build.load('gamma', {'lw_line_gamma_f64': sig,
                                 'lw_line_gamma_f32': sig})


def line_gamma_rates_cuda(table, rho, Psi, IeffBase, I, srcNum, chiCL, UCL,
                          etaC, n, wmuHalf):
    """Launch the packed kernel's instance for Psi's dtype once for every
    group; ``line_gamma_rates_cuda.launches`` counts the float64 launches,
    ``.launches_f32`` the float32 ones."""
    if not Psi.is_cuda:
        raise ValueError(f'line_gamma_rates_cuda takes CUDA tensors, got '
                         f'{Psi.device}')
    if Psi.dtype not in (torch.float64, torch.float32):
        raise TypeError(f'the line Gamma kernel is instantiated for float64 '
                        f'and float32, got {Psi.dtype}')
    f32 = Psi.dtype == torch.float32
    ins = (table.phi, rho, Psi, IeffBase, I, srcNum, chiCL, UCL, etaC, n,
           table.coef, table.wphi, wmuHalf)
    if not all(x.is_contiguous() for x in ins):
        raise ValueError('the line Gamma kernel takes contiguous tensors')
    G4, PPB, PairPPB = (Psi.new_empty(s) for s in table.sizes)
    lib = load_library()
    err = (lib.lw_line_gamma_f32 if f32 else lib.lw_line_gamma_f64)(
        *(x.data_ptr() for x in ins), G4.data_ptr(), PPB.data_ptr(),
        PairPPB.data_ptr(), table.meta.data_ptr(), table.items.data_ptr(),
        table.nItems, table.maxK, Psi.shape[1], table.Nmu, table.Nk,
        _build.cuda_stream(Psi))
    _build.check_launch(err, 'line Gamma')
    if f32:
        line_gamma_rates_cuda.launches_f32 += 1
    else:
        line_gamma_rates_cuda.launches += 1
    return G4, PPB, PairPPB


line_gamma_rates_cuda.launches = 0
line_gamma_rates_cuda.launches_f32 = 0


def _check_inputs(phi, rho, Psi, IeffBase, I, srcNum, chiCL, UCL, etaC, n,
                  coef, wphi, wmuHalf, st, row0):
    if phi.dim() != 5 or phi.shape[1] != 2:
        raise ValueError(f'phi must be [K, 2, Wu, Nmu, Nk], got '
                         f'{tuple(phi.shape)}')
    K, _, Wu, Nmu, Nk = phi.shape
    Nlam = Psi.shape[1]
    Nlev = n.shape[0]
    if not 1 <= K <= KMAX:
        raise ValueError(f'a line group of {K} members is outside the '
                         f'kernel (1..{KMAX})')
    if not (0 <= row0 and row0 + Wu <= Nlam):
        raise ValueError(f'window [{row0}, {row0 + Wu}) outside the '
                         f'{Nlam} wavelength rows')
    if len(st.levels) != K or any(not (0 <= lv < Nlev)
                                  for ij in st.levels for lv in ij):
        raise ValueError(f'levels {st.levels} do not fit K={K}, Nlev={Nlev}')
    shapes = {'rho': (rho, (K, Wu, Nk)), 'IeffBase': (IeffBase, Psi.shape),
              'I': (I, Psi.shape), 'srcNum': (srcNum, Psi.shape),
              'Psi': (Psi, (2, Nlam, Nmu, Nk)),
              'chiCL': (chiCL, (Nlev, Nlam, Nk)),
              'UCL': (UCL, (Nlev, Nlam, Nk)), 'etaC': (etaC, (Nlam, Nk)),
              'n': (n, (Nlev, Nk)), 'coef': (coef, (K, Wu, 4)),
              'wphi': (wphi, (K, Nk)), 'wmuHalf': (wmuHalf, (Nmu,))}
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f'{name} must be {tuple(shape)}, got '
                             f'{tuple(x.shape)}')
        if x.device != phi.device or x.dtype != phi.dtype:
            raise ValueError(f'{name} is {x.dtype} on {x.device}, phi is '
                             f'{phi.dtype} on {phi.device}')


def group_gamma_rates(phi, rho, Psi, IeffBase, I, srcNum, chiCL, UCL, etaC,
                      n, coef, wphi, wmuHalf, st: GroupStatics, row0: int):
    """G4, PPB, PairPPB of one line group (module docstring).  On the CPU
    this is the plain PyTorch version; on a CUDA device it launches the
    packed kernel on a one-group table, or raises."""
    args = (phi, rho, Psi, IeffBase, I, srcNum, chiCL, UCL, etaC, n, coef,
            wphi, wmuHalf, st, row0)
    _check_inputs(*args)
    if phi.device.type == 'cpu':
        return group_gamma_rates_plain(*args)
    if phi.device.type != 'cuda':
        raise RuntimeError(f'no line Gamma kernel for device {phi.device}')
    return group_gamma_rates_cuda(*args)


def group_gamma_rates_cuda(phi, rho, Psi, IeffBase, I, srcNum, chiCL, UCL,
                           etaC, n, coef, wphi, wmuHalf, st: GroupStatics,
                           row0: int):
    """One group through line_gamma_rates_cuda (one launch, counted
    there): a one-group table over this group's tensors."""
    if not phi.is_cuda:
        raise ValueError(f'group_gamma_rates_cuda takes CUDA tensors, got '
                         f'{phi.device}')
    table = LineTable([{'ai': 0, 'members': tuple(range(phi.shape[0])),
                        'row0': row0, 'phi': phi.contiguous(),
                        'coef': coef.contiguous(),
                        'wphi': wphi.contiguous(), 'statics': st}],
                      [n.shape[0]], phi.shape[3], phi.shape[4])
    out = line_gamma_rates_cuda(table, rho.contiguous().reshape(-1), Psi,
                                IeffBase, I, srcNum, chiCL, UCL, etaC[None],
                                n, wmuHalf)
    return table.views(*out)[0]
