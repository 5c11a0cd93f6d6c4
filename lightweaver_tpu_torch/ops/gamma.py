"""Line Gamma/rate accumulation per same-atom overlap group of lines
(iteration scheme 'mali_full_precond_pallas').

Counterpart of lightweaver_tpu/ops/pallas_gamma.py.  The CUDA kernel
``csrc/gamma.cu`` replaces the TPU kernel ``group_gamma_rates`` there; the
plain PyTorch version below computes the same function and is what runs
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

Layouts are the port's: ray tensors direction-major [2, Nlam, Nmu, Nk],
the group's profiles packed as [K, 2, Wu, Nmu, Nk] with zeros outside
each member's own window.  Where the JAX kernel takes S and chiTot, this
one takes srcNum (= S chiTot to one rounding), which the gather emits.

Two instances, float64 and float32 (the f32 state).  In float32 G4 holds
float partials of at most BW rows x 2 Nmu rays, as the TPU kernel's; the
caller finishes the lambda sum in float64.  A CUDA tensor launches the
instance of its dtype or raises.
"""
import ctypes
from typing import List, NamedTuple, Tuple

import torch

from . import _build

BW = 8         # rows per lambda block of G4
KMAX = 4       # largest group the kernel is instantiated for (Mg II's)


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
    """Whether the line Gamma kernel covers this configuration: float64
    or float32 (the two instances built), no hybrid PRD (its comoving-frame rho
    varies per ray, the kernel's per row) and no line group above KMAX
    members.  The port's Context refuses 2D and dense Gamma at
    construction, which are pallas_scheme_supported's other checks."""
    return (cfg.dtype in (torch.float64, torch.float32) and not cfg.hprd
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
    """Plain PyTorch version of the group kernel, in its order of terms
    (see the module docstring for the arguments and results)."""
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
    instance of csrc/gamma.cu for the dtype (float64 or float32) or
    raises."""
    args = (phi, rho, Psi, IeffBase, I, srcNum, chiCL, UCL, etaC, n, coef,
            wphi, wmuHalf, st, row0)
    _check_inputs(*args)
    if phi.device.type == 'cpu':
        return group_gamma_rates_plain(*args)
    if phi.device.type != 'cuda':
        raise RuntimeError(f'no line Gamma kernel for device {phi.device}')
    return group_gamma_rates_cuda(*args)


class _GroupStatics(ctypes.Structure):
    """csrc/gamma.cu:GroupStatics."""
    _fields_ = [('levels', (ctypes.c_int * 2) * KMAX),
                ('signs', ((ctypes.c_int * 2) * KMAX) * KMAX),
                ('uIn', ((ctypes.c_int * 2) * KMAX) * KMAX)]


def _c_statics(st: GroupStatics) -> _GroupStatics:
    c = _GroupStatics()
    for m, ij in enumerate(st.levels):
        c.levels[m][0], c.levels[m][1] = ij
        for m2 in range(len(st.levels)):
            c.signs[m][m2][0], c.signs[m][m2][1] = st.signs[m][m2]
            c.uIn[m][m2][0], c.uIn[m][m2][1] = st.uIn[m][m2]
    return c


def load_library():
    """Build csrc/gamma.cu with nvcc (once per source hash) and load it."""
    sig = [_build.PTR] * 16 + [_GroupStatics] + [_build.INT] * 7 + [_build.PTR]
    return _build.load('gamma', {'lw_group_gamma_f64': sig,
                                 'lw_group_gamma_f32': sig})


def group_gamma_rates_cuda(phi, rho, Psi, IeffBase, I, srcNum, chiCL, UCL,
                           etaC, n, coef, wphi, wmuHalf, st: GroupStatics,
                           row0: int):
    """Launch the group kernel's instance for phi's dtype;
    ``group_gamma_rates_cuda.launches`` counts the float64 launches,
    ``.launches_f32`` the float32 ones."""
    if not phi.is_cuda:
        raise ValueError(f'group_gamma_rates_cuda takes CUDA tensors, got '
                         f'{phi.device}')
    if phi.dtype not in (torch.float64, torch.float32):
        raise TypeError(f'the line Gamma kernel is instantiated for float64 '
                        f'and float32, got {phi.dtype}')
    f32 = phi.dtype == torch.float32
    ins = (phi, rho, Psi, IeffBase, I, srcNum, chiCL, UCL, etaC, n, coef,
           wphi, wmuHalf)
    if not all(x.is_contiguous() for x in ins):
        raise ValueError('the line Gamma kernel takes contiguous tensors')
    K, _, Wu, Nmu, Nk = phi.shape
    Nlam = Psi.shape[1]
    nBlk = -(-Wu // BW)
    P = max(1, K * (K - 1) // 2)
    G4 = phi.new_empty((K, 4, nBlk, Nk))
    PPB = phi.new_empty((K, Wu, Nk))
    PairPPB = (phi.new_zeros if K == 1 else phi.new_empty)((P, Wu, Nk))
    lib = load_library()
    err = (lib.lw_group_gamma_f32 if f32 else lib.lw_group_gamma_f64)(
        *(x.data_ptr() for x in ins), G4.data_ptr(), PPB.data_ptr(),
        PairPPB.data_ptr(), _c_statics(st), K, Nlam, Nmu, Nk, Wu, row0, BW,
        _build.cuda_stream(phi))
    _build.check_launch(err, 'line Gamma')
    if f32:
        group_gamma_rates_cuda.launches_f32 += 1
    else:
        group_gamma_rates_cuda.launches += 1
    return G4, PPB, PairPPB


group_gamma_rates_cuda.launches = 0
group_gamma_rates_cuda.launches_f32 = 0
