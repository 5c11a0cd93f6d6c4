"""Newton-Raphson charge conservation: coupled (populations, ne) update.

Port of lightweaver_tpu/nr_update.py: the per-depth (sum(Nlevel)+1)^2
Jacobian is assembled as one dense tensor batched over depth and solved
with ops/linalg.py's unrolled Gaussian elimination, as the JAX package
does (ref: lightweaver/nr_update.py:7-106,
Source/UpdatePopulations.cpp:230-394).

The Jacobian rows are: per-level kinetic equations (Gamma blocks, with
the last level of each atom replaced by particle conservation), and a
final charge-conservation row ne - sum(stages * n) - backgroundNe.  The
ne column carries the preconditioned continuum photoionisation derivative
(Gamma_ij - crsw*C_ij)/ne * n_j plus the finite-difference dC/dne terms
that the Context supplies (Context._fd_dC, a 1e-4 relative ne
perturbation).
"""
from typing import Sequence, Tuple

import numpy as np
import torch

from .ops.linalg import batched_solve


def build_nr_fn(Nlevels: Sequence[int], stagesList: Sequence[np.ndarray],
                contPairs: Sequence[Sequence[Tuple[int, int]]],
                timeDep: bool, dtype=torch.float64, stepLimit: bool = True):
    """Build the batched NR step for a static atom structure.

    Nlevels: per-atom level counts; stagesList: per-atom ionisation stages
    [Nl]; contPairs: per-atom list of continuum (i, j) level pairs.
    stepLimit: scale the step so that no population or ne falls below 10%
    of its value (the JAX package's default); False takes the reference's
    raw Newton step (nr_post_update_impl, UpdatePopulations.cpp:292-395).
    Returns fn(Gammas, ns, nTotals, Cs, dCs, ne, backgroundNe, crsw
               [, dt, nPrevs]) -> (newNs, newNe), every tensor in ``dtype``
    on the device of ``ne``; crsw and dt may be floats.
    """
    Natom = len(Nlevels)
    Neqn = sum(Nlevels) + 1
    theta = 1.0

    def fn(Gammas, ns, nTotals, Cs, dCs, ne, backgroundNe, crsw,
           dt=None, nPrevs=None):
        Nk = ne.shape[0]
        dev = ne.device
        F = torch.zeros((Nk, Neqn), dtype=dtype, device=dev)
        dF = torch.zeros((Nk, Neqn, Neqn), dtype=dtype, device=dev)
        eleContrib = torch.zeros(Nk, dtype=dtype, device=dev)

        offset = 0
        for a in range(Natom):
            Nl = Nlevels[a]
            stages = torch.as_tensor(np.asarray(stagesList[a]), dtype=dtype,
                                     device=dev)
            G = Gammas[a]                                   # [Nl, Nl, Nk]
            n = ns[a]                                       # [Nl, Nk]
            Gn = torch.einsum('ijk,jk->ik', G, n)           # [Nl, Nk]
            if timeDep:
                Fa = theta * dt * Gn - (n - nPrevs[a])
            else:
                Fa = -Gn
            Fa = Fa.clone()
            Fa[Nl - 1] = torch.sum(n, dim=0) - nTotals[a]
            F[:, offset:offset + Nl] = Fa.T
            eleContrib = eleContrib + torch.einsum('l,lk->k', stages, n)

            # Jacobian block [Nk, Nl, Nl]
            blk = -torch.movedim(G, -1, 0)
            if timeDep:
                blk = -theta * dt * blk
                blk = blk - torch.eye(Nl, dtype=dtype, device=dev)[None]
            blk = blk.clone()

            # ne column: continuum Rji/ne precondition + FD dC/dne
            neCol = torch.zeros((Nl, Nk), dtype=dtype, device=dev)
            for (i, j) in contPairs[a]:
                precon = G[i, j] - crsw * Cs[a][i, j]
                entry = -(precon / ne) * n[j]
                if timeDep:
                    entry = -theta * dt * entry
                neCol[i] += entry
            if dCs is not None:
                entry = -torch.einsum('ilk,lk->ik', dCs[a], n)
                if timeDep:
                    entry = -theta * dt * entry
                neCol = neCol + entry

            # particle-conservation row for this atom: 1s, no ne coupling
            blk[:, Nl - 1, :] = 1.0
            neCol[Nl - 1] = 0.0

            dF[:, offset:offset + Nl, offset:offset + Nl] = blk
            dF[:, offset:offset + Nl, Neqn - 1] = neCol.T
            dF[:, Neqn - 1, offset:offset + Nl] = -stages[None, :]
            offset += Nl

        F[:, Neqn - 1] = ne - eleContrib - backgroundNe
        dF[:, Neqn - 1, Neqn - 1] = 1.0

        delta = batched_solve(dF, -F)                       # [Nk, Neqn]

        if stepLimit:
            # positivity-preserving step limiting: scale the whole Newton
            # step per depth point so no population (or ne) is driven
            # below 10% of its current value (full steps near the
            # solution)
            x = torch.cat([torch.movedim(n, -1, 0) for n in ns]
                          + [ne[:, None]], dim=1)           # [Nk, Neqn]
            inf = torch.full((), torch.inf, dtype=dtype, device=dev)
            neg, pos = delta < 0.0, delta > 0.0
            shrinkRatio = torch.where(
                neg, -x / torch.where(neg, delta, -1.0), inf)
            growthRatio = torch.where(
                pos, 9.0 * x / torch.where(pos, delta, 1.0), inf)
            s = torch.clamp(torch.minimum(
                0.9 * torch.amin(shrinkRatio, dim=1),
                torch.amin(growthRatio, dim=1)), max=1.0)
            delta = delta * s[:, None]

        newNs = []
        offset = 0
        for a in range(Natom):
            Nl = Nlevels[a]
            newNs.append(ns[a] + delta[:, offset:offset + Nl].T)
            offset += Nl
        newNe = ne + delta[:, Neqn - 1]
        return newNs, newNe

    return fn
