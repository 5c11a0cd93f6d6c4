"""Batched dense solves of the small per-depth population systems.

Port of lightweaver_tpu/ops/linalg.py: the same partial-pivot Gaussian
elimination, unrolled over the (static, 6-9) matrix dimension, every step
an elementwise select/multiply over the depth batch.  A singular system
gives non-finite results (0/0 pivots), which the caller turns into
ExplodingMatrixError.
ref: Source/UpdatePopulations.cpp:7-47,
     Source/LuSolve.cpp:1-132
"""
import torch


def batched_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A[k] x[k] = b[k] for a batch of small dense systems.

    A: [B, N, N], b: [B, N] -> x: [B, N].
    """
    B, N, _ = A.shape
    M = torch.cat([A, b[..., None]], dim=-1)            # [B, N, N+1]
    rowIdx = torch.arange(N, device=A.device)[None, :]
    batch = torch.arange(B, device=A.device)
    negInf = torch.full((), -torch.inf, dtype=A.dtype, device=A.device)

    for col in range(N):
        # partial pivot: strongest row at/below `col`
        mags = torch.where(rowIdx >= col, M[:, :, col].abs(), negInf)
        p = torch.argmax(mags, dim=1)                   # [B]

        # swap rows col <-> p (batched)
        rowCol = M[:, col, :].clone()                   # [B, N+1]
        M[:, col, :] = M[batch, p, :]
        isP = (rowIdx == p[:, None])[..., None]         # [B, N, 1]
        M = torch.where(isP, rowCol[:, None, :], M)

        # eliminate below
        piv = M[:, col, col][:, None]                   # [B, 1]
        factors = M[:, :, col] / piv                    # [B, N]
        below = (rowIdx > col)[..., None]
        M = torch.where(below,
                        M - factors[..., None] * M[:, col, :][:, None, :], M)

    # back substitution (unrolled)
    x = torch.zeros((B, N), dtype=M.dtype, device=M.device)
    for row in range(N - 1, -1, -1):
        acc = M[:, row, N]
        if row + 1 < N:
            acc = acc - torch.sum(M[:, row, row + 1:N] * x[:, row + 1:N],
                                  dim=1)
        x[:, row] = acc / M[:, row, row]
    return x


def solve_KxK_over_depth(G: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve G[:,:,k] x[:,k] = rhs[:,k] for each depth point k.
    G: [N, N, Nk], rhs: [N, Nk] -> [N, Nk]."""
    Gb = torch.movedim(G, -1, 0)
    rb = torch.movedim(rhs, -1, 0)
    return torch.movedim(batched_solve(Gb, rb), 0, -1)
