"""The collectives of the distributed paths (parallel/), on the group a
mesh dimension gives: all_reduce and all_gather only, which both the
'nccl' and the 'gloo' backend take on CUDA tensors.  A group of one rank
(or None without a process group) costs nothing: the tensor is returned
as it is."""
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def _group_size(group) -> int:
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def all_reduce(x: torch.Tensor, group, op: str = 'sum') -> torch.Tensor:
    """x reduced over the ranks of ``group`` ('sum', 'max' or 'min'), in
    place when x is contiguous; returns the reduced tensor."""
    if _group_size(group) == 1:
        return x
    y = x.contiguous().reshape(-1)
    dist.all_reduce(y, op={'sum': dist.ReduceOp.SUM, 'max': dist.ReduceOp.MAX,
                           'min': dist.ReduceOp.MIN}[op], group=group)
    return y.view(x.shape)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x of ``group`` stacked in group-rank order:
    [size, *x.shape] (x has the same shape on every rank)."""
    n = _group_size(group)
    if n == 1:
        return x[None]
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(out, x, group=group)
    return torch.stack(out)


def all_gather_cat(x: torch.Tensor, group, dim: int = 0,
                   sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Every rank's block of ``group`` concatenated along ``dim`` in
    group-rank order.  ``sizes``: each rank's extent along dim when they
    differ (the blocks are padded to the largest for the gather)."""
    n = _group_size(group)
    if n == 1:
        return x
    dim = dim % x.dim()
    if sizes is None:
        return torch.cat(list(all_gather(x, group)), dim=dim)
    pad = max(sizes) - x.shape[dim]
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    blocks = all_gather(x, group)
    return torch.cat([b.narrow(dim, 0, s) for b, s in zip(blocks, sizes)],
                     dim=dim)
