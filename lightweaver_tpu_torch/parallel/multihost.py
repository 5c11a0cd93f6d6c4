"""Multi-process runs: torch.distributed set-up and global meshes.

Port of lightweaver_tpu/parallel/multihost.py.  The JAX package starts
jax.distributed and lets one controller see every device of the slice;
here every rank is a process of its own (one per card, e.g. under
``torchrun``), joined by a torch.distributed process group, and the mesh
is a torch DeviceMesh over the ranks of that group.  Typical 1.5D
pipeline on N ranks:

    from lightweaver_tpu_torch.parallel import ColumnBatch, multihost as mh
    mh.initialize_multihost(backend='nccl')    # env:// under torchrun
    mesh = mh.global_mesh(nWavelength=1)       # every rank on 'columns'
    batch = ColumnBatch.from_stacked(..., mesh=mesh)   # global arrays
    batch.iterate()

Each rank takes its block of the columns (the mesh coordinate on
'columns'); the collectives are all_reduce, all_gather and broadcast
only, which both backends take on CUDA tensors.  The backend is the
caller's: 'nccl' on the cards, 'gloo' on the CPU (or for several ranks
sharing one card).
"""
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ('nccl', 'gloo')


def _local_rank() -> int:
    """This process's rank on its host: LOCAL_RANK (set by torchrun),
    else the global rank (0 without a process group)."""
    if 'LOCAL_RANK' in os.environ:
        return int(os.environ['LOCAL_RANK'])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device='cuda') -> torch.device:
    """The explicit device of this rank: 'cuda' (or a bare 'cuda' device)
    becomes cuda:{local_rank % device_count}; anything else is taken as
    given (device='cpu' for the CPU)."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for this rank (the default "
                               "device is 'cuda'; pass device='cpu' to run "
                               "on the CPU)")
        device = torch.device('cuda', _local_rank()
                              % torch.cuda.device_count())
    return device


def initialize_multihost(init_method: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: str = 'nccl') -> None:
    """Initialise the default torch.distributed process group (idempotent:
    a group that exists is kept).

    ``backend`` is 'nccl' or 'gloo', the caller's choice (nothing is tried
    in its place).  ``init_method`` defaults to 'env://' (MASTER_ADDR,
    MASTER_PORT, RANK and WORLD_SIZE, as torchrun sets them); give
    'tcp://host:port' or 'file://path' with num_processes and process_id
    otherwise.  num_processes=1 makes a one-rank group on an in-process
    store, so a launch script runs unchanged on one process.  Under
    'nccl' the rank's card (rank_device()) becomes the current device
    first."""
    if backend not in BACKENDS:
        raise ValueError(f'backend must be one of {BACKENDS}, '
                         f'got {backend!r}')
    if dist.is_initialized():
        return
    if backend == 'nccl':
        torch.cuda.set_device(rank_device())
    if num_processes == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        return
    kwargs = {}
    if num_processes is not None:
        kwargs['world_size'] = num_processes
    if process_id is not None:
        kwargs['rank'] = process_id
    dist.init_process_group(backend, init_method=init_method or 'env://',
                            **kwargs)


def global_mesh(nColumns: Optional[int] = None, nWavelength: int = 1,
                device='cuda'):
    """A ('columns', 'wavelength') DeviceMesh over every rank of the
    default group; nColumns defaults to every rank the wavelength axis
    does not take.  The JAX package's checks: a world size that
    nWavelength does not divide, or a mesh of another size, raises
    ValueError."""
    from .columns import make_mesh
    n = dist.get_world_size()
    if n % nWavelength != 0:
        raise ValueError(f'{n} ranks not divisible by '
                         f'nWavelength={nWavelength}')
    if nColumns is None:
        nColumns = n // nWavelength
    if nColumns * nWavelength != n:
        raise ValueError(f'mesh {nColumns}x{nWavelength} != {n} ranks')
    return make_mesh(nColumns, nWavelength, device=device)


def local_column_slice(nColumnsGlobal: int) -> slice:
    """The half-open range of global column indices of this rank: blocks
    of ceil(C / world size) columns in rank order (the block that
    ColumnBatch(mesh=global_mesh()) takes when the world size divides
    C)."""
    p = dist.get_rank() if dist.is_initialized() else 0
    n = dist.get_world_size() if dist.is_initialized() else 1
    per = -(-nColumnsGlobal // n)
    return slice(p * per, min((p + 1) * per, nColumnsGlobal))


def make_global_array(localArrays, mesh, placements: Sequence):
    """A DTensor over ``mesh`` from this rank's block (DTensor.from_local):
    ``placements`` holds one torch.distributed.tensor placement per mesh
    dimension (Shard(0) for the columns axis, Replicate() for the other),
    the counterpart of the JAX package's PartitionSpec.  Its
    full_tensor() is the global array on every rank."""
    from torch.distributed.tensor import DTensor
    device = (rank_device('cuda') if mesh.device_type == 'cuda'
              else torch.device(mesh.device_type))
    local = torch.as_tensor(np.asarray(localArrays), device=device)
    return DTensor.from_local(local, mesh, list(placements))
