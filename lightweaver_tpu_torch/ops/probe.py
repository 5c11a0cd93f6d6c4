"""Toolchain probes: the counterparts of scripts/pallas_probe.py's two
Pallas kernels, built from ``csrc/probe.cu``.

``elementwise(x)`` is o = 2x + 1; ``recurrence(a, b)`` is
o_k = a_k o_{k-1} + b_k down the rows of [rows, cols] tensors from
o_{-1} = 0.  Both are float32, as the TPU probes are.  On the CPU each
is its plain PyTorch version; on a CUDA tensor it launches the kernel or
raises.
"""
import torch

from . import _build


def elementwise_plain(x):
    return x * 2.0 + 1.0


def recurrence_plain(a, b):
    """The recurrence as a Python loop over the rows."""
    carry = torch.zeros_like(a[0])
    rows = []
    for k in range(a.shape[0]):
        carry = a[k] * carry + b[k]
        rows.append(carry)
    return torch.stack(rows)


def load_library():
    return _build.load('probe', {
        'lw_probe_elementwise_f32': [_build.PTR] * 2 + [_build.INT,
                                                        _build.PTR],
        'lw_probe_recurrence_f32': [_build.PTR] * 3 + [_build.INT] * 2
        + [_build.PTR]})


def _check(*xs):
    for x in xs:
        if x.dtype != torch.float32:
            raise TypeError(f'the probes are float32 kernels, got {x.dtype}')
        if not x.is_contiguous():
            raise ValueError('the probes take contiguous tensors')
        if x.device != xs[0].device:
            raise ValueError('all tensors must be on one device')
    if xs[0].device.type not in ('cpu', 'cuda'):
        raise RuntimeError(f'no probe kernel for device {xs[0].device}')


def elementwise(x):
    _check(x)
    if x.device.type == 'cpu':
        return elementwise_plain(x)
    return elementwise_cuda(x)


def recurrence(a, b):
    _check(a, b)
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f'a and b must be one [rows, cols] shape, got '
                         f'{tuple(a.shape)} and {tuple(b.shape)}')
    if a.device.type == 'cpu':
        return recurrence_plain(a, b)
    return recurrence_cuda(a, b)


def elementwise_cuda(x):
    """Launch the elementwise probe; ``elementwise_cuda.launches`` counts
    the launches."""
    if not x.is_cuda:
        raise ValueError(f'elementwise_cuda takes CUDA tensors, got '
                         f'{x.device}')
    o = torch.empty_like(x)
    err = load_library().lw_probe_elementwise_f32(
        x.data_ptr(), o.data_ptr(), x.numel(), _build.cuda_stream(x))
    _build.check_launch(err, 'elementwise probe')
    elementwise_cuda.launches += 1
    return o


def recurrence_cuda(a, b):
    """Launch the recurrence probe; ``recurrence_cuda.launches`` counts
    the launches."""
    if not a.is_cuda:
        raise ValueError(f'recurrence_cuda takes CUDA tensors, got '
                         f'{a.device}')
    o = torch.empty_like(a)
    rows, cols = a.shape
    err = load_library().lw_probe_recurrence_f32(
        a.data_ptr(), b.data_ptr(), o.data_ptr(), rows, cols,
        _build.cuda_stream(a))
    _build.check_launch(err, 'recurrence probe')
    recurrence_cuda.launches += 1
    return o


elementwise_cuda.launches = 0
recurrence_cuda.launches = 0
