"""Build a CUDA source of ``csrc/`` with nvcc and load it through ctypes.

Each ``csrc/<name>.cu`` exposes plain C functions (``extern "C"``, every
one returning ``cudaGetLastError()`` as an int), so the shared library
is built without PyTorch's headers in seconds.  The library is built
into ``build/lightweaver_tpu_torch/`` (git ignores it), named by the hash
of the source, the local headers it includes and the flags, so an edit
rebuilds and an unchanged source is loaded from the cache.  nvcc's output
(ptxas registers and spills) is kept beside the library and is read back
on a cached load as well.

Nothing is built at import: the CPU never needs a kernel.
"""
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = (Path(__file__).resolve().parents[2] / 'build'
             / 'lightweaver_tpu_torch')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)

# (name, flags) -> (ctypes library, path of its nvcc log); one load per
# process
_LOADED = {}


def _source_bytes(path: Path, seen=None) -> bytes:
    """The source followed by every local header it includes, recursively
    (what the build's hash covers)."""
    seen = set() if seen is None else seen
    seen.add(path)
    text = path.read_bytes()
    out = [text]
    for inc in _INCLUDE.findall(text):
        dep = (path.parent / inc.decode()).resolve()
        if dep.exists() and dep not in seen:
            out.append(_source_bytes(dep, seen))
    return b'\n'.join(out)


def load(name: str, signatures: dict, flags=()) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` (once per hash) and load it.

    signatures: {C function name: list of ctypes argtypes}; every function
    returns a CUDA error code as ``c_int``.  flags: nvcc flags of this
    library after NVCC_FLAGS.  Raises RuntimeError when nvcc is missing
    or fails."""
    key = (name, tuple(flags))
    if key in _LOADED:
        return _LOADED[key][0]
    src = CSRC / f'{name}.cu'
    nvcc = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(nvcc):
        raise RuntimeError(f'nvcc not found: the CUDA kernel {src.name} is '
                           'built from source at first use')
    cmd = [*NVCC_FLAGS, *flags]
    tag = hashlib.sha256(_source_bytes(src)
                         + ' '.join(cmd).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f'{name}_{tag}.so'
    log = so.with_suffix('.log')
    if not so.exists():
        tmp = so.with_suffix(f'.{os.getpid()}.tmp')
        res = subprocess.run([nvcc, *cmd, '-o', str(tmp), str(src)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f'nvcc failed on {src}:\n'
                               f'{res.stdout}{res.stderr}')
        log.write_text(res.stdout + res.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _LOADED[key] = (lib, log)
    return lib


def library_path(name: str, flags=()) -> str:
    """The path of the loaded library ``name`` built with ``flags``."""
    return _LOADED[(name, tuple(flags))][0]._name


def build_log(name: str, flags=()) -> str:
    """nvcc's output for the loaded library ``name`` built with ``flags``
    ('' if not loaded)."""
    key = (name, tuple(flags))
    if key not in _LOADED:
        return ''
    log = _LOADED[key][1]
    return log.read_text() if log.exists() else ''


def check_launch(err: int, what: str):
    if err != 0:
        raise RuntimeError(f'{what} kernel launch failed: CUDA error {err}')


def cuda_stream(x):
    """PyTorch's current stream on the device of tensor ``x``, as an int."""
    with torch.cuda.device(x.device):
        return torch.cuda.current_stream().cuda_stream


PTR = ctypes.c_void_p
INT = ctypes.c_int
