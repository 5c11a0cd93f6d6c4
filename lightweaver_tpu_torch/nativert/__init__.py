"""Native host-side runtime components (C++ via ctypes).

The loader of lightweaver_tpu/nativert with one change: the library is
built with the system compiler at first use into the port's build
directory (ops/_build.py:BUILD_DIR, which git ignores), not next to the
sources.  saha_eos.cpp is the JAX package's, byte for byte but for the
reference-path prefix of its ref comment.
Every consumer keeps its pure-numpy path (eos.py), so the package works
without a toolchain.
"""
import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR

_DIR = Path(__file__).resolve().parent
_LIB_PATH = BUILD_DIR / 'libsaha_eos.so'
_lib = None
_buildFailed = False


def _build() -> bool:
    src = _DIR / 'saha_eos.cpp'
    # a private file renamed into place: concurrent first uses (test
    # workers) never load a half-written library
    tmp = _LIB_PATH.with_suffix(f'.{os.getpid()}.tmp')
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ['g++', '-O3', '-shared', '-fPIC', str(src), '-o', str(tmp)],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except Exception:
        return False


def load_saha_lib():
    """ctypes handle to the native EOS core, or None if unavailable."""
    global _lib, _buildFailed
    if _lib is not None:
        return _lib
    if _buildFailed:
        return None
    if not _LIB_PATH.exists() or (_LIB_PATH.stat().st_mtime
                                  < (_DIR / 'saha_eos.cpp').stat().st_mtime):
        if not _build():
            _buildFailed = True
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        _buildFailed = True
        return None
    d = np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS')
    i32 = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
    lib.saha_solve.restype = ctypes.c_int
    lib.saha_solve.argtypes = [
        d, d, ctypes.c_int64,                       # T, pgas, N
        ctypes.c_int32, i32,                        # Nelem, nStages
        d, d,                                       # abund, ionPot
        d, ctypes.c_int32, d,                       # Tpf, Npf, logU
        ctypes.c_int32,                             # maxStage
        ctypes.c_double, ctypes.c_double,           # totalAbund, massPerH
        ctypes.c_int32, ctypes.c_double,            # maxIter, tol
        d, d, d,                                    # ne, nHTot, rho out
    ]
    _lib = lib
    return _lib
