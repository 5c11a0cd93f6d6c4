"""lightweaver_tpu_torch never imports jax, directly or through
lightweaver_tpu: the machine with the GPU has no jax.

A fresh interpreter imports the port (the model layer's eos, crtaf,
rh_format and the benchmark module too), builds the falc_h6ca Context on
the CPU, runs one iteration of each loop, solves the Saha EOS (its
native core) and checks sys.modules.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_SCRIPT = """
import sys
import numpy as np
from lightweaver_tpu_torch.fal import Falc82
from lightweaver_tpu_torch.problems import h6ca_context
import lightweaver_tpu_torch.convert
import lightweaver_tpu_torch.crtaf
import lightweaver_tpu_torch.rh_format
from lightweaver_tpu_torch import benchmark
from lightweaver_tpu_torch.eos import SahaEos
ctx = h6ca_context(Falc82(), 5, device='cpu')
ctx.formal_sol_gamma_matrices()
ctx.stat_equil()
ctx.iterate_on_device(NmaxIter=1)
SahaEos().solve(np.array([6000.0]), np.array([1e4]))
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))
             or m == 'lightweaver_tpu' or m.startswith('lightweaver_tpu.'))
print('LOADED', bad)
"""


def test_port_runs_without_jax():
    # one intra-op thread: the tier-1 run has six pytest workers
    env = dict(os.environ, OMP_NUM_THREADS='1')
    res = subprocess.run([sys.executable, '-c', _SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert 'LOADED []' in res.stdout, res.stdout


def test_no_jax_import_in_the_port():
    """No line of the package imports jax or lightweaver_tpu, not even
    lazily inside a function."""
    pat = re.compile(r'^\s*(import|from)\s+(jax|jaxlib|lightweaver_tpu)\b')
    for path in (ROOT / 'lightweaver_tpu_torch').rglob('*.py'):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            assert not pat.match(line), f'{path}:{n}: {line}'
