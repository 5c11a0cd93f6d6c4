"""No module whose top-level name is jax, jaxlib, flax or lightweaver_tpu
is loaded by the harness, the program it drives or the reference; and
the run's own look compares top-level names whole."""
import os
import subprocess
import sys
import textwrap

from lwbench.harness import runner
from lwbench.harness.manifest import ROOT

SCRIPT = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    import runpy
    runpy.run_path(sys.argv[1] + '/lwbench/run.py', run_name='lwbench_run')
    from lwbench.harness import (check, inputs, manifest, program_trace,
                                 record, runner, spans, systems, trace,
                                 work)
    import lightweaver_tpu_torch.parallel
    from lightweaver_tpu_torch import atmosphere, atomic_set, context
    from lightweaver_tpu_torch import rh_atoms
    from lwbench.reference import crd, mali, problem
    import lwbench.readings
    for kind in ('column_batch', 'context_2d'):
        manifest.load_kind(kind)
    print('LOADED', runner.jax_modules())
""")


def test_no_jax_after_the_harness_imports():
    env = dict(os.environ, OMP_NUM_THREADS='1')
    res = subprocess.run([sys.executable, '-c', SCRIPT, str(ROOT)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert 'LOADED []' in res.stdout, res.stdout


def test_top_level_names_compared_whole(monkeypatch):
    for name in ('lightweaver_tpu_torch', 'lightweaver_tpu_torch.context',
                 'jaxtyping', 'flaxen'):
        monkeypatch.setitem(sys.modules, name, sys)
    assert runner.jax_modules() == []
    monkeypatch.setitem(sys.modules, 'lightweaver_tpu.context', sys)
    monkeypatch.setitem(sys.modules, 'jaxlib', sys)
    assert runner.jax_modules() == ['jaxlib', 'lightweaver_tpu.context']


def test_run_without_a_card_prints_no_result():
    """This machine's torch has no CUDA: exit code not 0, no result."""
    env = dict(os.environ, OMP_NUM_THREADS='1', CUDA_VISIBLE_DEVICES='')
    res = subprocess.run([sys.executable, 'lwbench/run.py', '--workload',
                          'cols512_default', '--seed', '7', '--seconds', '1',
                          '--trace', '0'], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ''
