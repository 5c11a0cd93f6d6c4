"""The sweep and fused kernels at one column against another tree's, bit
for bit, on one card.

    python3 scripts/torch_column_bits.py --other TREE

TREE holds the other lightweaver_tpu_torch and the lightweaver_tpu/data it
reads (git archive COMMIT lightweaver_tpu_torch lightweaver_tpu/data).

Each tree (this checkout and ``--other``, e.g. a parent commit unpacked
with ``git archive`` into a directory that .gitignore lists) runs in its
own process: it builds its kernels, launches every sweep instance (three
solvers x float64, float32) on 1046 x 5 x 2 random rays of 82 depths and
the fused kernel (float64, float32) on two random slots with each boundary
kind at each end (problems.random_rays, random_slots, random_boundaries,
numpy seeds), and saves every output.  The two trees' outputs must be
equal bit for bit: the column axis of the kernels leaves a single column's
arithmetic as it was.  Prints one line per output set and exits non-zero
on any difference.  Needs a CUDA device.
"""
import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

SOLVERS = ('piecewise_linear_1d', 'piecewise_bezier3_1d',
           'piecewise_besser_1d')
FUSED_BCS = (('zero', 'therm'), ('therm', 'data'), ('data', 'zero'))


def dump(root, out):
    """Run the kernels of the tree at ``root`` and save their outputs."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    from lightweaver_tpu_torch.ops import fused, sweep
    from lightweaver_tpu_torch.problems import (random_boundaries,
                                                random_rays, random_slots)
    res = {}

    def keep(key, o):
        for name, x in zip(('I', 'Psi', 'IeffBase'), o[:3]):
            res[f'{key} {name}'] = x.cpu().numpy()
        for name, x in o[3].items():
            res[f'{key} {name}'] = x.cpu().numpy()

    rays = random_rays(1046, 5, 82, seed=82)
    for dtype in (torch.float64, torch.float32):
        args = [torch.tensor(rays[k], dtype=dtype, device='cuda') for k in
                ('chi', 'srcNum', 'height', 'muz', 'IupwD', 'IupwU', 'wmu')]
        for solver in SOLVERS:
            keep(f'sweep {solver} {dtype}',
                 sweep.formal_solve_sweep(*args, solver=solver))
        s = random_slots(2, 1046, 5, 82, seed=17)
        rows = random_boundaries(1046, 5, seed=17)

        def t_(x):
            return torch.tensor(x, dtype=dtype, device='cuda')
        base = [t_(s[k]) for k in ('phiP', 'chiCo', 'etaCo', 'bgChi',
                                   'bgEta', 'scaJ', 'height', 'muz', 'wmu')]
        for bcs in FUSED_BCS:
            bc = [(kind, None if kind == 'zero' else t_(rows[kind]))
                  for kind in bcs]
            keep(f'fused {bcs} {dtype}', fused.fused_lambda_step(*base, *bc))
    torch.cuda.synchronize()
    np.savez(out, **res)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--other', required=True)
    ap.add_argument('--dump', help=argparse.SUPPRESS)
    ap.add_argument('--root', help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.dump:
        dump(a.root, a.dump)
        return
    here = Path(__file__).resolve().parents[1]
    with tempfile.TemporaryDirectory(dir=here / 'build') as tmp:
        files = []
        for root in (here, Path(a.other)):
            f = Path(tmp) / f'{len(files)}.npz'
            subprocess.run([sys.executable, __file__, '--other', a.other,
                            '--root', str(root), '--dump', str(f)],
                           check=True)
            files.append(np.load(f))
        ours, theirs = files
        bad = 0
        for key in sorted(ours.files):
            same = np.array_equal(ours[key], theirs[key], equal_nan=True)
            diff = 0.0 if same else float(np.abs(
                ours[key].astype(np.float64)
                - theirs[key].astype(np.float64)).max())
            print(f'{key}: {"bit for bit" if same else f"DIFFERS {diff:.3e}"}')
            bad += not same
        print(f'{len(ours.files) - bad} of {len(ours.files)} outputs equal '
              f'bit for bit')
    sys.exit(1 if bad or set(ours.files) != set(theirs.files) else 0)


if __name__ == '__main__':
    main()
