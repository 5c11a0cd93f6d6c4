"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 lwbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with --trace 1 its per-layer ones), ``device``, with --trace 1
``breakdown``, and last ``check``: each compared number with its limit,
which also close standard error.  Without a card, with fewer cards than
the cell asks for, or with a JAX module loaded once the run is over, it
exits non-zero and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the program's kernels build into build/lightweaver_tpu_torch/ of the
# checkout; any extension or Triton cache goes beside it, at fixed paths
for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                 ('TRITON_CACHE_DIR', 'triton')):
    os.environ[var] = str(ROOT / 'build' / 'lwbench' / sub)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from lwbench.harness import manifest, runner
    cell = manifest.load_cell(args.workload)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < cell.chips:
        print(f'{args.workload} needs {cell.chips} CUDA device(s); this '
              f'machine has {count}', file=sys.stderr)
        return 2
    out = runner.run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), t0=T0)
    bad = runner.jax_modules()
    if bad:
        print(f'JAX modules loaded in the run: {bad}', file=sys.stderr)
        return 3
    def num(x):
        return 'none' if x is None else f'{x:.6g}'
    for k, v in out['check'].items():
        print(f"check {k} {num(v['value'])} limit {num(v['limit'])}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
