"""The readings that the check's limits are set from: the compared
numbers of one cell over several seeds in one process, of the program as
the configuration states it or, with --dtype float32, of the control
(the program's own float32 path).

    python3 lwbench/readings.py --workload <cell> --seconds <s> \
        [--dtype float32] --seeds <n> [<n> ...]

One JSON line per seed: the seed, the dtype, the numbers, correct,
set-up seconds and MALI steps.  The benchmark's own runs never run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--dtype', default=None, choices=('float64', 'float32'))
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    args = ap.parse_args(argv)

    from lwbench.harness import runner
    for seed in args.seeds:
        out = runner.run_cell(args.workload, seed, args.seconds, False,
                              dtype=args.dtype,
                              t0=time.perf_counter())
        print(json.dumps({
            'workload': args.workload, 'seed': seed,
            'dtype': args.dtype or 'config', 'correct': out['correct'],
            'numbers': {k: v['value'] for k, v in out['check'].items()},
            'steps': out['attempted'], 'metrics': out['metrics'],
            'memory_peak_bytes': out['device']['memory_peak_bytes']}),
            flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
