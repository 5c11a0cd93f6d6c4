"""Iterations of the JAX package's on-device MALI loop on falc_h6ca, on the
CPU (float64).

    python3 scripts/jax_on_device_iterations.py

falc_h6ca is BASELINE config 1 (FAL-C, 82 depths, H 6-level + Ca II
active, 5 rays), built as tests/test_vs_reference_golden.py builds it,
driven by Context.iterate_on_device(NmaxIter=500) (JTol 5e-3, popsTol
1e-3).  Prints the iterations, dJ, dPops, the wall time and each active
atom's largest relative population difference from the golden run
(tests/golden/falc_h6ca_ref.npz).  chip_smoke.py phase 17 holds the port's
iterate_on_device on the card to this count.
"""
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)

from lightweaver_tpu.atomic_set import RadiativeSet  # noqa: E402
from lightweaver_tpu.context import Context  # noqa: E402
from lightweaver_tpu.fal import Falc82  # noqa: E402
from lightweaver_tpu.rh_atoms import CaII_atom, H_6_atom  # noqa: E402


def main():
    atmos = Falc82()
    atmos.quadrature(5)
    rs = RadiativeSet([H_6_atom(), CaII_atom()])
    rs.set_active('H', 'Ca')
    spect = rs.compute_wavelength_grid()
    ctx = Context(atmos, spect, rs.compute_eq_pops(atmos))
    t0 = time.perf_counter()
    nIter, dJ, dPops = ctx.iterate_on_device(NmaxIter=500)
    wall = time.perf_counter() - t0
    print(f'falc_h6ca iterate_on_device: {nIter} iterations, dJ {dJ:.4e}, '
          f'dPops {dPops:.4e}, {wall:.1f} s (compile included)')
    ref = np.load(ROOT / 'tests' / 'golden' / 'falc_h6ca_ref.npz')
    for ia, st in enumerate(ctx.popsState):
        n, g = np.asarray(st['n']), ref[f'out_pops_a{ia}']
        print(f'atom {ia}: populations within '
              f'{np.max(np.abs(n - g) / np.abs(g)):.3e} of golden '
              f'({int(ref["out_niter"][0])} iterations)')


if __name__ == '__main__':
    main()
