"""The least time the card could take for the formal solution of one MALI
step, from the problem's shapes alone.

The formal solution's work is the same whatever implements it (the
sweep kernel after the gather, the fused kernel, the 2D plane sweep in
torch ops, a future 2D kernel), so the count takes nothing from an
implementation's arguments:

- bytes: chi and the source numerator per (wavelength, point), read once;
  I and Psi per (wavelength, ray, point) and J per (wavelength, point),
  which the Gamma/rates stage reads next, written once.  A ray is one
  (mu, direction) pair: 2 Nmu of them.  Each value takes ``itemsize``
  bytes.  What an implementation moves beyond that (chi expanded over the
  rays, IeffBase and the other moments, re-reads) is its own cost.
- operations: SWEEP_FLOPS per (wavelength, ray, point), the count of
  chip_smoke.py for the Bezier-3 step with its moments (the linear step
  needs fewer, BESSER more: the count is a floor for both).

The least time is the larger of the bytes over the memory rate and the
operations over the peak rate of the working type (NVIDIA's H100 SXM data
sheet, outside the tensor cores; the card's power limit is printed
beside every reading).
"""
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'float64': 34e12, 'float32': 67e12}
ITEMSIZE = {'float64': 8, 'float32': 4}
# floating-point operations per (ray, point) of the Bezier-3 step and its
# moments (chip_smoke.py:SWEEP_FLOPS: two Steffen derivatives ~13 each,
# control points and dtau ~10, the weights ~30 with the exp, the
# recurrence ~20, Psi and IeffBase ~5, the moments ~8)
SWEEP_FLOPS = 100


def formal_solution_work(Nlam: int, Nmu: int, Nk: int,
                         dtype: str = 'float64') -> dict:
    """bytes, flops, the least seconds and what bounds them, for Nlam
    wavelengths, Nmu rays per direction and Nk points."""
    rays = 2 * Nmu
    nBytes = ITEMSIZE[dtype] * Nlam * Nk * (2 + 2 * rays + 1)
    flops = SWEEP_FLOPS * Nlam * rays * Nk
    tBytes = nBytes / HBM_BYTES_PER_S
    tOps = flops / PEAK_FLOPS[dtype]
    return {'bytes': nBytes, 'flops': flops, 'least_s': max(tBytes, tOps),
            'bound_by': 'bytes' if tBytes >= tOps else 'operations'}
