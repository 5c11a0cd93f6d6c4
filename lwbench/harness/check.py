"""The comparison that decides ``correct``.

The reference (lwbench/reference, plain float64 torch written from the
published method) runs on the run's device once the window has closed
and the program's state is freed.  Per compared unit (the kind's
``check_units``: a column of the batch drawn from the seed, or the whole
slab) the kind's ``reference`` works out the unit's inputs from the
seed's inputs itself, and the check follows the program twice:

- first: from the reference's own start, the set-up's steps (Nscatter
  formal solutions and one MALI step), against the program's state after
  its warm-up, which ran through the same calls at the same sizes;
- last: from the state the program's last MALI step started from (the
  state its system kept before each step: J and the populations, and
  whatever else the kind's step starts from), that one step, against the
  program's state after it.

Each of the kind's ``NUMBERS`` (a name: the state's array or list of
arrays of that name, with the function comparing one array with the
reference's) is the worst over both and over the units.  The MALI
step's three (MALI_NUMBERS):

- J: per wavelength, the largest |J - J_ref| over the points over the
  largest |J_ref| (J spans decades across the grid);
- pops: the largest |n - n_ref| / n_ref over levels and points;
- Gamma: per point, the largest |Gamma - Gamma_ref| over the largest
  |Gamma_ref| of the point's matrix.

The cell's ``limits`` name the numbers it holds: a number without a
limit, or a limit without a number, is no correct run.
"""
import numpy as np


def rel_rows(x, ref):
    scale = np.abs(ref).max(axis=-1)
    return float((np.abs(x - ref).max(axis=-1)
                  / np.where(scale > 0, scale, 1.0)).max())


def rel_elems(x, ref):
    return float((np.abs(x - ref) / np.where(ref != 0, np.abs(ref), 1.0))
                 .max())


def rel_matrices(x, ref):
    scale = np.abs(ref).max(axis=(0, 1))
    return float((np.abs(x - ref).max(axis=(0, 1))
                  / np.where(scale > 0, scale, 1.0)).max())


MALI_NUMBERS = {'J': rel_rows, 'pops': rel_elems, 'Gamma': rel_matrices}


def compare(numbers: dict, state: dict, ref: dict) -> dict:
    """Each number of one program state against the reference's, the
    worst over a list's arrays; a state or shape that differs reads inf."""
    out = {}
    for name, fn in numbers.items():
        xs, rs = state.get(name), ref.get(name)
        if not isinstance(xs, list):
            xs, rs = [xs], [rs]
        if (not isinstance(rs, list) or len(xs) != len(rs)
                or any(x is None or r is None or x.shape != r.shape
                       for x, r in zip(xs, rs))):
            out[name] = float('inf')
        else:
            out[name] = max(fn(x, r) for x, r in zip(xs, rs))
    return out


def reference_numbers(kind, config: dict, traffic: dict, inputs: dict,
                      units, first, last, device) -> dict:
    """The worst of each of the kind's numbers over the compared units;
    ``first`` the program's states after its warm-up, ``last`` its
    (before, after) states of the last step, one per unit."""
    out = dict.fromkeys(kind.NUMBERS, 0.0)
    for u, (firstState, (before, after)) in enumerate(zip(first, last)):
        ref = kind.reference(config, inputs, u, units, device)
        state = ref.start()
        for _ in range(traffic['nscatter']):
            state = ref.scatter(state)
        got = [compare(kind.NUMBERS, firstState,
                       ref.compared(ref.step(state)))]
        got.append(compare(kind.NUMBERS, after,
                           ref.compared(ref.step(ref.resume(before)))))
        for g in got:
            for k in kind.NUMBERS:
                out[k] = max(out[k], g[k]) if np.isfinite(g[k]) else g[k]
        del ref, state
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """The numbers are those the limits name, each finite and within its
    limit."""
    return set(numbers) == set(limits) and all(
        np.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in numbers)


def readout(numbers: dict, limits: dict) -> dict:
    """Each number beside its limit, the numbers first; None where one has
    none."""
    return {k: {'value': numbers.get(k), 'limit': limits.get(k)}
            for k in [*numbers, *(k for k in limits if k not in numbers)]}
