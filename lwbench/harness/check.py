"""The comparison that decides ``correct``.

The reference (lwbench/reference: ``mali``, the MALI step written from
the published method, on ``problem``'s inputs) runs in float64 on the
run's device, once the window has closed and the program's state is
freed.  It works out the inputs of each compared unit (a column of the
batch drawn from the seed, or the whole slab) from the seed's atmosphere
itself, and follows the program twice per unit:

- first: from its own LTE start, the set-up's steps (Nscatter formal
  solutions and one MALI step), against the program's state after its
  warm-up, which ran through the same calls at the same sizes;
- last: from the state the program's last MALI step started from (J and
  the populations, kept before each step), that one step, against the
  program's state after it.

Three numbers, each the worst over both and over the units:

- J: per wavelength, the largest |J - J_ref| over the points over the
  largest |J_ref| (J spans decades across the grid);
- pops: the largest |n - n_ref| / n_ref over levels and points;
- Gamma: per point, the largest |Gamma - Gamma_ref| over the largest
  |Gamma_ref| of the point's matrix.
"""
import numpy as np
import torch

from ..reference import mali, problem

NAMES = ('J', 'pops', 'Gamma')


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


def compare(state: dict, ref: dict) -> dict:
    """The three numbers of one program state against the reference's;
    a shape that differs reads inf."""
    def worst(fn, xs, rs):
        if len(xs) != len(rs) or any(x.shape != r.shape
                                     for x, r in zip(xs, rs)):
            return float('inf')
        return max(fn(x, r) for x, r in zip(xs, rs))
    return {'J': worst(rel_rows, [state['J']], [ref['J']]),
            'pops': worst(rel_elems, state['pops'], ref['pops']),
            'Gamma': worst(rel_matrices, state['Gamma'], ref['Gamma'])}


def _numpy(J, pops, Gammas) -> dict:
    return {'J': J.cpu().numpy(), 'pops': [n.cpu().numpy() for n in pops],
            'Gamma': [G.cpu().numpy() for G in Gammas]}


def _mali_step(p, J, pops):
    """One MALI step of the reference: (J, all atoms' populations, the
    rate matrices the step formed)."""
    J, Gammas = mali.formal_sol_gamma(p, J, pops)
    return J, mali.stat_equil(p, Gammas, pops), Gammas


def reference_numbers(config: dict, traffic: dict, inputs: dict, checkCols,
                      first, last, device) -> dict:
    """The worst of each number over the units; ``first`` the program's
    states after its warm-up, ``last`` its (before, after) states of the
    last step, one per unit."""
    out = dict.fromkeys(NAMES, 0.0)
    for u, (firstState, (before, after)) in enumerate(zip(first, last)):
        p = problem.unit_problem(config, inputs, u, checkCols, device)
        active = [a.active for a in p.atoms]

        def act(pops):
            return [n for n, on in zip(pops, active) if on]
        pops = [a.n0 for a in p.atoms]
        J = torch.zeros((p.Nlam, p.Nk), dtype=torch.float64,
                        device=p.wavelength.device)
        for _ in range(traffic['nscatter']):
            J, _ = mali.formal_sol_gamma(p, J, pops)
        J, pops, Gammas = _mali_step(p, J, pops)
        got = [compare(firstState, _numpy(J, act(pops), Gammas))]
        given = iter(before['pops'])
        pops = [torch.as_tensor(next(given), dtype=torch.float64,
                                device=J.device) if on else a.n0
                for a, on in zip(p.atoms, active)]
        J, pops, Gammas = _mali_step(
            p, torch.as_tensor(before['J'], dtype=torch.float64,
                               device=J.device), pops)
        got.append(compare(after, _numpy(J, act(pops), Gammas)))
        for g in got:
            for k in NAMES:
                out[k] = max(out[k], g[k]) if np.isfinite(g[k]) else g[k]
        del p
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number finite and within its limit."""
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in NAMES)
