"""One compared unit of the reference under complete redistribution, as
the check (harness/check.py:reference_numbers) drives it: its state (J
and every atom's populations) from the LTE start, a formal solution that
updates J alone (the set-up's Nscatter steps), one MALI step (mali.py:
the formal solution, the rate matrices, the statistical equilibrium),
the state a program kept before a step, and the arrays compared."""
import torch

from . import mali
from .problem import F64, Problem


class Unit:
    def __init__(self, p: Problem):
        self.p = p
        self.active = [a.active for a in p.atoms]

    def start(self) -> dict:
        p = self.p
        return {'J': torch.zeros((p.Nlam, p.Nk), dtype=F64,
                                 device=p.wavelength.device),
                'pops': [a.n0 for a in p.atoms]}

    def scatter(self, state: dict) -> dict:
        J, _ = mali.formal_sol_gamma(self.p, state['J'], state['pops'])
        return dict(state, J=J)

    def step(self, state: dict) -> dict:
        """One MALI step; the state after it with the rate matrices it
        formed."""
        J, Gammas = mali.formal_sol_gamma(self.p, state['J'], state['pops'])
        return {'J': J, 'pops': mali.stat_equil(self.p, Gammas,
                                                 state['pops']),
                'Gamma': Gammas}

    def resume(self, kept: dict) -> dict:
        """The state of the program's ``kept`` (J and the active atoms'
        populations, numpy); the passive atoms keep their LTE ones."""
        dev = self.p.wavelength.device
        given = iter(kept['pops'])
        pops = [torch.as_tensor(next(given), dtype=F64, device=dev) if on
                else a.n0 for a, on in zip(self.p.atoms, self.active)]
        return {'J': torch.as_tensor(kept['J'], dtype=F64, device=dev),
                'pops': pops}

    def compared(self, state: dict) -> dict:
        """J, the active atoms' populations and Gamma as numpy."""
        return {'J': state['J'].cpu().numpy(),
                'pops': [n.cpu().numpy() for n, on in
                         zip(state['pops'], self.active) if on],
                'Gamma': [G.cpu().numpy() for G in state['Gamma']]}
