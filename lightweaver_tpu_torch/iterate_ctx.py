"""Convergence driver: iterate a Context to statistical equilibrium.

ref: lightweaver/iterate_ctx.py
"""
import time
from dataclasses import dataclass
from typing import Optional

from .iteration_update import IterationUpdate


@dataclass
class ConvergenceCriteria:
    """Default convergence criteria: dJ < JTol, dPops < popsTol (and the
    collisional-radiative switching schedule finished)."""
    ctx: 'object'
    JTol: float
    popsTol: float
    rhoTol: Optional[float] = None

    def is_converged(self, JUpdate: IterationUpdate,
                     popsUpdate: IterationUpdate) -> bool:
        terms = [JUpdate.dJMax < self.JTol,
                 popsUpdate.dPopsMax < self.popsTol]
        if self.rhoTol is not None and popsUpdate.updatedRho:
            terms.append(popsUpdate.dRhoMax < self.rhoTol)
        terms.append(JUpdate.ctx.crswDone)
        return all(terms)


# the concrete class above *is* the default implementation; the alias
# mirrors the reference's abstract-base/Default split
# (ref: lightweaver/iterate_ctx.py:9-83)
DefaultConvergenceCriteria = ConvergenceCriteria


def iterate_ctx_se(ctx, Nscatter: int = 3, NmaxIter: int = 2000,
                   prd: bool = False, JTol: float = 5e-3,
                   popsTol: float = 1e-3, rhoTol: Optional[float] = None,
                   prdIterTol: float = 1e-2, maxPrdSubIter: int = 3,
                   printInterval: float = 0.2, quiet: bool = False,
                   convergence=None, returnFinalConvergence: bool = False,
                   raiseOnUnconverged: bool = False):
    """MALI iteration loop: Nscatter pure Lambda iterations, then
    alternating formal solutions + statistical equilibrium until
    converged.
    ref: lightweaver/iterate_ctx.py:85-241"""
    if convergence is None:
        convergence = ConvergenceCriteria
    conv = convergence(ctx, JTol, popsTol, rhoTol)

    prevPrint = 0.0
    start = time.time()
    finalUpdates = []

    def _final_updates():
        return []

    for it in range(NmaxIter):
        JUpdate = ctx.formal_sol_gamma_matrices()
        if it < Nscatter:
            continue

        def _final_updates():
            # the reference always returns the last computed updates,
            # converged or not (ref: iterate_ctx.py:209-213, 235-239)
            ups = [JUpdate, popsUpdate]
            if rhoUpdate is not None:
                ups.append(rhoUpdate)
            return ups

        popsUpdate = ctx.stat_equil()
        if prd:
            rhoUpdate = ctx.prd_redistribute(maxIter=maxPrdSubIter,
                                             tol=prdIterTol)
        else:
            rhoUpdate = None

        if not quiet and (time.time() - prevPrint) > printInterval:
            s = (f'-- Iteration {it}: {JUpdate.compact_representation()}, '
                 f'{popsUpdate.compact_representation()}')
            if rhoUpdate is not None:
                s += f', {rhoUpdate.compact_representation()}'
            print(s)
            prevPrint = time.time()

        if conv.is_converged(JUpdate, popsUpdate):
            if not quiet:
                print(f'Converged in {it + 1} iterations '
                      f'({time.time() - start:.2f} s)')
            finalUpdates = _final_updates()
            break
    else:
        if raiseOnUnconverged:
            from .utils import ConvergenceError
            raise ConvergenceError(
                f'Not converged after {NmaxIter} iterations')
        if not quiet:
            print(f'Not converged after {NmaxIter} iterations')
        if returnFinalConvergence:
            return _final_updates()
        return it + 1

    if returnFinalConvergence:
        return finalUpdates
    return it + 1
