"""Driver utilities: the exception types, the initial-solution enum and
the collisional-radiative switching iterators.

These are the jax-free parts of ``lightweaver_tpu/utils/__init__.py``;
``planck`` points at this package's own torch Planck function.
ref: lightweaver/utils.py
"""
import enum

from .ops.planck import planck_nu as planck  # noqa: F401


class InitialSolution(enum.Enum):
    """Initial population guess for active atoms
    (ref: lightweaver/utils.py:22-31)."""
    Lte = enum.auto()
    Zero = enum.auto()
    EscapeProbability = enum.auto()


class ConvergenceError(Exception):
    """Raised when an iteration scheme fails to converge
    (ref: lightweaver/utils.py:111)."""


class ExplodingMatrixError(Exception):
    """Raised when a population-update matrix solve produces non-finite
    results (ref: lightweaver/utils.py:117)."""


class CrswIterator:
    """Collisional-radiative switching schedule (Hummer & Voels): start
    from a large multiplier on the collisional rates and decay it towards
    1 as val = max(1, val * 0.1**(1/val)).
    ref: lightweaver/utils.py:240-253"""

    def __init__(self, initVal: float = 1e3):
        self.val = initVal

    def __call__(self) -> float:
        self.val = max(1.0, self.val * 0.1 ** (1.0 / self.val))
        return self.val


class UnityCrswIterator(CrswIterator):
    """No collisional-radiative switching (factor always 1)."""

    def __init__(self):
        super().__init__(1.0)

    def __call__(self) -> float:
        return self.val
