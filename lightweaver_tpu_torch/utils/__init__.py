"""Post-processing and iteration utilities: the exception types, the
initial-solution enum, the collisional-radiative switching iterators, the
data paths, the depth diagnostics of a Context with depthData.fill
(postprocess.py) and the wavelength and intensity unit conversions
(wavelength.py).

A jax-free copy of ``lightweaver_tpu/utils/__init__.py``; ``planck``
points at this package's own torch Planck function.
ref: lightweaver/utils.py
"""
import enum
import os

import numpy as np

from .._data import DATA_DIR
from ..ops.ng import NgOptions  # noqa: F401
from ..ops.planck import planck_nu as planck  # noqa: F401
from .postprocess import (compute_contribution_fn,  # noqa: F401
                          compute_radiative_losses, compute_wavelength_edges,
                          integrate_line_losses)
from .wavelength import (air_to_vac, convert_specific_intensity,  # noqa: F401
                         vac_to_air)


def get_data_path() -> str:
    """Location of the shipped support data tables, the JAX package's data
    directory, which the port reads by path (_data.py)
    (ref: lightweaver/utils.py:131-135)."""
    return str(DATA_DIR) + os.sep


def get_default_molecule_path() -> str:
    """Location of the default molecule data.  The molecular models ship
    pre-extracted in data/molecules.json rather than as per-molecule
    files (ref: lightweaver/utils.py:137-141)."""
    return get_data_path()


def compute_height_edges(ctx) -> np.ndarray:
    """Edges of the height bins of a simulation's stratified altitude
    axis, for pcolormesh-style plotting
    (ref: lightweaver/utils.py:476-496)."""
    height = np.asarray(ctx.atmos.zGrid if ctx.atmos.Ndim == 2
                        else ctx.atmos.height)
    return np.concatenate((
        (height[0] + 0.5 * (height[0] - height[1]),),
        0.5 * (height[1:] + height[:-1]),
        (height[-1] - 0.5 * (height[-2] - height[-1]),)))


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
