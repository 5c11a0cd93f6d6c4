"""What the kinds' input generators (lwbench/kinds/<kind>.py:make_inputs)
share: the seed's check and FAL-C's depths.

A generator makes the inputs of a run from ``--seed`` as numpy arrays,
handed alike to the program and to the reference.  FAL-C comes from the
reference's copy of the data (its Falc82 turns the tabulated column mass
into heights).  Every seed gives the same shapes, so the work of a step
does not depend on the seed.
"""
import numpy as np

FIELDS = ('height', 'temperature', 'vlos', 'vturb', 'ne', 'nHTot')


def check_seed(seed: int) -> int:
    """A seed is a whole number (numpy's generators take any size)."""
    if seed < 0:
        raise ValueError(f'--seed takes a whole number, got {seed}')
    return seed


def falc_depths(Nk: int):
    """FAL-C's arrays at the depths np.unique(np.linspace(0, 81, Nk)
    .astype(int)) of its 82, as problems.stacked_falc picks them."""
    from ..reference.lwref.fal import Falc82
    full = Falc82()
    idx = np.unique(np.linspace(0, 81, Nk).astype(int))
    return {k: np.asarray(getattr(full, k), np.float64)[idx] for k in FIELDS}


def falc_depth_count(Nk: int) -> int:
    """The number of depths falc_depths(Nk) picks."""
    return len(np.unique(np.linspace(0, 81, Nk).astype(int)))
