"""Batches of independent 1D columns (1.5D synthesis) on one device.

ColumnBatch iterates C independent 1D NLTE columns in lockstep, every
kernel launched once per MALI step for all of them.  Distribution over
several devices (the JAX package's make_mesh, wavelength sharding,
xshard2d and multihost) is not ported yet: ``mesh=`` raises.
"""
from .columns import ColumnBatch
