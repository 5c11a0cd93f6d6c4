"""Distribution over ranks (one process per card, torch.distributed).

- columns.py: ColumnBatch, a batch of 1D columns iterated in lockstep on
  one device or over a ('columns', 'wavelength') DeviceMesh (make_mesh):
  the columns split over the 'columns' ranks, the wavelength rows of the
  MALI step over the 'wavelength' ranks.
- multihost.py: initialize_multihost (the process group, the backend
  named by the caller), global_mesh, local_column_slice and
  make_global_array (a DTensor from each rank's block).
- xshard2d.py: the 2D plane sweep with the x axis block-sharded over a
  mesh dimension (formal_sol_2d_xsharded; Context(mesh=) on a 2D
  atmosphere).

The exports are the JAX package's (lightweaver_tpu/parallel).
"""
from .columns import ColumnBatch, make_mesh
from .multihost import (global_mesh, initialize_multihost,
                        local_column_slice, make_global_array)
from .xshard2d import formal_sol_2d_xsharded
