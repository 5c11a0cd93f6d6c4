"""Location of the shipped support tables.

The binary tables (atomic data, background opacities, FAL-C, quadratures)
live once, in ``lightweaver_tpu/data/``.  They are read here by file path:
importing ``lightweaver_tpu`` would import jax, which this package never
needs.
"""
from pathlib import Path

DATA_DIR = Path(__file__).resolve().parent.parent / 'lightweaver_tpu' / 'data'
