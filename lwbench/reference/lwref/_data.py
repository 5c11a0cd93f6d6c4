"""Location of the support tables the reference reads: its own copy of
the binary tables (atomic data, background opacities, FAL-C,
quadratures) in ``lwbench/reference/data/``."""
from pathlib import Path

DATA_DIR = Path(__file__).resolve().parent.parent / 'data'
