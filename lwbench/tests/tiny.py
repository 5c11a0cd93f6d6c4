"""A temporary copy of the benchmark's manifest and files with both
configurations cut to a size the CPU tests hold: 4 columns of 20 depths
(every column compared) and a 20 x 8 slab."""
import json
import shutil
from pathlib import Path

from lwbench.harness.manifest import ROOT

TINY = {'falc_h6ca_cols512': {'columns': 4, 'depths': 20},
        'slab2d_h6ca_82x256': {'depths': 20, 'x_columns': 8}}
COLS, SLAB, FUSED = 'cols512_default', 'slab2d_besser', 'cols512_fused'


def edit_json(path: Path, **changes):
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


def tiny_root(tmp: Path) -> Path:
    """``tmp`` holding BENCHMARK.json and lwbench/ (its data files, kinds
    and readers; the harness itself is imported from the repository)
    with the tiny sizes."""
    shutil.copy(ROOT / 'BENCHMARK.json', tmp)
    shutil.copytree(ROOT / 'lwbench', tmp / 'lwbench', ignore=(
        shutil.ignore_patterns('reference', 'tests', '__pycache__')))
    for name, changes in TINY.items():
        edit_json(tmp / 'lwbench' / 'configs' / f'{name}.json', **changes)
    for cell in (COLS, FUSED):
        edit_json(tmp / 'lwbench' / 'cells' / f'{cell}.json',
                  check_columns=4)
    return tmp
