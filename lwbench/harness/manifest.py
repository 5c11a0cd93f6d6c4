"""BENCHMARK.json and the files it names, each found by its name:

- a configuration: the JSON file that ``configs[].file`` names;
- a traffic mix: ``lwbench/traffic/<traffic>.json``;
- a cell's own settings (the columns the check samples, the steps a
  traced run profiles, the limits of the comparison):
  ``lwbench/cells/<workload>.json``;
- a configuration's kind: ``lwbench/kinds/<kind>.py``, the module that
  holds everything the harness does differently for that kind of
  deployment (kind_path says what it defines);
- a metric: ``lwbench/metrics/<metric name>.py``, whose ``read(run)``
  returns the metric's value or None; a name with a suffix
  (``<quantity>.<suffix>``, one quantity split by the cells that report
  it) falls back to ``lwbench/metrics/<quantity>.py`` where it has no
  file of its own.

A later cell, kind or metric is added by adding files and entries; no
file here names one.
"""
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = 'lwbench'


@dataclass
class Cell:
    """One workload of BENCHMARK.json with the files it names."""
    name: str
    chips: int
    config: Dict
    traffic: Dict
    settings: Dict
    manifest: Dict
    kind: ModuleType          # lwbench/kinds/<config kind>.py

    def metrics(self, perLayer: bool) -> List[Dict]:
        """The end-to-end metrics (or, with perLayer, the per-layer ones)
        that this cell reports: those without a ``workloads`` key and
        those whose key lists it."""
        entries = self.manifest['per_layer' if perLayer else 'end_to_end']
        return [m for m in entries
                if 'workloads' not in m or self.name in m['workloads']]


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: Path, prefix: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace('.', '_').replace('-', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kind_path(kind: str, root: Path = ROOT) -> Path:
    """lwbench/kinds/<kind>.py; KeyError, listing the kinds there are,
    where it does not exist.

    A kind module defines: ``make_inputs(config, seed)`` (the inputs as
    numpy arrays, handed alike to the program and the reference);
    ``check_units(config, settings, seed)`` (the parts of the system the
    check compares, drawn from the seed); ``shapes(config)`` (Nlam, Nmu,
    Nk); ``System`` (the program's objects, stepped: see
    harness/systems.py); ``SPANS`` (the names of the harness spans its
    system opens besides the harness's own); ``NUMBERS`` (the compared
    numbers, each with its comparison: see harness/check.py); and
    ``reference(config, inputs, unit, units, device)`` (the plain
    reference of compared unit ``unit``, whose ``start``, ``scatter``,
    ``step``, ``resume`` and ``compared`` check.reference_numbers runs)."""
    kinds = root / BENCH / 'kinds'
    path = kinds / f'{kind}.py'
    if not path.is_file():
        raise KeyError(f'no kind {kind!r} in {kinds}; there are '
                       f"{sorted(p.stem for p in kinds.glob('*.py'))}")
    return path


def load_kind(kind: str, root: Path = ROOT) -> ModuleType:
    """The module of kind ``kind`` (kind_path)."""
    return _load_module(kind_path(kind, root), 'lwbench_kind_', kind)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of ``root``/BENCHMARK.json with its
    configuration, traffic, settings and kind module; KeyError for an
    unknown name or kind."""
    manifest = read_json(root / 'BENCHMARK.json')
    work = {w['name']: w for w in manifest['workloads']}
    if name not in work:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json; '
                       f'there are {sorted(work)}')
    w = work[name]
    configs = {c['name']: c for c in manifest['configs']}
    config = read_json(root / configs[w['config']]['file'])
    traffic = read_json(root / BENCH / 'traffic' / f"{w['traffic']}.json")
    settings = read_json(root / BENCH / 'cells' / f'{name}.json')
    return Cell(name=name, chips=int(w['chips']), config=config,
                traffic=traffic, settings=settings, manifest=manifest,
                kind=load_kind(config['kind'], root))


def reader_path(metric: str, root: Path = ROOT) -> Path:
    """lwbench/metrics/<metric>.py, or for <quantity>.<suffix> without a
    file of its own lwbench/metrics/<quantity>.py."""
    metrics = root / BENCH / 'metrics'
    path = metrics / f'{metric}.py'
    if not path.exists() and '.' in metric:
        path = metrics / f"{metric.rsplit('.', 1)[0]}.py"
    return path


def load_reader(metric: str, root: Path = ROOT) -> Callable:
    """``read`` of the metric's reader (reader_path)."""
    return _load_module(reader_path(metric, root), 'lwbench_metric_',
                        metric).read
