"""Configuration system: defaults + optional `lightweaverrc` YAML.

ref: lightweaver/config.py:11-106.  The reference's
SIMD-implementation key is replaced by precision/recurrence knobs (the
TPU analogue of picking a kernel variant); the solver registries are
plain dicts of jittable functions instead of dlopen plugin managers
(ref: Source/LwFormalInterface.hpp:35-145).
"""
import os
from pathlib import Path
from typing import Optional

_DEFAULTS = {
    'FormalSolver1d': 'piecewise_bezier3_1d',
    'FormalSolver2d': 'piecewise_linear_2d',
    'IterationScheme': 'mali_full_precond',
    'GammaAccum': 'exact',             # 'exact' | 'blocked' (f32 Gamma sums)
    'RecurrenceMode': 'scan',          # 'scan' | 'parallel' (assoc. scan)
    'Precision': 'f64',                # 'f64' | 'mixed' (f32 + f64 accum)
}


def _rc_path() -> Optional[Path]:
    cwd = Path.cwd() / 'lightweaverrc'
    if cwd.exists():
        return cwd
    home = Path(os.environ.get('XDG_CONFIG_HOME',
                               Path.home() / '.config'))
    p = home / 'lightweaver_tpu' / 'lightweaverrc'
    return p if p.exists() else None


class ConfigDict(dict):
    """Defaults overlaid with the first `lightweaverrc` found (cwd, then
    XDG config dir)."""

    def __init__(self):
        super().__init__(_DEFAULTS)
        path = _rc_path()
        if path is not None:
            import yaml
            with open(path) as f:
                user = yaml.safe_load(f) or {}
            unknown = set(user) - set(_DEFAULTS)
            if unknown:
                raise ValueError(f'Unknown lightweaverrc keys: {unknown}')
            self.update(user)

    def save(self, path: Optional[str] = None):
        import yaml
        if path is None:
            home = Path(os.environ.get('XDG_CONFIG_HOME',
                                       Path.home() / '.config'))
            d = home / 'lightweaver_tpu'
            d.mkdir(parents=True, exist_ok=True)
            path = d / 'lightweaverrc'
        with open(path, 'w') as f:
            yaml.safe_dump(dict(self), f)


params = ConfigDict()
