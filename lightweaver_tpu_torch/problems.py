"""The two problems of the main path, built the way their users build them.

- falc_h6ca: FAL-C (82 depths) with H 6-level and Ca II active, 5 rays
  (the golden problem, tests/golden/falc_h6ca_*.npz).
- FALC-500: the same setup interpolated to 500 depths in log column mass,
  the problem the compiled reference and bench.py time.

and random smooth rays that check the depth sweep against its plain
version.
"""
import numpy as np

from .atmosphere import Atmosphere
from .atomic_set import RadiativeSet
from .context import Context
from .fal import Falc82
from .rh_atoms import CaII_atom, H_6_atom


def falc_interpolated(Nspace: int) -> Atmosphere:
    """FAL-C interpolated to ``Nspace`` depths, linear in log10 column
    mass (log-linear in T, ne, nHTot), as bench.py:40-68 builds it."""
    full = Falc82()
    cm = np.log10(full.cmass)
    cmNew = np.linspace(cm[0], cm[-1], Nspace)

    def interp(y, logY=False):
        if logY:
            return 10 ** np.interp(cmNew, cm, np.log10(y))
        return np.interp(cmNew, cm, y)
    return Atmosphere(height=interp(full.height),
                      temperature=interp(full.temperature, logY=True),
                      vlos=np.zeros(Nspace),
                      vturb=interp(full.vturb),
                      ne=interp(full.ne, logY=True),
                      nHTot=interp(full.nHTot, logY=True))


def random_rays(NL: int, Nmu: int, Nk: int, seed: int = 0) -> dict:
    """Random smooth rays as numpy arrays, keyed as the arguments of
    ops.sweep.formal_solve_sweep: chi, srcNum [2, NL, Nmu, Nk] spanning
    six decades of opacity and four of source function (a 9-point
    running mean along depth), decreasing heights, sorted muz."""
    rng = np.random.default_rng(seed)

    def smooth(x, w=9):
        k = np.ones(w) / w
        return np.apply_along_axis(
            lambda r: np.convolve(r, k, mode='same'), -1, x)
    h = np.sort(rng.uniform(0, 1e6, Nk))[::-1].copy()
    muz = np.sort(rng.uniform(0.05, 1.0, Nmu))
    wmu = rng.uniform(0.2, 0.5, Nmu)
    chi = smooth(10 ** rng.uniform(-8, -2, (2, NL, Nmu, Nk)))
    src = chi * smooth(10 ** rng.uniform(-2, 2, (2, NL, Nmu, Nk)))
    return dict(chi=chi, srcNum=src, height=h, muz=muz,
                IupwD=rng.uniform(0, 1, (NL, Nmu)),
                IupwU=rng.uniform(0, 1, (NL, Nmu)), wmu=wmu)


def h6ca_context(atmos: Atmosphere, Nrays: int = 5, device='cpu') -> Context:
    """H 6-level + Ca II, both active, on ``atmos`` with an ``Nrays``
    Gauss-Legendre quadrature."""
    atmos.quadrature(Nrays)
    rs = RadiativeSet([H_6_atom(), CaII_atom()])
    rs.set_active('H', 'Ca')
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    return Context(atmos, spect, eqPops, device=device)
