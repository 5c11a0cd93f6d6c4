"""The problems of the main path, built the way their users build them.

- falc_h6ca: FAL-C (82 depths) with H 6-level and Ca II active, 5 rays
  (the golden problem, tests/golden/falc_h6ca_*.npz).
- FALC-500: the same setup interpolated to 500 depths in log column mass,
  the problem the compiled reference and bench.py time.
- the mixed-precision problem: FAL-C decimated to 40 depths, 3 rays, H
  6-level + Ca II with Ca II active (tests/test_mixed_precision.py's
  problem, on which the JAX package's float32 state converges).
- falc_h6mg: FAL-C with H 6-level and Mg II active, 5 rays, Ly-alpha,
  Ly-beta and Mg II h & k in PRD (BASELINE config 3, the golden problem
  tests/golden/falc_h6mg_prd_*.npz), and its hybrid-PRD variant with a
  0-5 km/s outflow ramp (tests/golden/falc_h6mg_hprd_*.npz).
- falc_multi_ng: FAL-C with H 6-level, Ca II and Na I active, Mg II
  passive, 5 rays, Ng on the populations (BASELINE config 2, the golden
  problem tests/golden/falc_multi_ng_*.npz).
- falc_ca_timedep: FAL-C with H 6-level + Ca II, Ca II active, 5 rays,
  the problem of the golden backward-Euler run
  (tests/golden/falc_ca_timedep_*.npz).
- falc_h6ca_stokes: falc_h6ca in a uniform field of 0.1 T at
  inclination pi/3 and azimuth pi/6 (BASELINE config 4, the golden
  problem tests/golden/falc_h6ca_stokes_*.npz).
- column_batch: C FAL-C columns with their temperature scaled per column
  by uniform(0.95, 1.05) from a numpy seed, as a parallel.ColumnBatch
  (BASELINE config 5's 1.5D leg at C = 512, H 6-level + Ca II active;
  tests/test_column_batch.py's columns at fewer depths).
- slab_2d: a 2D (x, z) FAL-C slab with a +-5% sinusoidal temperature
  perturbation and a 1 km/s shear flow along x, H 6-level + Ca II with
  Ca II active: at (30, 8) with callable x boundaries the golden 2D
  problem (tests/golden/falc2d_ca_*.npz, scripts/refgold/
  export_inputs.py:build_2d_atmos), at (82, 256) periodic with 12 rays
  BASELINE config 5's 2D leg.

and random inputs (rays, a line group, slot-packed lines) that check the
kernels against their plain versions and against the JAX package.
"""
import numpy as np
import torch

from .atmosphere import Atmosphere, BoundaryCondition
from .atomic_set import RadiativeSet
from .context import Context
from .fal import Falc82
from .ops.ng import NgOptions
from .ops.planck import planck_nu
from .rh_atoms import CaII_atom, H_6_atom, MgII_atom, NaI_atom


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


def falc_decimated(Nspace: int) -> Atmosphere:
    """FAL-C at the depths np.unique(np.linspace(0, 81, Nspace)
    .astype(int)) of its 82, as tests/test_mixed_precision.py builds it."""
    full = Falc82()
    idx = np.unique(np.linspace(0, 81, Nspace).astype(int))
    return Atmosphere(height=full.height[idx],
                      temperature=full.temperature[idx],
                      vlos=full.vlos[idx], vturb=full.vturb[idx],
                      ne=full.ne[idx], nHTot=full.nHTot[idx])


def random_rays(NL: int, Nmu: int, Nk: int, seed: int = 0) -> dict:
    """Random smooth rays as numpy arrays, keyed as the arguments of
    ops.sweep.formal_solve_sweep: chi, srcNum [2, NL, Nmu, Nk] spanning
    six decades of opacity and four of source function (a 9-point
    running mean along depth), decreasing heights, sorted muz."""
    rng = np.random.default_rng(seed)
    h = np.sort(rng.uniform(0, 1e6, Nk))[::-1].copy()
    muz = np.sort(rng.uniform(0.05, 1.0, Nmu))
    wmu = rng.uniform(0.2, 0.5, Nmu)
    chi = _smooth(10 ** rng.uniform(-8, -2, (2, NL, Nmu, Nk)))
    src = chi * _smooth(10 ** rng.uniform(-2, 2, (2, NL, Nmu, Nk)))
    return dict(chi=chi, srcNum=src, height=h, muz=muz,
                IupwD=rng.uniform(0, 1, (NL, Nmu)),
                IupwU=rng.uniform(0, 1, (NL, Nmu)), wmu=wmu)


def _smooth(x, w=9):
    """w-point running mean along the last axis, of the axis' own length
    (numpy's mode 'same' for rows of at least w points; shorter rows keep
    their length)."""
    k = np.ones(w) / w
    lo = (w - 1) // 2
    return np.apply_along_axis(
        lambda r: np.convolve(r, k, mode='full')[lo:lo + r.size], -1, x)


def column_rays(C: int, NL: int, Nmu: int, Nk: int, seed: int = 0) -> dict:
    """C columns of random_rays(NL, Nmu, Nk, seed + c) laid end to end
    along depth, keyed as ops.sweep.formal_solve_sweep's column arguments:
    chi, srcNum [2, NL, Nmu, C Nk], height [C, Nk], IupwD, IupwU
    [NL, Nmu, C]; muz and wmu those of the first column."""
    cols = [random_rays(NL, Nmu, Nk, seed + c) for c in range(C)]
    out = dict(cols[0])
    for k in ('chi', 'srcNum'):
        out[k] = np.concatenate([c[k] for c in cols], axis=-1)
    out['height'] = np.stack([c['height'] for c in cols])
    for k in ('IupwD', 'IupwU'):
        out[k] = np.stack([c[k] for c in cols], axis=-1)
    return out


def column_slots(C: int, S: int, NL: int, Nmu: int, Nk: int,
                 seed: int = 0) -> dict:
    """C columns of random_slots(S, NL, Nmu, Nk, seed + c) and
    random_boundaries(NL, Nmu, seed + c) laid end to end along depth,
    keyed as ops.fused.fused_lambda_step's column arguments: phiP
    [S, 2, NL, Nmu, C Nk], the rows [.., C Nk], height [C, Nk], and the
    boundary rows 'data' [NL, Nmu, C] and 'therm' [NL, C, 2]; muz and wmu
    those of the first column."""
    cols = [random_slots(S, NL, Nmu, Nk, seed + c) for c in range(C)]
    bcs = [random_boundaries(NL, Nmu, seed + c) for c in range(C)]
    out = dict(cols[0])
    for k in ('phiP', 'chiCo', 'etaCo', 'bgChi', 'bgEta', 'scaJ'):
        out[k] = np.concatenate([c[k] for c in cols], axis=-1)
    out['height'] = np.stack([c['height'] for c in cols])
    out['data'] = np.stack([b['data'] for b in bcs], axis=-1)
    out['therm'] = np.stack([b['therm'] for b in bcs], axis=1)
    return out


# (i, j) of the members of random_line_group, sharing levels so that every
# level sum has several terms (the first K of them; levels 0-4)
_GROUP_LEVELS = ((0, 1), (0, 2), (1, 2), (2, 3), (0, 3), (1, 3), (3, 4),
                 (2, 4))


def random_line_group(K: int, Nlam: int, Nmu: int, Nk: int, row0: int,
                      Wu: int, seed: int = 0, Nlev: int = 5) -> dict:
    """A random same-atom group of K <= 8 overlapping lines on the window
    [row0, row0 + Wu) as numpy arrays keyed as the arguments of
    ops.gamma.group_gamma_rates (plus 'levels'): member m's profile and
    coefficient rows are zero outside its own sub-window, rho != 1."""
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0.1, 1.0, (K, 2, Wu, Nmu, Nk))
    coef = np.stack([rng.uniform(0.5, 1.5, (K, Wu)),
                     rng.uniform(0.5, 2.0, (K, Wu)),
                     rng.uniform(0.5, 2.0, (K, Wu)),
                     rng.uniform(0.1, 1.0, (K, Wu))], axis=-1)
    for m in range(K):
        # overlapping sub-windows whose union is the whole window
        lo = 0 if m == 0 else (m * Wu) // (K + 1)
        hi = Wu if m == K - 1 else ((m + 2) * Wu) // (K + 1)
        phi[m, :, :lo] = phi[m, :, hi:] = 0.0
        coef[m, :lo] = coef[m, hi:] = 0.0

    def rays(lo, hi):
        return rng.uniform(lo, hi, (2, Nlam, Nmu, Nk))
    return dict(phi=phi, rho=rng.uniform(0.5, 1.5, (K, Wu, Nk)),
                Psi=rays(0.0, 1.0), IeffBase=rays(0.0, 1.0), I=rays(0.0, 1.0),
                srcNum=rays(1.0, 2.0),
                chiCL=rng.uniform(-0.1, 0.1, (Nlev, Nlam, Nk)),
                UCL=rng.uniform(0.0, 0.1, (Nlev, Nlam, Nk)),
                etaC=rng.uniform(0.0, 0.1, (Nlam, Nk)),
                n=rng.uniform(0.1, 1.0, (Nlev, Nk)), coef=coef,
                wphi=rng.uniform(0.5, 1.5, (K, Nk)),
                wmuHalf=rng.uniform(0.1, 0.3, Nmu), row0=row0,
                levels=_GROUP_LEVELS[:K])


def random_slots(C: int, NL: int, Nmu: int, Nk: int, seed: int = 0) -> dict:
    """Random smooth slot-packed lines as numpy arrays keyed as the array
    arguments of ops.fused.fused_lambda_step (the boundaries aside, see
    random_boundaries): every slot holds two line windows with zeros
    around them; opacities span five decades."""
    rng = np.random.default_rng(seed)
    h = np.sort(rng.uniform(0, 1e6, Nk))[::-1].copy()
    bgChi = _smooth(10 ** rng.uniform(-8, -3, (NL, Nk)))
    phiP = _smooth(rng.uniform(0.0, 1.0, (C, 2, NL, Nmu, Nk)))
    for c in range(C):
        edges = np.sort(rng.choice(np.arange(1, NL), 4, replace=False))
        mask = np.zeros(NL, bool)
        mask[edges[0]:edges[1]] = mask[edges[2]:edges[3]] = True
        phiP[c, :, ~mask] = 0.0
    chiCo = bgChi * _smooth(rng.uniform(0.0, 10.0, (C, NL, Nk)))
    return dict(phiP=phiP, chiCo=chiCo,
                etaCo=chiCo * _smooth(10 ** rng.uniform(-1, 1, (C, NL, Nk))),
                bgChi=bgChi,
                bgEta=bgChi * _smooth(10 ** rng.uniform(-2, 2, (NL, Nk))),
                scaJ=bgChi * rng.uniform(0.0, 0.1, (NL, Nk)), height=h,
                muz=np.sort(rng.uniform(0.05, 1.0, Nmu)),
                wmu=rng.uniform(0.2, 0.5, Nmu))


def random_boundaries(NL: int, Nmu: int, seed: int = 0) -> dict:
    """Boundary rows for ops.fused.fused_lambda_step: incident intensities
    [NL, Nmu] ('data') and Planck-like rows [NL, 2] ('therm')."""
    rng = np.random.default_rng(seed)
    return {'data': rng.uniform(0.0, 1.0, (NL, Nmu)),
            'therm': rng.uniform(1.0, 2.0, (NL, 2))}


def h6ca_context(atmos: Atmosphere, Nrays: int = 5, device='cuda',
                 dtype=None, **ctxKwargs) -> Context:
    """H 6-level + Ca II, both active, on ``atmos`` with an ``Nrays``
    Gauss-Legendre quadrature, on ``device`` (the card unless the caller
    passes 'cpu') in the working ``dtype`` (Context's default: float64, or
    float32 under lightweaverrc ``Precision: mixed``); ``ctxKwargs`` go to
    the Context."""
    atmos.quadrature(Nrays)
    rs = RadiativeSet([H_6_atom(), CaII_atom()])
    rs.set_active('H', 'Ca')
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    return Context(atmos, spect, eqPops, device=device, dtype=dtype,
                   **ctxKwargs)


def mixed_precision_context(device='cuda', dtype=None,
                            Nspace: int = 40) -> Context:
    """The mixed-precision problem: falc_decimated(Nspace), 3 rays, H
    6-level + Ca II with Ca II active (tests/test_mixed_precision.py,
    which runs it with a float32 state)."""
    return timedep_context(device, dtype, falc_decimated(Nspace), 3)


def vlos_ramp(atmos: Atmosphere, vMax: float = 5e3) -> Atmosphere:
    """Set a line-of-sight velocity rising linearly with height from 0 at
    the bottom to ``vMax`` m/s at the top (an outflow, as the hybrid-PRD
    golden run uses); returns ``atmos``."""
    h = atmos.height
    atmos.vlos = vMax * (h - h.min()) / (h.max() - h.min())
    return atmos


def h6mg_context(atmos: Atmosphere = None, Nrays: int = 5,
                 hprd: bool = False, device='cuda', dtype=None,
                 **ctxKwargs) -> Context:
    """H 6-level + Mg II, both active, PRD lines in PRD, on ``atmos``
    (default FAL-C, 82 depths) with an ``Nrays`` quadrature.  With
    ``hprd`` the atmosphere gets the 0-5 km/s outflow ramp (vlos_ramp) and
    the Context runs hybrid PRD.  ``device``, ``dtype`` and ``ctxKwargs``
    as for h6ca_context.  The defaults build BASELINE config 3 as
    tests/test_vs_reference_golden.py:540-546 does, and with hprd=True its
    hybrid variant as lines 411-420 there do."""
    if atmos is None:
        atmos = Falc82()
    atmos.quadrature(Nrays)
    if hprd:
        vlos_ramp(atmos)
    rs = RadiativeSet([H_6_atom(), MgII_atom()])
    rs.set_active('H', 'Mg')
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    return Context(atmos, spect, eqPops, hprd=hprd, device=device,
                   dtype=dtype, **ctxKwargs)


def multi_ng_context(ngOptions=None, device='cuda', dtype=None,
                     atmos: Atmosphere = None, Nrays: int = 5) -> Context:
    """H 6-level + Ca II + Na I active, Mg II passive, on ``atmos``
    (default FAL-C, 82 depths) with an ``Nrays`` quadrature and Ng on the
    populations (``ngOptions``, e.g. NgOptions(2, 5, 50)); ``device`` and
    ``dtype`` as for h6ca_context.  The defaults with NgOptions(2, 5, 50)
    build BASELINE config 2 as tests/test_vs_reference_golden.py:259-302
    does."""
    if atmos is None:
        atmos = Falc82()
    atmos.quadrature(Nrays)
    rs = RadiativeSet([H_6_atom(), CaII_atom(), NaI_atom(), MgII_atom()])
    rs.set_active('H', 'Ca', 'Na')
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    return Context(atmos, spect, eqPops, ngOptions=ngOptions, device=device,
                   dtype=dtype)


def timedep_context(device='cuda', dtype=None, atmos: Atmosphere = None,
                    Nrays: int = 5) -> Context:
    """H 6-level + Ca II with Ca II active on ``atmos`` (default FAL-C, 82
    depths) with an ``Nrays`` quadrature, from the LTE start; the defaults
    build the problem of the golden backward-Euler run
    (tests/test_vs_reference_golden.py:448-486).  ``device`` and ``dtype``
    as for h6ca_context."""
    if atmos is None:
        atmos = Falc82()
    atmos.quadrature(Nrays)
    rs = RadiativeSet([H_6_atom(), CaII_atom()])
    rs.set_active('Ca')
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    return Context(atmos, spect, eqPops, device=device, dtype=dtype)


def magnetise(atmos: Atmosphere, B: float = 0.1, gammaB: float = np.pi / 3,
              chiB: float = np.pi / 6) -> Atmosphere:
    """Give ``atmos`` a uniform magnetic field of strength ``B`` (T),
    inclination ``gammaB`` and azimuth ``chiB`` (rad); returns atmos."""
    Nk = atmos.Nspace
    atmos.B = np.full(Nk, B)
    atmos.gammaB = np.full(Nk, gammaB)
    atmos.chiB = np.full(Nk, chiB)
    return atmos


def stokes_context(device='cuda', dtype=None, atmos: Atmosphere = None,
                   Nrays: int = 5) -> Context:
    """H 6-level + Ca II, both active, on ``atmos`` (default FAL-C, 82
    depths) in the field of magnetise() with an ``Nrays`` quadrature;
    ``device`` and ``dtype`` as for h6ca_context.  The defaults build
    BASELINE config 4 as tests/test_vs_reference_golden.py:199-210 does:
    converge it (iterate_ctx_se), then compute_polarised_profiles and
    single_stokes_fs(updateJ=True)."""
    if atmos is None:
        atmos = Falc82()
    return h6ca_context(magnetise(atmos), Nrays, device=device, dtype=dtype)


def stacked_falc(C: int, Nk: int = 82, seed: int = 1, spread: float = 0.05):
    """C FAL-C columns at the depths np.unique(np.linspace(0, 81, Nk)
    .astype(int)) as the stacked arrays of ColumnBatch.from_stacked:
    (height [Nk], temperature, vlos, vturb, ne, nHTot [C, Nk]), each
    column's temperature scaled by uniform(1 - spread, 1 + spread) from a
    numpy seed, vlos zero (tests/test_column_batch.py:_stacked)."""
    full = Falc82()
    idx = np.unique(np.linspace(0, 81, Nk).astype(int))
    Nk = len(idx)
    rng = np.random.default_rng(seed)
    scale = rng.uniform(1.0 - spread, 1.0 + spread, (C, 1))
    T = full.temperature[idx][None, :] * scale

    def rep(a):
        return np.broadcast_to(a[idx], (C, Nk)).copy()
    return (full.height[idx], T, np.zeros((C, Nk)), rep(full.vturb),
            rep(full.ne), rep(full.nHTot))


def column_vlos_ramps(height, C: int, vMax: float = 5e3) -> np.ndarray:
    """[C, Nk] line-of-sight velocities: column c the outflow ramp of
    vlos_ramp (0 at the bottom, rising linearly with height) up to
    vMax c / (C - 1) m/s at the top, spreading 0-vMax over the columns."""
    h = np.asarray(height, np.float64)
    ramp = (h - h.min()) / (h.max() - h.min())
    tops = vMax * np.arange(C) / max(C - 1, 1)
    return tops[:, None] * ramp[None, :]


def column_batch(C: int, models=None, activeSpecies=('H', 'Ca'),
                 Nrays: int = 5, Nk: int = 82, seed: int = 1,
                 spread: float = 0.05, vlos=None,
                 ngOptions: NgOptions = None, conserveCharge: bool = False,
                 **ctxKwargs):
    """A parallel.ColumnBatch of the C columns of stacked_falc(C, Nk,
    seed, spread) with ``models`` (a zero-argument factory; default H
    6-level + Ca II), ``activeSpecies`` active, an ``Nrays`` quadrature,
    optional per-column ``vlos`` [C, Nk], ``ngOptions`` and
    ``conserveCharge``; ``ctxKwargs`` go to the flat Context (``device``,
    the card unless 'cpu'; ``dtype``, ``fsIterScheme``, ``hprd``,
    ``accelerateScattering``, ...).  The defaults at C = 512 are BASELINE
    config 5's 1.5D leg: FAL-C 82 depths, H 6-level + Ca II active, 5
    rays, 1046 wavelengths."""
    from .parallel import ColumnBatch
    if models is None:
        def models():
            return [H_6_atom(), CaII_atom()]
    height, T, v0, vturb, ne, nHTot = stacked_falc(C, Nk, seed, spread)
    return ColumnBatch.from_stacked(
        height, T, v0 if vlos is None else vlos, vturb, ne, nHTot, models,
        activeSpecies, Nrays=Nrays, ngOptions=ngOptions,
        conserveCharge=conserveCharge, **ctxKwargs)


class HalfPlanckXBc(BoundaryCondition):
    """Callable x boundary condition of the 2D golden problem: the incident
    intensity 0.5 B_nu(T) of the boundary column ``colIdx``, for every
    wavelength, ray and direction ([Nlam, Nmu, 2, Nz]; the port's copy of
    scripts/refgold/export_inputs.py:HalfPlanckXBc, Planck from
    ops/planck.py in float64 on the CPU)."""

    def __init__(self, colIdx: int):
        self.colIdx = colIdx

    def compute_bc(self, atmos, spect):
        lam = torch.as_tensor(np.asarray(spect.wavelength, np.float64))
        T = np.asarray(atmos.temperature).reshape(atmos.Nz, atmos.Nx)
        Tcol = torch.as_tensor(T[:, self.colIdx])
        B = 0.5 * planck_nu(Tcol[None, :], lam[:, None]).numpy()
        return np.broadcast_to(B[:, None, None, :],
                               (len(lam), atmos.Nrays, 2, atmos.Nz)).copy()


class RefBugCompatXLower(HalfPlanckXBc):
    """HalfPlanckXBc with the down-direction rows 1..Nx-1 zeroed: it
    reproduces the index-swap bug of the reference's linear 2D solver (its
    start-plane loop writes I(j, k) = 0 instead of I(k, j),
    FormalScalar2d.cpp:570, which zeroes the first Nx - 1 z rows of the
    callable x-lower column on every down pass), so that the port can be
    held to the golden linear run (tests/golden/falc2d_ca_ref.npz).  The
    default HalfPlanckXBc keeps the right physics; the BESSER golden run
    needs no compat boundary.  A copy of
    scripts/refgold/export_inputs.py:RefBugCompatXLower."""

    def compute_bc(self, atmos, spect):
        data = super().compute_bc(atmos, spect)
        data[:, :, 0, 1:atmos.Nx] = 0.0
        return data


def slab_2d_atmos(Nz: int = 30, Nx: int = 8, dx: float = 40e3,
                  periodic: bool = True, quadrature: int = 3,
                  refBugCompat: bool = False, roll: int = 0) -> Atmosphere:
    """A 2D (x, z) FAL-C slab: FAL-C at the depths np.unique(np.linspace(0,
    81, Nz).astype(int)) of its 82, Nx columns ``dx`` m apart, T x (1 +
    0.05 sin 2 pi j / Nx), vx = 1 km/s sin 2 pi j / Nx, vz = FAL-C's vlos;
    periodic x boundaries or the callable HalfPlanckXBc of columns 0 and
    Nx - 1 (``refBugCompat``: RefBugCompatXLower below); the 2D quadrature
    set of ``quadrature`` rays per half-plane (Atmosphere.quadrature: 3 ->
    6 rays, 6 -> 12); ``roll`` moves the columns' fields by that many
    columns along x (np.roll; the grid stays).  slab_2d_atmos(30, 8,
    periodic=False) is
    scripts/refgold/export_inputs.py:build_2d_atmos(), the golden 2D
    problem's atmosphere."""
    full = Falc82()
    idx = np.unique(np.linspace(0, 81, Nz).astype(int))
    Nz = len(idx)
    x = np.arange(Nx) * dx
    phase = np.sin(2 * np.pi * np.arange(Nx) / Nx)
    pert = 1.0 + 0.05 * phase

    def col(a):
        return np.broadcast_to(a[idx][:, None], (Nz, Nx)).copy()
    T = np.roll(full.temperature[idx][:, None] * pert[None, :], roll, axis=1)
    vx = np.roll(1e3 * phase[None, :] * np.ones((Nz, 1)), roll, axis=1)
    xBcs = {}
    if not periodic:
        xBcs = {'xLowerBc': (RefBugCompatXLower(0) if refBugCompat
                             else HalfPlanckXBc(0)),
                'xUpperBc': HalfPlanckXBc(Nx - 1)}
    atmos = Atmosphere.make_2d(
        height=full.height[idx], x=x, temperature=T, vx=vx,
        vz=col(full.vlos), vturb=col(full.vturb), ne=col(full.ne),
        nHTot=col(full.nHTot), **xBcs)
    atmos.quadrature(quadrature)
    return atmos


def slab_2d(Nz: int = 30, Nx: int = 8, dx: float = 40e3,
            periodic: bool = True, quadrature: int = 3, device='cuda',
            dtype=None, formalSolver: str = None,
            interpFn2d: str = 'interp_linear_2d',
            refBugCompat: bool = False, roll: int = 0,
            activeSpecies=('Ca',), **ctxKwargs) -> Context:
    """H 6-level + Ca II with ``activeSpecies`` active (Ca II by default)
    on slab_2d_atmos(Nz, Nx, dx, periodic, quadrature, refBugCompat,
    roll), from LTE, with the 2D ``formalSolver`` (Context's default:
    'piecewise_linear_2d') and ``interpFn2d``, on ``device`` (the card
    unless 'cpu') in the working ``dtype``; ``ctxKwargs`` go to the
    Context.

    - slab_2d(30, 8, periodic=False, formalSolver='piecewise_linear_2d',
      refBugCompat=True) is the golden linear 2D problem
      (tests/golden/falc2d_ca_ref.npz, 154 iterations);
      formalSolver='piecewise_besser_2d' without the compat boundary the
      golden BESSER one (falc2d_ca_besser_ref.npz, 218 iterations).
    - slab_2d(82, 256, periodic=True, quadrature=6) is BASELINE config 5's
      2D leg: full FAL-C depth, 256 columns 40 km apart (a 10.24 Mm
      periodic box), 12 rays, Nlam = 546: 20,992 points."""
    atmos = slab_2d_atmos(Nz, Nx, dx, periodic, quadrature, refBugCompat,
                          roll)
    rs = RadiativeSet([H_6_atom(), CaII_atom()])
    rs.set_active(*activeSpecies)
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    return Context(atmos, spect, eqPops, formalSolver=formalSolver,
                   interpFn2d=interpFn2d, device=device, dtype=dtype,
                   **ctxKwargs)
