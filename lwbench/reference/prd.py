"""One compared column of the reference under hybrid partial frequency
redistribution (hybrid PRD), as the check (harness/check.py:
reference_numbers) drives it: the MALI step of mali.py with each PRD
line's emission profile psi = rho phi, then the PRD sub-iterations, in
float64 torch, written from the published method:

- Hybrid PRD (Leenaarts, Pereira & Uitenbroek 2012, A&A 543, A109): rho
  lives on the line's window in the atom's rest frame.  A ray of
  direction s (-1 down, +1 up) sees at lab wavelength lambda the atom at
  its comoving wavelength lambda (1 + s vlos mu / c), the sign of the
  profile's Doppler shift (problem.py), so Uji and Vji of a PRD line are
  scaled per (ray, depth) by rho interpolated linearly there (constant
  beyond the window).  The rest-frame mean intensity JRest at the rows of
  the PRD windows is each ray's spectrum moved to the atom's frame (its
  wavelengths times 1 + s vlos mu / c) and resampled linearly at the rest
  wavelength (constant beyond the grid), weighted by wmu / 2 and summed.
- The angle-averaged scattering integral (Uitenbroek 2001, ApJ 557, 389;
  Lightweaver's Source/Prd.cpp): per depth and window wavelength, in
  Doppler units q = (lambda - lambda0) c / (lambda0 vBroad), the
  absorption frequencies of a fine grid of step 0.15 over the range where
  gII is non-zero (+-4 around the core, up to 5 past the emission
  frequency beyond it), with the end-corrected trapezoid weights 5/12,
  13/12, 1, ..., 1, 13/12, 5/12 (Numerical Recipes' extended formula) and
  J linearly interpolated in q (constant beyond the window); rho = 1 +
  gamma (int gII J / int gII - Jbar), gamma = (n_i / n_j) Bij / (P_j +
  Q_j), Jbar = Rij / Bij, P_j + Q_j the upper level's radiative and
  collisional depopulation plus the elastic collision rate.
- gII: Gouttebroze's (1986, A&A 160, 195) fast approximation of the
  angle-averaged redistribution R_II over the profile, resonance lines
  (waveratio 1), as Lightweaver's Prd.cpp uses it: for the emission
  frequency |q_e| below 4 the core form (G0(q_e) where |q_a| <= q_e, else
  exp(q_e^2 - q_a^2) G0(q_a), zero outside [-4, q_e + 5] after the
  symmetrisation q_e >= 0), from 2 to 4 blended with the wing form by the
  Gaussian core's share of the Voigt profile, from 4 the wing form alone,
  zero where |q_a - q_e| > 5; G0(x) = 1 / (|x| + sqrt(x^2 + 1.273239545)).
- The PRD sub-iterations (RH's PRD-only formal solution, Uitenbroek 2001):
  each PRD line's rho from the step's rates and JRest, then a formal
  solution on the PRD-active wavelengths alone that updates J there, JRest
  and the PRD lines' rates (Gamma and every other rate untouched), until
  drho = max |rho_new - rho_old| / rho_new < tol or the most allowed.
  Hybrid PRD's subset: the PRD windows widened by every wavelength whose
  Doppler-shifted neighbours (the grid points from the last one at or
  below its lower neighbour times 1 + s vlos mu / c to the first one above
  its upper neighbour times it) reach a PRD window.

Departures, each to follow what the batch computes rather than a column
alone:

- the subset is the batch's: the Doppler factors of every column of the
  batch, since the batch solves one subset for all its columns (a column
  alone would take its own, maybe smaller one);
- the subset formal solution's JRest resamples the subset rows' spectra,
  the wavelengths between subset rows skipped, as the batch does;
- the stop test is the batch's: a resumed step (resume) takes the number
  of sub-iterations the batch took, which the program keeps with its
  state; from the reference's own start (the set-up's step) the column's
  own drho decides, and the compared ``prd_subiters`` must then equal the
  batch's, which stopped on the largest drho over its columns.

Nothing here imports the program or the JAX package; mali.py and
problem.py are used as they are.
"""
import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from . import mali
from .lwref import constants as Const
from .lwref.atomic_model import AtomicLine, LineType
from .problem import F64, Problem, build, radiative_set

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Q_WING = 4.0        # Prd.cpp's PrdQWing, PrdQCore, PrdQSpread, PrdDQ
Q_CORE = 2.0
Q_SPREAD = 5.0
DQ = 0.15
# fine-grid points of the widest integration range, -Q_WING to q_e +
# Q_SPREAD as q_e nears Q_WING
NQ_MAX = int((2 * Q_WING + Q_SPREAD) / DQ) + 2
# elements of one block of the subset test's [Nlam, factors] arrays
SUBSET_BLOCK = 1 << 24


@dataclass
class PrdLine:
    ai: int                 # index among the Problem's active atoms
    ti: int                 # index among that atom's transitions
    i: int
    j: int
    lo: int                 # the window's rows [lo, hi) of the grid
    hi: int
    Bij: float
    lam: torch.Tensor       # [W] the window's wavelengths
    q: torch.Tensor         # [W, Nk] in Doppler units
    aDamp: torch.Tensor     # [Nk]
    Qelast: torch.Tensor    # [Nk]


def interp_rows(x, xp, fp):
    """Linear interpolation of each row (xp, fp) [..., n], xp increasing,
    at x [..., m] (broadcast against the rows), constant beyond the
    row's ends."""
    shape = torch.broadcast_shapes(x.shape[:-1], xp.shape[:-1])
    x = x.expand(*shape, x.shape[-1]).contiguous()
    xp = xp.expand(*shape, xp.shape[-1]).contiguous()
    fp = fp.expand(*shape, fp.shape[-1])
    n = xp.shape[-1]
    i = torch.searchsorted(xp, x, right=True).clamp(1, n - 1)
    x0, x1 = xp.gather(-1, i - 1), xp.gather(-1, i)
    f0, f1 = fp.gather(-1, i - 1), fp.gather(-1, i)
    f = f0 + (x - x0) / (x1 - x0) * (f1 - f0)
    f = torch.where(x <= xp[..., :1], fp[..., :1], f)
    return torch.where(x >= xp[..., -1:], fp[..., -1:], f)


def g_zero(x):
    return 1.0 / (torch.abs(x) + torch.sqrt(x * x + 1.273239545))


def g_ii(a, qe, qa):
    """Gouttebroze's gII(a, q_e, q_a), elementwise over broadcast tensors
    (see the module's docstring)."""
    neg = qe < 0.0
    qe, qa = torch.where(neg, -qe, qe), torch.where(neg, -qa, qa)
    core = torch.where(torch.abs(qa) <= qe, g_zero(qe),
                       torch.exp(torch.clamp(qe * qe - qa * qa, max=50.0))
                       * g_zero(qa))
    u = torch.abs(qa - qe) / 2.0
    eps = qa / torch.clamp(qe, min=1e-10)
    wing = ((1.0 - 2.0 * u * g_zero(u)) * torch.exp(-u * u)
            / math.sqrt(math.pi) * (2.75 - (2.5 - 0.75 * eps) * eps))
    phiCore = torch.exp(-qe * qe)
    phiWing = a / (math.sqrt(math.pi) * (a * a + qe * qe))
    share = phiCore / (phiCore + phiWing)
    inCore = torch.where(qe < Q_CORE, core,
                         share * core + (1.0 - share) * wing)
    inCore = torch.where((qa < -Q_WING) | (qa > qe + Q_SPREAD), 0.0, inCore)
    inWing = torch.where(torch.abs(qa - qe) > Q_SPREAD, 0.0, wing)
    return torch.where(qe < Q_WING, inCore, inWing)


def scattering_rho(line: PrdLine, Jw, gamma, Jbar):
    """rho [W, Nk] of ``line`` from the mean intensity of its window Jw
    [W, Nk], gamma and Jbar [Nk] (the module's docstring)."""
    qe = line.q.T                                        # [Nk, W]
    aq = torch.abs(qe)
    lo = torch.where(aq < Q_CORE, -Q_WING, torch.where(
        aq < Q_WING, torch.where(qe > 0.0, -Q_WING, qe - Q_SPREAD),
        qe - Q_SPREAD))
    hi = torch.where(aq < Q_CORE, Q_WING, torch.where(
        aq < Q_WING, torch.where(qe > 0.0, qe + Q_SPREAD, Q_WING),
        qe + Q_SPREAD))
    npts = (torch.floor((hi - lo) / DQ) + 1.0)[..., None]    # [Nk, W, 1]
    m = torch.arange(NQ_MAX, dtype=F64, device=qe.device)
    qa = lo[..., None] + m * DQ                          # [Nk, W, NQ]
    w = torch.ones_like(qa)
    w = torch.where((m == 0) | (m == npts - 1), 5.0 / 12.0, w)
    w = torch.where((m == 1) | (m == npts - 2), 13.0 / 12.0, w)
    w = torch.where(m < npts, w * DQ, 0.0)
    Nk, W = qe.shape
    Jq = interp_rows(qa.reshape(Nk, -1), qe, Jw.T).reshape(qa.shape)
    g = g_ii(line.aDamp[:, None, None], qe[..., None], qa) * w
    ratio = (g * Jq).sum(dim=-1) / g.sum(dim=-1)         # [Nk, W]
    return (1.0 + gamma[:, None] * (ratio - Jbar[:, None])).T


def doppler_factors(vlos, muz):
    """[2, Nmu, ...] factors 1 + s vlos mu / c of the down (s = -1) and up
    (s = +1) rays, vlos [..., Nk] and muz [Nmu] numpy."""
    vlosMu = muz[:, None] * vlos[..., None, :]           # [..., Nmu, Nk]
    vlosMu = np.moveaxis(vlosMu, -2, 0)                  # [Nmu, ..., Nk]
    return np.stack([1.0 + (-1.0 * vlosMu) / Const.CLight,
                     1.0 + (1.0 * vlosMu) / Const.CLight])


def hprd_subset(wavelength, active, facs, device) -> np.ndarray:
    """The sorted rows of hybrid PRD's subset (the module's docstring) of
    the grid ``wavelength`` [Nlam] with the PRD windows' rows ``active``
    [Nlam] bool, over the Doppler factors ``facs``."""
    w = torch.as_tensor(wavelength, dtype=F64, device=device)
    f = torch.unique(torch.as_tensor(np.ravel(facs), dtype=F64,
                                     device=device))
    Nlam = w.shape[0]
    below = w[torch.clamp(torch.arange(Nlam, device=device) - 1, min=0)]
    above = w[torch.clamp(torch.arange(Nlam, device=device) + 1,
                          max=Nlam - 1)]
    # count[r] active rows among the first r
    count = torch.zeros(Nlam + 1, dtype=torch.int64, device=device)
    count[1:] = torch.cumsum(torch.as_tensor(active, device=device), 0)
    reach = torch.as_tensor(active, device=device).clone()
    step = max(1, SUBSET_BLOCK // Nlam)
    for b in range(0, f.shape[0], step):
        fb = f[b:b + step][None, :]
        first = torch.clamp(torch.searchsorted(
            w, (below[:, None] * fb).contiguous(), right=True) - 1, min=0)
        end = torch.clamp(torch.searchsorted(
            w, (above[:, None] * fb).contiguous(), right=True) + 1,
            max=Nlam)
        reach |= ((count[end] - count[first]) > 0).any(dim=1)
    return torch.nonzero(reach).flatten().cpu().numpy()


class Unit:
    """Column ``atmos`` of a batch whose columns' velocities are
    ``vlosAll`` [C, Nk], under ``config``: start, scatter, step, resume
    and compared, as crd.Unit."""

    def __init__(self, config: dict, atmos, vlosAll, device):
        dev = torch.device(device)
        self.p = p = build(config, atmos, dev)
        self.tol = config['prd_tol']
        self.maxIter = config['prd_max_subiter']
        self.active = [a.active for a in p.atoms]
        rs = radiative_set(config)
        spect = rs.compute_wavelength_grid()
        eqPops = rs.compute_eq_pops(atmos)
        lam = np.asarray(spect.wavelength, np.float64)
        self.lines = []
        for ai, model in enumerate(rs.activeAtoms):
            vB = np.asarray(model.vBroad(atmos))
            trans = [t for t in model.transitions
                     if t.transId in spect.blueIdx]
            for ti, t in enumerate(trans):
                if not (isinstance(t, AtomicLine) and t.type == LineType.PRD):
                    continue
                lo, hi = spect.blueIdx[t.transId], spect.redIdx[t.transId]
                aDamp, Qelast = t.damping(atmos, eqPops, vBroad=vB)
                q = ((lam[lo:hi, None] - t.lambda0) * Const.CLight
                     / (t.lambda0 * vB[None, :]))
                self.lines.append(PrdLine(
                    ai=ai, ti=ti, i=t.i, j=t.j, lo=lo, hi=hi, Bij=t.Bij,
                    lam=torch.as_tensor(lam[lo:hi], dtype=F64, device=dev),
                    q=torch.as_tensor(q, dtype=F64, device=dev),
                    aDamp=torch.as_tensor(np.asarray(aDamp), dtype=F64,
                                          device=dev),
                    Qelast=torch.as_tensor(np.asarray(Qelast), dtype=F64,
                                           device=dev)))
        inWindow = np.zeros(p.Nlam, bool)
        for ln in self.lines:
            inWindow[ln.lo:ln.hi] = True
        self.prdRows = torch.as_tensor(np.nonzero(inWindow)[0], device=dev)
        muz = np.asarray(atmos.muz, np.float64)
        self.fac = torch.as_tensor(doppler_factors(
            np.asarray(atmos.vlos, np.float64), muz), dtype=F64,
            device=dev)                                  # [2, Nmu, Nk]
        self.sub = torch.as_tensor(hprd_subset(
            lam, inWindow, doppler_factors(np.asarray(vlosAll, np.float64),
                                           muz), dev), device=dev)
        self.wmu2 = 0.5 * p.wmu

    # ---- the pieces of a step --------------------------------------------
    def comoving(self, line: PrdLine, rho):
        """rho [W, Nk] at each ray's comoving wavelength: [2, W, Nmu, Nk]."""
        x = (line.lam[None, None, None, :]
             * self.fac[..., None])                      # [2, Nmu, Nk, W]
        out = interp_rows(x, line.lam, rho.T)            # [2, Nmu, Nk, W]
        return out.permute(0, 3, 1, 2)

    def with_rho(self, rho) -> Problem:
        """The Problem with each PRD line's Uji and Vji scaled by its
        comoving rho."""
        atoms = [dataclasses.replace(a, trans=list(a.trans))
                 for a in self.p.atoms]
        active = [a for a in atoms if a.active]
        for line, r in zip(self.lines, rho):
            t = active[line.ai].trans[line.ti]
            rc = self.comoving(line, r)
            active[line.ai].trans[line.ti] = dataclasses.replace(
                t, Uji=t.Uji * rc, Vji=t.Vji * rc)
        return dataclasses.replace(self.p, atoms=atoms)

    def rest_frame_J(self, lam, Is):
        """JRest [Nprd, Nk] from the rays' spectra Is[d] [n, Nmu, Nk] on the
        wavelengths lam [n]."""
        x = self.p.wavelength[self.prdRows]
        JRest = 0.0
        for d in (0, 1):
            xp = lam[None, None, :] * self.fac[d][..., None]  # [Nmu, Nk, n]
            Ir = interp_rows(x, xp, Is[d].permute(1, 2, 0))   # [Nmu, Nk, Nprd]
            JRest = JRest + (self.wmu2[:, None, None] * Ir).sum(dim=0)
        return JRest.T.contiguous()

    def _positions(self, rows):
        """Per grid row its position among ``rows`` (-1: none)."""
        pos = torch.full((self.p.Nlam,), -1, dtype=torch.int64,
                         device=rows.device)
        pos[rows] = torch.arange(rows.shape[0], device=rows.device)
        return pos

    def _rates(self, t, pos, Is):
        """(Rij, Rji) [Nk] of transition t from the rays Is[d], whose row of
        grid row r is pos[r] (every row of t's window among them)."""
        r = pos[t.lo:t.hi]
        w = t.wla[:, None, :] * self.wmu2[None, :, None]
        ij = ji = 0.0
        for d in (0, 1):
            Uji, Vij, Vji = mali._rows(t, t.lo, t.hi, d, None)
            ij = ij + (Vij * Is[d][r] * w).sum(dim=(0, 1))
            ji = ji + ((Uji + Vji * Is[d][r]) * w).sum(dim=(0, 1))
        return ij, ji

    def full_solution(self, J, pops, rho):
        """The MALI step's formal solution: J, Gamma per active atom, the
        rates and JRest."""
        p = self.with_rho(rho)
        Jnew = torch.zeros_like(J)
        Gammas = [a.C.clone() for a in p.active]
        Is = []
        for d in (0, 1):
            chi, S = mali.opacity(p, pops, J, d)
            I, Psi = mali.solve_1d(p, chi, S, d)
            Jnew += (self.wmu2[None, :, None] * I).sum(dim=1)
            for ai, (a, n) in enumerate((a, n) for a, n in zip(p.atoms, pops)
                                        if a.active):
                mali._accumulate(p, a, n, I, Psi, d, Gammas[ai], self.wmu2)
            Is.append(I)
        for G in Gammas:
            off = G * (1.0 - torch.eye(G.shape[0], dtype=G.dtype,
                                       device=G.device)[:, :, None])
            G.copy_(off - torch.diag_embed(off.sum(dim=0).T).permute(1, 2, 0))
        pos = torch.arange(p.Nlam, device=J.device)
        rates = [tuple(map(list, zip(*(self._rates(t, pos, Is)
                                       for t in a.trans))))
                 for a in p.active]
        return Jnew, Gammas, rates, self.rest_frame_J(p.wavelength, Is)

    def subset_solution(self, J, pops, rho, rates):
        """The PRD-only formal solution on the subset rows: J there, JRest
        and the PRD lines' rates updated, the rest as it was."""
        p = self.with_rho(rho)
        sub = self.sub
        ps = dataclasses.replace(p, wavelength=p.wavelength[sub],
                                 Nlam=sub.shape[0])
        Jsub = torch.zeros((sub.shape[0], p.Nk), dtype=F64, device=J.device)
        Is = []
        for d in (0, 1):
            chi, S = mali.opacity(p, pops, J, d)
            I, _ = mali.solve_1d(ps, chi[sub], S[sub], d)
            Jsub += (self.wmu2[None, :, None] * I).sum(dim=1)
            Is.append(I)
        J = J.clone()
        J[sub] = Jsub
        pos = self._positions(sub)
        rates = [(list(ij), list(ji)) for ij, ji in rates]
        for line in self.lines:
            t = p.active[line.ai].trans[line.ti]
            ij, ji = self._rates(t, pos, Is)
            rates[line.ai][0][line.ti] = ij
            rates[line.ai][1][line.ti] = ji
        return J, self.rest_frame_J(ps.wavelength, Is), rates

    def new_rho(self, line: PrdLine, JRest, rates, pops):
        """rho of ``line`` from JRest, the rates and the populations."""
        a = self.p.active[line.ai]
        n = [n for n, on in zip(pops, self.active) if on][line.ai]
        Rij, Rji = rates[line.ai]
        out = line.Qelast + a.C[:, line.j, :].sum(dim=0)
        for t2i, t2 in enumerate(a.trans):
            if t2.j == line.j:
                out = out + Rji[t2i]
            if t2.i == line.j:
                out = out + Rij[t2i]
        gamma = n[line.i] / n[line.j] * line.Bij / out
        Jbar = Rij[line.ti] / line.Bij
        r0 = int(torch.searchsorted(self.prdRows, line.lo))
        Jw = JRest[r0:r0 + line.hi - line.lo]
        return scattering_rho(line, Jw, gamma, Jbar)

    # ---- the check's protocol ----------------------------------------------
    def start(self) -> dict:
        p = self.p
        return {'J': torch.zeros((p.Nlam, p.Nk), dtype=F64,
                                 device=p.wavelength.device),
                'pops': [a.n0 for a in p.atoms],
                'rho': [torch.ones((ln.hi - ln.lo, p.Nk), dtype=F64,
                                   device=p.wavelength.device)
                        for ln in self.lines]}

    def scatter(self, state: dict) -> dict:
        J = self.full_solution(state['J'], state['pops'], state['rho'])[0]
        return dict(state, J=J)

    def step(self, state: dict) -> dict:
        """One MALI step and its PRD sub-iterations: the batch's count where
        the state carries one, else until this column's drho < tol or the
        most allowed."""
        J, Gammas, rates, JRest = self.full_solution(
            state['J'], state['pops'], state['rho'])
        pops = mali.stat_equil(self.p, Gammas, state['pops'])
        rho = state['rho']
        count = state.get('prd_subiters')
        n = 0
        while True:
            n += 1
            new = [self.new_rho(ln, JRest, rates, pops) for ln in self.lines]
            dRho = max(float(torch.where(r != 0.0, torch.abs((r - r0) / r),
                                         0.0).max())
                       for r, r0 in zip(new, rho))
            rho = new
            J, JRest, rates = self.subset_solution(J, pops, rho, rates)
            if (n == count if count is not None
                    else (dRho < self.tol or n == self.maxIter)):
                break
        return {'J': J, 'pops': pops, 'Gamma': Gammas, 'rho': rho,
                'JRest': JRest, 'prd_subiters': n}

    def resume(self, kept: dict) -> dict:
        """The state of the program's ``kept`` (J, the active atoms'
        populations, rho, JRest, and the sub-iterations its step took); the
        passive atoms keep their LTE populations."""
        dev = self.p.wavelength.device

        def t_(x):
            return torch.as_tensor(x, dtype=F64, device=dev)
        given = iter(kept['pops'])
        pops = [t_(next(given)) if on else a.n0
                for a, on in zip(self.p.atoms, self.active)]
        return {'J': t_(kept['J']), 'pops': pops,
                'rho': [t_(r) for r in kept['rho']],
                'JRest': t_(kept['JRest']),
                'prd_subiters': int(np.asarray(kept['prd_subiters'])[0])}

    def compared(self, state: dict) -> dict:
        """J, the active atoms' populations, Gamma, rho, JRest and the
        sub-iterations as numpy."""
        return {'J': state['J'].cpu().numpy(),
                'pops': [n.cpu().numpy() for n, on in
                         zip(state['pops'], self.active) if on],
                'Gamma': [G.cpu().numpy() for G in state['Gamma']],
                'rho': [r.cpu().numpy() for r in state['rho']],
                'JRest': state['JRest'].cpu().numpy(),
                'prd_subiters': np.array([float(state['prd_subiters'])])}
