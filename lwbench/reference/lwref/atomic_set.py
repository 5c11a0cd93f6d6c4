"""Radiative set configuration: LTE populations, species state, global
wavelength grid.

ref: lightweaver/atomic_set.py
"""
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from . import constants as Const
from .atomic_model import AtomicModel
from .atomic_table import (AtomicAbundance, DefaultAtomicAbundance, Element,
                           PeriodicTable)


def lte_pops(atomicModel: AtomicModel, temperature: np.ndarray,
             ne: np.ndarray, nTotal: np.ndarray,
             debye: bool = True) -> np.ndarray:
    """Saha-Boltzmann LTE populations [Nlevel, Nspace] with optional Debye
    ionisation-energy lowering.
    ref: lightweaver/atomic_set.py:19-81 (vectorized here)
    """
    levels = atomicModel.levels
    Nlevel = len(levels)
    energies = np.array([l.E_SI for l in levels])
    gs = np.array([l.g for l in levels])
    stages = np.array([l.stage for l in levels])

    c1 = (Const.HPlanck / (2.0 * np.pi * Const.MElectron)
          * (Const.HPlanck / Const.KBoltzmann))

    nDebye = np.zeros(Nlevel)
    if debye:
        c2 = (np.sqrt(8.0 * np.pi / Const.KBoltzmann)
              * (Const.QElectron ** 2 / (4.0 * np.pi * Const.Epsilon0)) ** 1.5)
        for i in range(1, Nlevel):
            Z = stages[i]
            for m in range(1, stages[i] - stages[0] + 1):
                nDebye[i] += Z
                Z += 1
        dEion = c2 * np.sqrt(ne / temperature)           # [Nspace]
    else:
        dEion = np.zeros_like(ne)

    dE = energies - energies[0]
    gi0 = gs / gs[0]
    dZ = stages - stages[0]

    dE_kT = (dE[:, None] - nDebye[:, None] * dEion[None, :]) \
        / (Const.KBoltzmann * temperature[None, :])
    cNe_T = 0.5 * ne * (c1 / temperature) ** 1.5         # [Nspace]
    rel = gi0[:, None] * np.exp(-dE_kT) / cNe_T[None, :] ** dZ[:, None]
    rel[0, :] = 1.0
    total = np.sum(rel, axis=0)
    nStar = rel * (nTotal / total)[None, :]
    return nStar


def hminus_pops(atmos, hPops: np.ndarray) -> np.ndarray:
    """H- populations from Saha against total H.
    ref: lightweaver/atomic_set.py:1091-1115"""
    CI = (Const.HPlanck / (2.0 * np.pi * Const.MElectron)
          * (Const.HPlanck / Const.KBoltzmann))
    PhiHmin = (0.25 * (CI / atmos.temperature) ** 1.5
               * np.exp(Const.E_ION_HMIN
                        / (Const.KBoltzmann * atmos.temperature)))
    return atmos.ne * np.sum(hPops, axis=0) * PhiHmin


@dataclass
class AtomicState:
    """Populations (LTE + optionally NLTE) of one species."""
    model: AtomicModel
    abundance: float
    nStar: np.ndarray
    nTotal: np.ndarray
    detailed: bool = False
    pops: Optional[np.ndarray] = None

    @property
    def element(self) -> Element:
        return self.model.element

    @property
    def name(self) -> str:
        return self.element.name

    @property
    def n(self) -> np.ndarray:
        return self.pops if self.pops is not None else self.nStar

    def update_nTotal(self, atmos):
        self.nTotal[:] = self.abundance * atmos.nHTot


class AtomicStateTable:
    def __init__(self, states: List[AtomicState]):
        self.states = sorted(states, key=lambda s: s.element)
        self.byElement = {s.element: s for s in self.states}

    def __iter__(self):
        return iter(self.states)

    def __contains__(self, key) -> bool:
        try:
            e = PeriodicTable.element(key)
        except (KeyError, TypeError):
            return False
        return e in self.byElement

    def __getitem__(self, key) -> AtomicState:
        return self.byElement[PeriodicTable.element(key)]


@dataclass
class SpeciesStateTable:
    """All population state: atomic species, H-, and molecules."""
    atmosphere: object
    abundance: AtomicAbundance
    atomicPops: AtomicStateTable
    HminPops: np.ndarray
    molecularTable: object = None
    molecularPops: object = None      # [Nmol, Nspace] or None

    def __getitem__(self, name) -> np.ndarray:
        if isinstance(name, str) and name == 'H-':
            return self.HminPops
        if (self.molecularTable is not None and name in self.molecularTable
                and self.molecularPops is not None):
            return self.molecularPops[self.molecularTable.indices[
                name.upper()]]
        if name in self.atomicPops:
            return self.atomicPops[name].n
        raise LookupError(f'Species "{name}" not found')

    def __contains__(self, name) -> bool:
        if name == 'H-' or name in self.atomicPops:
            return True
        return (self.molecularTable is not None
                and name in self.molecularTable)

    def update_lte_atoms_Hmin_pops(self, atmos, conserveCharge=False,
                                   updateTotals=False, maxIter=2000,
                                   quiet=True, tol=1e-3):
        """Refresh LTE populations (and optionally ne) after the atmosphere
        changed."""
        if updateTotals:
            for atom in self.atomicPops:
                atom.update_nTotal(atmos)
        for it in range(maxIter):
            maxDiff = 0.0
            ne = np.zeros_like(atmos.ne)
            for atom in self.atomicPops:
                new = lte_pops(atom.model, atmos.temperature, atmos.ne,
                               atom.nTotal, debye=True)
                diff = np.nanmax(np.abs(1.0 - atom.nStar / new))
                maxDiff = max(maxDiff, diff)
                atom.nStar[:] = new
                if conserveCharge:
                    stages = np.array([l.stage for l in atom.model.levels])
                    n = atom.n if atom.pops is not None else atom.nStar
                    ne += np.sum(n * stages[:, None], axis=0)
            if conserveCharge:
                atmos.ne[:] = np.maximum(ne, 1e6)
            if maxDiff < tol:
                break
        else:
            raise ValueError('No convergence in LTE update')
        self.HminPops[:] = hminus_pops(atmos, self.atomicPops['H'].n)


@dataclass
class SpectrumConfiguration:
    """Global wavelength grid and per-transition active windows."""
    radSet: 'RadiativeSet'
    wavelength: np.ndarray
    models: List[AtomicModel]
    transWavelengths: Dict[Tuple[Element, int, int], np.ndarray]
    blueIdx: Dict[Tuple[Element, int, int], int]
    redIdx: Dict[Tuple[Element, int, int], int]
    activeTrans: Dict[Tuple[Element, int, int], bool]
    activeWavelengths: Dict[Tuple[Element, int, int], np.ndarray]

    @property
    def Nspect(self) -> int:
        return self.wavelength.shape[0]

    def subset_configuration(self, wavelengths,
                             expandLineGridsNm: float = 0.0) \
            -> 'SpectrumConfiguration':
        """A configuration over a subset grid where every transition is
        active everywhere (for final synthesis / compute_rays).
        ref: lightweaver/atomic_set.py:209-257"""
        wavelengths = np.asarray(wavelengths)
        transGrids = {}
        blueIdx = {}
        redIdx = {}
        activeWl = {}
        activeTrans = {}
        for ident in self.transWavelengths:
            blueIdx[ident] = 0
            redIdx[ident] = wavelengths.shape[0]
            transGrids[ident] = np.copy(wavelengths)
            activeWl[ident] = np.ones_like(wavelengths, dtype=bool)
            activeTrans[ident] = True
        return SpectrumConfiguration(radSet=self.radSet,
                                     wavelength=wavelengths,
                                     models=self.models,
                                     transWavelengths=transGrids,
                                     blueIdx=blueIdx, redIdx=redIdx,
                                     activeTrans=activeTrans,
                                     activeWavelengths=activeWl)


class RadiativeSet:
    """Configure which atoms are active / detailed static / passive, then
    build the wavelength grid and initial populations.
    ref: lightweaver/atomic_set.py:713-1025
    """

    def __init__(self, atoms: List[AtomicModel],
                 abundance: AtomicAbundance = DefaultAtomicAbundance):
        self.abundance = abundance
        self.elements = [a.element for a in atoms]
        self.atoms: Dict[Element, AtomicModel] = dict(zip(self.elements, atoms))
        if len(self.atoms) != len(atoms):
            raise ValueError('Multiple models for the same element')
        self.passiveSet: Set[Element] = set(self.elements)
        self.detailedStaticSet: Set[Element] = set()
        self.activeSet: Set[Element] = set()

    def __getitem__(self, name) -> AtomicModel:
        return self.atoms[PeriodicTable.element(name)]

    def __contains__(self, name) -> bool:
        try:
            return PeriodicTable.element(name) in self.atoms
        except KeyError:
            return False

    def __iter__(self):
        return iter(self.atoms.values())

    def _elems(self, args):
        return [PeriodicTable.element(name) for name in set(args)]

    def set_active(self, *args):
        for x in self._elems(args):
            self.activeSet.add(x)
            self.detailedStaticSet.discard(x)
            self.passiveSet.discard(x)

    def set_detailed_static(self, *args):
        for x in self._elems(args):
            self.detailedStaticSet.add(x)
            self.activeSet.discard(x)
            self.passiveSet.discard(x)

    def set_passive(self, *args):
        for x in self._elems(args):
            self.passiveSet.add(x)
            self.activeSet.discard(x)
            self.detailedStaticSet.discard(x)

    def is_active(self, name) -> bool:
        return PeriodicTable.element(name) in self.activeSet

    def is_passive(self, name) -> bool:
        return PeriodicTable.element(name) in self.passiveSet

    def is_detailed(self, name) -> bool:
        return PeriodicTable.element(name) in self.detailedStaticSet

    @property
    def activeAtoms(self) -> List[AtomicModel]:
        return sorted((self.atoms[e] for e in self.activeSet),
                      key=lambda a: a.element)

    @property
    def detailedAtoms(self) -> List[AtomicModel]:
        return sorted((self.atoms[e] for e in self.detailedStaticSet),
                      key=lambda a: a.element)

    @property
    def passiveAtoms(self) -> List[AtomicModel]:
        return sorted((self.atoms[e] for e in self.passiveSet),
                      key=lambda a: a.element)

    def compute_eq_pops(self, atmos, mols=None,
                        nlteStartingPops: Optional[Dict] = None) \
            -> SpeciesStateTable:
        """Initial populations: LTE everywhere (or provided NLTE starting
        pops for active/detailed species); with a MolecularTable, the
        molecular chemical equilibrium is solved and molecule-forming
        nuclei rescaled."""
        nlteStartingPops = nlteStartingPops or {}
        states = []
        for a in sorted(self.atoms.values(), key=lambda a: a.element):
            ele = a.element
            nTotal = self.abundance[ele] * atmos.nHTot
            nStar = lte_pops(a, atmos.temperature, atmos.ne, nTotal,
                             debye=True)
            if ele in self.passiveSet:
                states.append(AtomicState(model=a,
                                          abundance=self.abundance[ele],
                                          nStar=nStar, nTotal=nTotal))
            else:
                pops = (np.copy(nlteStartingPops[ele])
                        if ele in nlteStartingPops else np.copy(nStar))
                states.append(AtomicState(model=a,
                                          abundance=self.abundance[ele],
                                          nStar=nStar, nTotal=nTotal,
                                          detailed=True, pops=pops))
        table = AtomicStateTable(states)
        if mols is not None and len(mols) > 0:
            molPops = chemical_equilibrium_fixed_ne(atmos, mols, table,
                                                    self.abundance)
            HminPops = hminus_pops(atmos, table['H'].n)
            return SpeciesStateTable(atmosphere=atmos,
                                     abundance=self.abundance,
                                     atomicPops=table, HminPops=HminPops,
                                     molecularTable=mols,
                                     molecularPops=molPops)
        HminPops = hminus_pops(atmos, table['H'].n)
        return SpeciesStateTable(atmosphere=atmos, abundance=self.abundance,
                                 atomicPops=table, HminPops=HminPops)

    def iterate_lte_ne_eq_pops(self, atmos, mols=None,
                               nlteStartingPops: Optional[Dict] = None,
                               direct: bool = False,
                               tol: float = 1e-3,
                               quiet: bool = True) -> SpeciesStateTable:
        """Compute starting populations with a *self-consistent LTE
        electron density*: iterate ne = sum_atoms sum_levels stage * n*
        to a fixpoint (updating the Debye-lowered LTE populations each
        sweep), overwriting ``atmos.ne`` with the solution.

        ``direct=True`` uses plain damped fixpoint iteration; the
        default solves the residual with scipy's Newton-Krylov, which
        needs far fewer evaluations.

        ref: lightweaver/atomic_set.py:851-963 and the
        LteNeIterator at :125-161.
        """
        nlteStartingPops = nlteStartingPops or {}
        for e in nlteStartingPops:
            if e not in self.activeSet and e not in self.detailedStaticSet:
                raise ValueError(
                    f'Provided NLTE populations for {e} assumed LTE')
        atoms = sorted(self.atoms.values(), key=lambda a: a.element)
        nTotals = [self.abundance[a.element] * atmos.nHTot for a in atoms]
        stages = [np.array([l.stage for l in a.levels]) for a in atoms]

        def ne_from(ne):
            """One sweep: LTE pops at the trial ne -> implied ne."""
            out = np.zeros_like(ne)
            for a, nTotal, stg in zip(atoms, nTotals, stages):
                nStar = lte_pops(a, atmos.temperature, ne, nTotal,
                                 debye=True)
                if a.element in nlteStartingPops:
                    nStar = nlteStartingPops[a.element]
                out += np.sum(nStar * stg[:, None], axis=0)
            return out

        ne = np.copy(np.asarray(atmos.ne, np.float64))
        if direct:
            # plain fixpoint sweeps, accelerated every third sweep by
            # per-point Aitken's delta-squared (the iteration is linearly
            # convergent with rate ~0.997 on FAL-C, so raw sweeps alone
            # need thousands of iterations)
            hist = []
            for it in range(3000):
                neNew = ne_from(ne)
                relDiff = np.nanmax(np.abs(1.0 - ne / neNew))
                hist.append(neNew)
                if len(hist) == 3:
                    n0, n1, n2 = hist
                    d1, d0 = n2 - n1, n1 - n0
                    denom = d1 - d0
                    safe = np.abs(denom) > 1e-12 * np.abs(n2)
                    accel = n2 - np.where(safe, d1 ** 2
                                          / np.where(safe, denom, 1.0), 0.0)
                    neNew = np.where(accel > 0, accel, n2)
                    hist = []
                ne = neNew
                if relDiff < tol:
                    break
            else:
                from .utils import ConvergenceError
                raise ConvergenceError('LTE ne failed to converge')
            if not quiet:
                print(f'Iterate LTE: {it} iterations')
        else:
            from scipy.optimize import NoConvergence, newton_krylov
            nHTot = np.asarray(atmos.nHTot, np.float64)

            def residual(neRatio):
                # clip: Krylov trial steps may go non-positive, which
                # the Debye-shift sqrt in lte_pops cannot take
                neTrial = np.maximum(neRatio, 1e-30) * nHTot
                return ne_from(neTrial) / nHTot - neRatio

            neRatio = ne / nHTot
            neRatio = neRatio + residual(neRatio)
            try:
                neRatio = newton_krylov(residual, neRatio, f_tol=tol * 1e-2)
                ne = np.maximum(neRatio, 1e-30) * nHTot
                # Newton-Krylov tolerance is absolute in ne/nHTot; where
                # that ratio is small (deep photosphere ~1e-4) the
                # *relative* error can still be percent-level, so polish
                # with plain fixpoint sweeps to the relative tolerance.
                for _ in range(100):
                    neNew = ne_from(ne)
                    relDiff = np.nanmax(np.abs(1.0 - ne / neNew))
                    ne = neNew
                    if relDiff < tol * 0.1:
                        break
            except NoConvergence:
                # fall back to the (always-convergent, slower) fixpoint
                return self.iterate_lte_ne_eq_pops(
                    atmos, mols=mols, nlteStartingPops=nlteStartingPops,
                    direct=True, tol=tol, quiet=quiet)
        atmos.ne[:] = ne

        return self.compute_eq_pops(atmos, mols=mols,
                                    nlteStartingPops=nlteStartingPops)

    def compute_wavelength_grid(self, extraWavelengths=None,
                                lambdaReference: float = 500.0) \
            -> SpectrumConfiguration:
        """Union grid of all active/detailed transition quadratures with
        per-transition blue/red windows.
        ref: lightweaver/atomic_set.py:1027-1088"""
        if len(self.activeSet) == 0 and len(self.detailedStaticSet) == 0:
            raise ValueError('Need at least one active or detailed atom')
        extraGrids = []
        if extraWavelengths is not None:
            extraGrids.append(np.asarray(extraWavelengths))
        extraGrids.append(np.array([lambdaReference]))

        models: List[AtomicModel] = []
        ids = []
        grids = []
        for ele in sorted(self.activeSet | self.detailedStaticSet):
            atom = self.atoms[ele]
            models.append(atom)
            for trans in atom.transitions:
                grids.append(trans.wavelength())
                ids.append(trans.transId)

        grid = np.unique(np.concatenate(grids + extraGrids))
        blueIdx = {}
        redIdx = {}
        transGrids = {}
        for ident, g in zip(ids, grids):
            blueIdx[ident] = int(np.searchsorted(grid, g[0]))
            redIdx[ident] = int(np.searchsorted(grid, g[-1]) + 1)
            transGrids[ident] = np.copy(grid[blueIdx[ident]:redIdx[ident]])

        activeWavelengths = {k: ((grid >= v[0]) & (grid <= v[-1]))
                             for k, v in transGrids.items()}
        activeTrans = {k: True for k in transGrids}
        return SpectrumConfiguration(radSet=self, wavelength=grid,
                                     models=models,
                                     transWavelengths=transGrids,
                                     blueIdx=blueIdx, redIdx=redIdx,
                                     activeTrans=activeTrans,
                                     activeWavelengths=activeWavelengths)


def chemical_equilibrium_fixed_ne(atmos, molecules, atomicPops,
                                  abundance) -> np.ndarray:
    """Molecular number densities at fixed ne: Newton-Raphson on the
    coupled (nuclei, molecules) system per depth point, batched over
    depth.  Scales the atomic populations of molecule-forming nuclei so
    free + bound-in-molecules nuclei are conserved, and returns the
    molecular populations [Nmol, Nspace].
    ref: lightweaver/atomic_set.py:1117-1279
    """
    from .atomic_table import KuruczPfTable

    nucleiSet = set()
    for mol in molecules:
        nucleiSet |= set(mol.elements)
    nuclei = sorted(nucleiSet)
    if not nuclei:
        return np.zeros((0, atmos.Nspace))
    from .atomic_table import PeriodicTable
    if nuclei[0] != PeriodicTable.element(1):
        raise ValueError('H not in list of nuclei -- check H2 molecule')

    nuclIndex = [[nuclei.index(e) for e in mol.elements]
                 for mol in molecules]
    kurucz = KuruczPfTable(atomicAbundance=abundance)

    Nk = atmos.Nspace
    Nnuc = len(nuclei)
    Nmol = len(molecules)
    Neqn = Nnuc + Nmol

    # abundances and neutral fractions per nucleus [Nnuc, Nk]
    a = np.empty((Nnuc, Nk))
    fn0 = np.empty((Nnuc, Nk))
    for i, nuc in enumerate(nuclei):
        if nuc in atomicPops:
            st = atomicPops[nuc]
            a[i] = st.abundance * atmos.nHTot
            stages = np.array([l.stage for l in st.model.levels])
            fn0[i] = (st.n[stages == 0].sum(axis=0) / st.nTotal)
        else:
            pf = kurucz[nuc]
            a[i] = pf.abundance * atmos.nHTot
            fj, _ = pf.fj(atmos)
            fn0[i] = fj[0]

    CI = (Const.HPlanck / (2.0 * np.pi * Const.MElectron)
          * (Const.HPlanck / Const.KBoltzmann))
    PhiHmin = (0.25 * (CI / atmos.temperature) ** 1.5
               * np.exp(Const.E_ION_HMIN
                        / (Const.KBoltzmann * atmos.temperature)))
    fHmin = atmos.ne * fn0[0] * PhiHmin                      # [Nk]

    Phi = np.stack([mol.equilibrium_constant(atmos.temperature)
                    for mol in molecules])                   # [Nmol, Nk]

    n = np.concatenate([a, np.zeros((Nmol, Nk))])            # [Neqn, Nk]
    n[:Nnuc] = a
    for it in range(50):
        prevN = n.copy()
        f = n.copy()
        f[:Nnuc] -= a
        df = np.zeros((Nk, Neqn, Neqn))
        df[:, np.arange(Neqn), np.arange(Neqn)] = 1.0
        f[0] += fHmin * n[0]
        df[:, 0, 0] += fHmin

        for i, mol in enumerate(molecules):
            saha = Phi[i].copy()
            for j, ele in enumerate(mol.elements):
                nu = nuclIndex[i][j]
                saha = saha * (fn0[nu] * n[nu]) ** mol.elementCount[j]
                f[nu] += mol.elementCount[j] * n[Nnuc + i]
            if mol.charge:
                saha = saha / atmos.ne ** mol.charge
            f[Nnuc + i] -= saha
            for j, ele in enumerate(mol.elements):
                nu = nuclIndex[i][j]
                df[:, nu, Nnuc + i] += mol.elementCount[j]
                df[:, Nnuc + i, nu] = -saha * (mol.elementCount[j]
                                               / np.maximum(n[nu], 1e-300))

        corr = np.linalg.solve(df, f.T[..., None])[..., 0].T
        n -= corr
        n[:Nnuc] = np.maximum(n[:Nnuc], 1e-300)
        ratio = np.where(n != 0.0, prevN / np.where(n != 0.0, n, 1.0), 1.0)
        dnMax = np.nanmax(np.abs(1.0 - ratio))
        if dnMax <= 1e-3:
            break
    else:
        raise ValueError(f'ChemEq iteration not converged: dnMax={dnMax}')

    # rescale atomic populations of molecule-forming species
    for i, ele in enumerate(nuclei):
        if ele in atomicPops:
            st = atomicPops[ele]
            fraction = n[i] / st.nTotal
            st.nStar *= fraction[None, :]
            st.nTotal *= fraction
            if st.pops is not None:
                st.pops *= fraction[None, :]

    return n[Nnuc:]
