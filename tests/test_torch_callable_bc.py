"""A user-callable boundary condition whose data change between MALI
steps, the port's Context against the JAX Context.

The mixed-precision problem in float64 (FAL-C decimated to 40 depths, 3
rays, H 6-level + Ca II with Ca II active).  One end's BC is a
BoundaryCondition subclass whose compute_bc returns scale * B_nu(5000 K)
per (wavelength, mu); the scale goes from 1 to 100 between two
formal_sol_gamma_matrices calls.  Both Contexts evaluate the BC on every
call, so after the second step J and I agree at the slice tolerances of
tests/test_torch_slice.py: 1e-9 of each wavelength's maximum over depth
(J) or angle (I).  A Context that kept the first step's BC rows is ~0.3
away.  The fused scheme takes the rows as its 'data' boundary kind.
"""
import numpy as np
import pytest
import torch

import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.atmosphere import BoundaryCondition as JBoundaryCondition
from lightweaver_tpu.atomic_set import RadiativeSet as JRadiativeSet
from lightweaver_tpu.context import Context as JContext
from lightweaver_tpu_torch.atmosphere import BoundaryCondition
from lightweaver_tpu_torch.atomic_set import RadiativeSet
from lightweaver_tpu_torch.context import Context
from lightweaver_tpu_torch.problems import falc_decimated
from lightweaver_tpu_torch.rh_atoms import CaII_atom, H_6_atom

from tests.test_torch_f32 import _jax_falc_decimated

NSPACE, NRAYS = 40, 3
SCALES = (1.0, 100.0)
TOL = 1e-9
SCHEMES = ('mali_full_precond', 'mali_full_precond_fused')

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def planck_incident(lam_nm, Nrays, T=5000.0):
    """B_nu(T) [W m^-2 Hz^-1 sr^-1] per (wavelength, mu)."""
    h, c, kB = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    nu = c / (np.asarray(lam_nm) * 1e-9)
    B = 2 * h * nu ** 3 / c ** 2 / np.expm1(h * nu / (kB * T))
    return np.broadcast_to(B[:, None], (len(B), Nrays)).copy()


class ScaledPlanck(BoundaryCondition):
    scale = 1.0

    def compute_bc(self, atmos, spect):
        return self.scale * planck_incident(spect.wavelength, atmos.Nrays)


class JScaledPlanck(JBoundaryCondition):
    scale = 1.0

    def compute_bc(self, atmos, spect):
        return self.scale * planck_incident(spect.wavelength, atmos.Nrays)


def _contexts(end, scheme):
    """The JAX and the port's Context of the problem with a callable BC at
    ``end`` ('upper' or 'lower'), under ``scheme``."""
    bcs = (JScaledPlanck(), ScaledPlanck())
    ctxs = []
    for atmos, bc, rs, ctxCls, kw in (
            (_jax_falc_decimated(NSPACE), bcs[0],
             JRadiativeSet([jatoms.H_6_atom(), jatoms.CaII_atom()]),
             JContext, {}),
            (falc_decimated(NSPACE), bcs[1],
             RadiativeSet([H_6_atom(), CaII_atom()]), Context,
             {'device': 'cpu'})):
        setattr(atmos, f'{end}Bc', bc)
        atmos.quadrature(NRAYS)
        rs.set_active('Ca')
        spect = rs.compute_wavelength_grid()
        ctx = ctxCls(atmos, spect, rs.compute_eq_pops(atmos), **kw)
        ctx.set_fs_iter_scheme(scheme)
        ctxs.append(ctx)
    return bcs, ctxs


def _per_row_err(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    return (np.abs(ours - ref).max(axis=1) / np.abs(ref).max(axis=1)).max()


@pytest.mark.parametrize('end', ['upper', 'lower'])
@pytest.mark.parametrize('scheme', SCHEMES)
def test_changing_callable_bc_matches_jax(scheme, end):
    bcs, (jctx, tctx) = _contexts(end, scheme)
    Js = []
    for scale in SCALES:
        for bc in bcs:
            bc.scale = scale
        jctx.formal_sol_gamma_matrices()
        tctx.formal_sol_gamma_matrices()
        for key in ('J', 'I'):
            e = _per_row_err(getattr(tctx, key), getattr(jctx, key))
            assert e < TOL, (scale, key, e)
        Js.append(np.asarray(jctx.J))
    # the BC reaches J: the 100x brighter rows move it
    assert _per_row_err(Js[1], Js[0]) > 1e-2
