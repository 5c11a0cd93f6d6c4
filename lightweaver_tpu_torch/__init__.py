"""lightweaver_tpu_torch: the PyTorch/CUDA port of lightweaver_tpu.

MALI NLTE synthesis for optically-thick spectral lines in stratified
atmospheres, as in lightweaver_tpu (the JAX package, kept as the
reference), running on PyTorch with hand-written CUDA kernels for an
NVIDIA Hopper GPU.  The port never imports jax.

Ported so far: the 1D MALI main path (the linear, Bezier-3 and BESSER
formal solvers, factored and dense Gamma, Ng on the populations, charge
conservation, time-dependent updates, every initial solution, a custom
background provider) with complete redistribution, angle-averaged PRD and
hybrid PRD (Context.prd_redistribute, iterate_ctx_se(ctx, prd=True)), the
depth sweep as the CUDA kernel csrc/sweep.cu, and the two iteration
schemes of Context.set_fs_iter_scheme with their kernels:
'mali_full_precond_pallas' (the line Gamma kernel csrc/gamma.cu) and
'mali_full_precond_fused' (the fused lambda step csrc/fused.cu), both with
PRD's rho.  Each kernel has a float64 and a float32 instance:
Context(dtype=torch.float32) (or lightweaverrc ``Precision: mixed``) runs
the f32 state, with J, Gamma and the rates in float64 (or in float32 with
accumDtype=torch.float32), as the JAX package's mixed precision does.
Like the JAX package, the default working precision is float64.  The
default device is the card ('cuda'); pass device='cpu' for the CPU, where
every kernel wrapper runs its plain PyTorch version.  Every tensor is
created with an explicit dtype and device rather than by changing torch's
global defaults.  From a converged state the Context synthesises spectra:
formal_sol, compute_rays and the full-Stokes single_stokes_fs, with
state_dict and pickling to carry the state; depthData and utils'
postprocessing give the depth-resolved diagnostics.  The 1.5D column
batch (parallel.ColumnBatch) and 2D atmospheres run on one device.  The
exports are the JAX package's, but ``benchmark``.

``ref:`` comments name files of the upstream Lightweaver source tree
(``lightweaver/`` for its Python layer, ``Source/`` for its C++ core).
"""
from . import constants
from .ops.faddeeva import voigt_H, voigt_HF
from .ops.planck import planck_nu

__version__ = '0.1.0'

# the user-facing API surface: the JAX package's exports (the reference's
# package exports), but benchmark
from .atmosphere import (Atmosphere, BoundaryCondition, Layout, NoBc,
                         PeriodicRadiation, ScaleType, Stratifications,
                         ThermalisedRadiation, ZeroRadiation)
from .atomic_model import (AtomicLevel, AtomicLine, AtomicModel,
                           ExplicitContinuum, HydrogenicContinuum,
                           LinearCoreExpWings, LinearQuadrature,
                           LineProfileResult, LineProfileState, LineType,
                           TabulatedQuadrature, VoigtLine, gaunt_bf,
                           reconfigure_atom)
from .atomic_set import (RadiativeSet, SpectrumConfiguration, hminus_pops,
                         lte_pops)
from .molecule import MolecularTable
from .multi import read_multi_atmos
from .atomic_table import (AtomicAbundance, DefaultAtomicAbundance, Element,
                           Isotope, KuruczPfTable, PeriodicTable)
from .config import params as configParams
from .config import params as ConfigDict
from .context import DEFAULT_DTYPE, Context
from .fal import Falc82
from .iterate_ctx import (ConvergenceCriteria, DefaultConvergenceCriteria,
                          iterate_ctx_se)
from .iteration_update import IterationUpdate
from .ops.ng import NgOptions
from .rh_atoms import CaII_atom, H_6_atom, MgII_atom
from .utils import (ConvergenceError, CrswIterator, ExplodingMatrixError,
                    InitialSolution, UnityCrswIterator, air_to_vac,
                    compute_contribution_fn, compute_height_edges,
                    compute_radiative_losses, compute_wavelength_edges,
                    convert_specific_intensity, get_data_path,
                    get_default_molecule_path, integrate_line_losses, planck,
                    vac_to_air)

# the reference exposes nr_post_update as a free function monkeypatched
# onto Context (ref: lightweaver/__init__.py:28-33); here, as in the JAX
# package, it is a method, re-exported for drop-in compatibility
nr_post_update = Context.nr_post_update
