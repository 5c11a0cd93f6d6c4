"""lightweaver_tpu_torch: the PyTorch/CUDA port of lightweaver_tpu.

MALI NLTE synthesis for optically-thick spectral lines in stratified
atmospheres, as in lightweaver_tpu (the JAX package, kept as the
reference), running on PyTorch with hand-written CUDA kernels for an
NVIDIA Hopper GPU.  The port never imports jax.

Ported so far: the 1D MALI main path (the linear, Bezier-3 and BESSER
formal solvers, factored Gamma, Ng on the populations, charge
conservation, time-dependent updates) with complete redistribution,
angle-averaged PRD and hybrid PRD
(Context.prd_redistribute, iterate_ctx_se(ctx, prd=True)), the depth
sweep as the CUDA kernel csrc/sweep.cu, and the two iteration schemes of
Context.set_fs_iter_scheme with their kernels: 'mali_full_precond_pallas'
(the line Gamma kernel csrc/gamma.cu) and 'mali_full_precond_fused' (the
fused lambda step csrc/fused.cu), both with PRD's rho.  Each kernel has a
float64 and a float32 instance: Context(dtype=torch.float32) (or
lightweaverrc ``Precision: mixed``) runs the f32 state, with J, Gamma and
the rates in float64, as the JAX package's mixed precision does (hybrid
PRD excepted).  Like the JAX package, the default working precision is
float64.  The default device is the card ('cuda'); pass device='cpu' for
the CPU, where every kernel wrapper runs its plain PyTorch version.  Every
tensor is created with an explicit dtype and device rather than by
changing torch's global defaults.  From a converged state the Context
synthesises spectra: formal_sol, compute_rays and the full-Stokes
single_stokes_fs, with state_dict and pickling to carry the state.

``ref:`` comments name files of the upstream Lightweaver source tree
(``lightweaver/`` for its Python layer, ``Source/`` for its C++ core).
"""
from . import constants
from .atmosphere import (Atmosphere, BoundaryCondition, NoBc,
                         ThermalisedRadiation, ZeroRadiation)
from .atomic_set import RadiativeSet
from .context import DEFAULT_DTYPE, Context
from .fal import Falc82
from .iterate_ctx import iterate_ctx_se
from .iteration_update import IterationUpdate
from .ops.planck import planck_nu
from .rh_atoms import CaII_atom, H_6_atom, MgII_atom
from .utils import ConvergenceError, ExplodingMatrixError, InitialSolution

__version__ = '0.1.0'
