"""Drift guard: the port's model layer is a copy of lightweaver_tpu's.

The numpy model layer (atmospheres, atoms, background, collisions,
profiles' inputs) was copied into lightweaver_tpu_torch because importing
lightweaver_tpu pulls in jax.  These tests hold the copies to the
originals: the source text must match apart from the data-path lines
and the reference-path prefix of ``ref:`` comments, and the falc_h6ca inputs both packages derive must agree to 1e-12
(identical numpy code gives identical bits; 1e-12 leaves room for
torch's vs XLA's reduction order in wphi).  The profiles are the one
exception, see test_falc_h6ca_profiles_match_jax.
"""
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import lightweaver_tpu.ops.ng as jng
import lightweaver_tpu.rh_atoms as jatoms
import lightweaver_tpu_torch as tlw
import lightweaver_tpu_torch.ops.ng as tng
from lightweaver_tpu import Context as JContext
from lightweaver_tpu import Falc82 as JFalc82
from lightweaver_tpu import RadiativeSet as JRadiativeSet

ROOT = Path(__file__).resolve().parent.parent

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)

COPIED = ['constants', 'config', 'atomic_table', 'atmosphere', 'fal',
          'zeeman', 'broadening', 'ops/weno', 'collisional_rates',
          'atomic_model', 'rh_atoms', 'molecule', 'atomic_set', 'background',
          'iteration_update', 'iterate_ctx', 'wittmann_eos', 'multi',
          'utils/wavelength']

# the only edits the copies may carry: data tables are read from the JAX
# package's data directory through one helper
_ALLOWED = [
    ("DATA_DIR = Path(__file__).resolve().parent / 'data'\n",
     "from ._data import DATA_DIR\n"),
    ("_DATA = Path(__file__).resolve().parent / 'data'\n",
     "from ._data import DATA_DIR as _DATA\n"),
    ("np.load(Path(__file__).resolve().parent / 'data'\n"
     "                / 'wittmann_tables.npz')",
     "np.load(DATA_DIR / 'wittmann_tables.npz')"),
]
# and their ``ref:`` comments name upstream Lightweaver files relative to
# its source tree, without the originals' checkout prefix
_REF_PREFIX = re.compile(r'/\w+/reference/')


@pytest.mark.parametrize('module', COPIED)
def test_copy_matches_original(module):
    orig = (ROOT / 'lightweaver_tpu' / f'{module}.py').read_text()
    copy = (ROOT / 'lightweaver_tpu_torch' / f'{module}.py').read_text()
    for old, new in _ALLOWED:
        orig = orig.replace(old, new)
    orig = _REF_PREFIX.sub('', orig)
    assert copy == orig, f'{module}.py drifted from lightweaver_tpu'
    assert not re.search(r'^\s*(import|from)\s+(jax|lightweaver_tpu)\b',
                         copy, re.M)


@pytest.mark.parametrize('name', ['NgOptions', 'Ng'])
def test_ng_classes_match_original(name):
    """ops/ng.py copies the two host-side classes of the JAX package's
    ops/ng.py (not its device variants), source text and all."""
    assert (inspect.getsource(getattr(tng, name))
            == inspect.getsource(getattr(jng, name)))


def _h6ca(Falc82, RadiativeSet, Context, atoms, **kwargs):
    atmos = Falc82()
    atmos.quadrature(5)
    rs = RadiativeSet([atoms.H_6_atom(), atoms.CaII_atom()])
    rs.set_active('H', 'Ca')
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    return Context(atmos, spect, eqPops, **kwargs)


@pytest.fixture(scope='module')
def contexts():
    return (_h6ca(JFalc82, JRadiativeSet, JContext, jatoms),
            _h6ca(tlw.Falc82, tlw.RadiativeSet, tlw.Context, tlw,
                  device='cpu'))


def _close(ours, ref, rtol=1e-12):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=rtol,
                               atol=0.0)


def test_falc_h6ca_inputs_match_jax(contexts):
    """The port's counterpart of test_inputs_reproducible."""
    jctx, tctx = contexts
    _close(tctx.spect.wavelength, jctx.spect.wavelength)
    _close(tctx.cfg.wavelengthT, jctx.cfg.wavelength)
    for name in ('bgChi', 'bgEta', 'bgSca', 'temperature', 'height'):
        _close(getattr(tctx, name), getattr(jctx, name))
    for ia in range(2):
        _close(tctx.C[ia], jctx.C[ia])
        _close(tctx.popsState[ia]['n'], jctx.popsState[ia]['n'])
        _close(tctx.popsState[ia]['nStar'], jctx.popsState[ia]['nStar'])


def test_falc_h6ca_profiles_match_jax(contexts):
    """aDamp, phi and wphi of every line (Voigt in f64 on both sides).

    phi is held to 1e-12 of each line's peak, and pointwise to 1e-9, the
    Weideman approximation's own accuracy: in the far wings Re w(z) is
    ~a/v of |w|, so the jitted JAX Voigt (whose Horner steps XLA fuses)
    and the port's op-by-op evaluation of the same formula differ there
    by up to v/a ulps (1.03e-10 measured).  The op-by-op evaluations
    agree bitwise (test_torch_ops.py)."""
    jctx, tctx = contexts
    nLines = 0
    for ia, a in enumerate(tctx.activeAtoms):
        for it, t in enumerate(a.trans):
            if not t.isLine:
                assert tctx.phi[ia][it] is None
                continue
            nLines += 1
            _close(tctx.aDamp[ia][it], jctx.aDamp[ia][it])
            assert isinstance(tctx.phi[ia][it], torch.Tensor)
            phi, jphi = np.asarray(tctx.phi[ia][it]), np.asarray(
                jctx.phi[ia][it])
            assert np.abs(phi - jphi).max() <= 1e-12 * np.abs(jphi).max()
            _close(phi, jphi, rtol=1e-9)
            _close(tctx.wphi[ia][it], jctx.wphi[ia][it])
    assert nLines == 15


def _h6mg(Falc82, RadiativeSet, Context, atoms, **kwargs):
    atmos = Falc82()
    atmos.quadrature(5)
    rs = RadiativeSet([atoms.H_6_atom(), atoms.MgII_atom()])
    rs.set_active('H', 'Mg')
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    return Context(atmos, spect, eqPops, **kwargs)


def test_falc_h6mg_inputs_match_jax():
    """BASELINE config 3's PRD inputs: the wavelength grid, and per line
    the damping aDamp and elastic rate Qelast (PjQj's), the PRD flags."""
    jctx = _h6mg(JFalc82, JRadiativeSet, JContext, jatoms)
    tctx = _h6mg(tlw.Falc82, tlw.RadiativeSet, tlw.Context, tlw,
                 device='cpu')
    _close(tctx.spect.wavelength, jctx.spect.wavelength)
    nPrd = 0
    for ia, a in enumerate(tctx.activeAtoms):
        for it, t in enumerate(a.trans):
            assert t.isPrd == jctx.activeAtoms[ia].trans[it].isPrd
            if not t.isLine:
                assert tctx.Qelast[ia][it] is None
                continue
            nPrd += t.isPrd
            _close(tctx.aDamp[ia][it], jctx.aDamp[ia][it])
            _close(tctx.Qelast[ia][it], jctx.Qelast[ia][it])
    assert nPrd == 4
