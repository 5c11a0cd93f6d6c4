"""CRTAF (Common Radiative Transfer Atomic Format) model-atom import.

Standalone YAML parser for CRTAF v0.1 high-level files (the reference
delegates to the `crtaf` package, absent here; the field mapping mirrors
lightweaver/crtaf.py:12-190).
"""
from fractions import Fraction
from typing import Union

import numpy as np

from . import constants as Const
from .atomic_model import (AtomicLevel, AtomicModel, ExplicitContinuum,
                           HydrogenicContinuum, LinearCoreExpWings,
                           LinearQuadrature, LineBroadening, LineType,
                           TabulatedQuadrature, VoigtLine)
from .atomic_table import PeriodicTable
from .broadening import (HydrogenLinearStarkBroadening,
                         MultiplicativeStarkBroadening,
                         QuadraticStarkBroadening, RadiativeBroadening,
                         ScaledExponentBroadening, VdwUnsold)
from .collisional_rates import (CE, CH, CI, CP, ChargeExchangeNeutralH,
                                ChargeExchangeProton, Omega)

# unit -> (kind, factor to canonical): energies to cm-1, lengths to nm
_UNIT_FACTORS = {
    'cm-1': 1.0, '1 / cm': 1.0, '1/cm': 1.0,
    'eV': Const.EV / Const.HC * Const.CM_TO_M,
    'J': 1.0 / Const.HC * Const.CM_TO_M,
    'nm': 1.0, 'Angstrom': 0.1, 'AA': 0.1, 'A': 0.1,
    'm': 1.0 / Const.NM_TO_M, 'cm': 1e7,
    'K': 1.0, 's-1': 1.0, '1 / s': 1.0, '1/s': 1.0,
    'm2': 1.0, 'm^2': 1.0, 'cm2': 1e-4, 'cm^2': 1e-4,
    'm3 s-1 K(-1/2)': 1.0, 'm3 s-1': 1.0, 'm3 / s': 1.0,
    'cm3 s-1': 1e-6, 'cm3 / s': 1e-6,
    '': 1.0, None: 1.0,
}


def _q(node, expect=None):
    """Extract a quantity: {unit, value} dict or bare number/list."""
    if isinstance(node, dict) and 'value' in node:
        unit = node.get('unit', '')
        if unit not in _UNIT_FACTORS:
            raise ValueError(f'Unsupported CRTAF unit "{unit}"')
        fac = _UNIT_FACTORS[unit]
        v = node['value']
        # YAML 1.1 parses exponent literals without a sign (1.4e8) as
        # strings; coerce everything numeric
        if isinstance(v, (list, tuple)):
            return [float(x) * fac for x in v]
        return float(v) * fac
    if isinstance(node, (list, tuple)):
        return [float(x) for x in node]
    return float(node)


def _fraction(node):
    if node is None:
        return None
    if isinstance(node, dict):
        return Fraction(node['numerator'], node['denominator'])
    return Fraction(node)


def from_crtaf_dict(model: dict) -> AtomicModel:
    """Build an AtomicModel from a parsed CRTAF high-level dict."""
    meta = model.get('crtaf_meta', {})
    if meta.get('level', 'high-level') != 'high-level':
        raise ValueError('Only high-level CRTAF files are supported')

    levels = {}
    for label, lv in model['levels'].items():
        levels[label] = AtomicLevel(
            E=float(_q(lv['energy'])), g=float(lv['g']),
            label=lv.get('label', label) or label,
            stage=int(lv['stage']) - 1,
            J=_fraction(lv.get('J')), L=lv.get('L'),
            S=_fraction(lv.get('S')))
    labels = sorted(levels, key=lambda l: levels[l].E)
    idx = {label: i for i, label in enumerate(labels)}
    levelList = [levels[l] for l in labels]

    lines = []
    for ln in model.get('lines', []):
        ty = {'Voigt': LineType.CRD, 'PRD-Voigt': LineType.PRD}.get(
            ln['type'])
        if ty is None:
            raise ValueError(f'Unsupported line type {ln["type"]}')
        natural, elastic = [], []
        for b in ln.get('broadening', []):
            bt = b['type']
            if bt == 'Natural':
                natural.append(RadiativeBroadening(gamma=float(_q(b['value']))))
            elif bt == 'Stark_Linear_Sutton':
                elastic.append(HydrogenLinearStarkBroadening())
            elif bt == 'Stark_Multiplicative':
                elastic.append(MultiplicativeStarkBroadening(
                    coeff=float(_q(b['C_4']))))
            elif bt == 'Stark_Quadratic':
                elastic.append(QuadraticStarkBroadening(
                    coeff=float(b.get('scaling', 1.0))))
            elif bt == 'VdW_Unsold':
                elastic.append(VdwUnsold(vals=[b.get('H_scaling', 1.0),
                                               b.get('He_scaling', 1.0)]))
            elif bt == 'Scaled_Exponents':
                sb = ScaledExponentBroadening(
                    scaling=float(b['scaling']),
                    temperatureExp=float(b['temperature_exponent']),
                    hydrogenExp=float(b['hydrogen_exponent']),
                    electronExp=float(b['electron_exponent']))
                (elastic if b.get('elastic', True) else natural).append(sb)
            else:
                raise ValueError(f'Unsupported broadening type {bt}')

        g = ln['wavelength_grid']
        gt = g['type']
        if gt == 'Linear':
            quad = LinearQuadrature(Nlambda=int(g['n_lambda']),
                                    deltaLambda=float(_q(g['delta_lambda'])))
        elif gt == 'Tabulated':
            quad = TabulatedQuadrature(
                wavelengthGrid=list(_q(g['wavelengths'])))
        elif gt == 'LinearCoreExpWings':
            quad = LinearCoreExpWings(qCore=float(g['q_core']),
                                      qWing=float(g['q_wing']),
                                      Nlambda=int(g['n_lambda']))
        else:
            raise ValueError(f'Unsupported wavelength grid type {gt}')

        up, lo = ln['transition']
        lines.append(VoigtLine(
            j=idx[up], i=idx[lo], f=float(ln['f_value']), type=ty,
            quadrature=quad,
            broadening=LineBroadening(natural=natural, elastic=elastic)))

    continua = []
    for ct in model.get('continua', []):
        up, lo = ct['transition']
        if ct['type'] == 'Hydrogenic':
            continua.append(HydrogenicContinuum(
                j=idx[up], i=idx[lo], NlambdaGen=int(ct['n_lambda']),
                alpha0=float(_q(ct['sigma_peak'])),
                minWavelength=float(_q(ct['lambda_min']))))
        elif ct['type'] == 'Tabulated':
            lam = np.asarray(_q(ct['wavelengths']))
            sig = np.asarray(_q(ct['sigma']))
            continua.append(ExplicitContinuum(
                j=idx[up], i=idx[lo], wavelengthGrid=lam.tolist(),
                alphaGrid=sig.tolist()))
        else:
            raise ValueError(f'Unsupported continuum type {ct["type"]}')

    RATES = {'Omega': Omega, 'CI': CI, 'CE': CE, 'CH': CH, 'CP': CP,
             'ChargeExcH': ChargeExchangeNeutralH,
             'ChargeExcP': ChargeExchangeProton}
    collisions = []
    for coll in model.get('collisions', []):
        up, lo = coll['transition']
        for proc in coll['data']:
            cls = RATES.get(proc['type'])
            if cls is None:
                raise ValueError(
                    f'Unsupported collision type {proc["type"]}')
            collisions.append(cls(
                j=idx[up], i=idx[lo],
                temperature=list(_q(proc['temperature'])),
                rates=list(_q(proc['data']))))

    elem = model['element']
    return AtomicModel(element=PeriodicTable.element(elem['symbol']),
                       levels=levelList, lines=lines, continua=continua,
                       collisions=collisions)


def from_crtaf(source: Union[str, dict]) -> AtomicModel:
    """Import a CRTAF atom from a YAML path/string or parsed dict.
    ref: lightweaver/crtaf.py:12-190"""
    if isinstance(source, dict):
        return from_crtaf_dict(source)
    import os

    import yaml
    if os.path.exists(source):
        with open(source) as f:
            return from_crtaf_dict(yaml.safe_load(f))
    return from_crtaf_dict(yaml.safe_load(source))
