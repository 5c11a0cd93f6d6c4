"""Zeeman splitting: Lande factors and anomalous-splitting components.

Standard LS-coupling formalism (del Toro Iniesta 2003, ch. 7).
ref: lightweaver/zeeman.py
"""
from dataclasses import dataclass
from fractions import Fraction
from typing import Optional

import numpy as np


@dataclass
class ZeemanComponents:
    alpha: np.ndarray      # -1 (sigma_b), 0 (pi), +1 (sigma_r), int32
    strength: np.ndarray   # normalised within each alpha group
    shift: np.ndarray      # in Lande units (multiples of the Larmor shift)


def lande_factor(J, L, S) -> float:
    """Lande g-factor of a level from J, L, S."""
    if J == 0:
        return 0.0
    return float(1.5 + (S * (S + 1.0) - L * (L + 1)) / (2.0 * J * (J + 1.0)))


def zeeman_strength(Ju, Mu, Jl, Ml) -> float:
    """Relative strength of one Zeeman component (unnormalised; a factor 2
    on pi components cancels in the later normalisation)."""
    alpha = int(Ml - Mu)
    dJ = int(Ju - Jl)
    if dJ == 0:
        if alpha == 0:
            s = 2.0 * Mu ** 2
        elif alpha == -1:
            s = (Ju + Mu) * (Ju - Mu + 1.0)
        else:
            s = (Ju - Mu) * (Ju + Mu + 1.0)
    elif dJ == 1:
        if alpha == 0:
            s = 2.0 * ((Jl + 1) ** 2 - Ml ** 2)
        elif alpha == -1:
            s = (Jl + Ml + 1) * (Jl + Ml + 2.0)
        else:
            s = (Jl - Ml + 1.0) * (Jl - Ml + 2.0)
    elif dJ == -1:
        if alpha == 0:
            s = 2.0 * ((Ju + 1) ** 2 - Mu ** 2)
        elif alpha == -1:
            s = (Ju - Mu + 1) * (Ju - Mu + 2.0)
        else:
            s = (Ju + Mu + 1.0) * (Ju + Mu + 2.0)
    else:
        raise ValueError(f'Invalid dJ: {dJ}')
    return float(s)


def effective_lande(line) -> float:
    """Effective Lande factor of a line (or its explicit gLandeEff)."""
    if line.gLandeEff is not None:
        return line.gLandeEff
    i, j = line.iLevel, line.jLevel
    if any(x is None for x in (i.J, i.L, i.S, j.J, j.L, j.S)):
        raise ValueError('Cannot compute effective Lande factor: '
                         'J/L/S missing and gLandeEff not set')
    gL = lande_factor(i.J, i.L, i.S)
    gU = lande_factor(j.J, j.L, j.S)
    return 0.5 * (gU + gL) + 0.25 * (gU - gL) * (
        j.J * (j.J + 1.0) - i.J * (i.J + 1.0))


def _frange(start: Fraction, stop: Fraction):
    while start < stop:
        yield start
        start += 1


def compute_zeeman_components(line) -> Optional[ZeemanComponents]:
    """All Zeeman components of a line: three-component splitting when
    gLandeEff is given, full anomalous splitting under LS coupling, else
    None."""
    if line.gLandeEff is not None:
        alpha = np.array([-1, 0, 1], dtype=np.int32)
        strength = np.ones(3)
        shift = alpha * line.gLandeEff
        return ZeemanComponents(alpha, strength, shift)

    if line.iLevel.lsCoupling and line.jLevel.lsCoupling:
        Jl, Ll, Sl = line.iLevel.J, line.iLevel.L, line.iLevel.S
        Ju, Lu, Su = line.jLevel.J, line.jLevel.L, line.jLevel.S
        gLl = lande_factor(Jl, Ll, Sl)
        gLu = lande_factor(Ju, Lu, Su)
        alpha, strength, shift = [], [], []
        norm = np.zeros(3)
        for ml in _frange(-Jl, Jl + 1):
            for mu in _frange(-Ju, Ju + 1):
                if abs(ml - mu) <= 1:
                    alpha.append(int(ml - mu))
                    shift.append(gLl * ml - gLu * mu)
                    strength.append(zeeman_strength(Ju, mu, Jl, ml))
                    norm[alpha[-1] + 1] += strength[-1]
        alpha = np.array(alpha, dtype=np.int32)
        strength = np.array(strength)
        shift = np.array(shift, dtype=np.float64)
        strength /= norm[alpha + 1]
        return ZeemanComponents(alpha, strength, shift)
    return None
