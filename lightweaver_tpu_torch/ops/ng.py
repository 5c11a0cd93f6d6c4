"""Ng (1974) acceleration of fixed-point iterates.

A copy of lightweaver_tpu/ops/ng.py's NgOptions, Ng and BatchedNg (numpy
on the host; the drift guards in tests/test_torch_model_layer.py and
tests/test_torch_columns.py hold the classes to their originals' source
text, BatchedNg's docstring aside).  The ring-buffer formulation with 1/|sol|
weights of the reference (ref: Source/Ng.hpp:16-163); the small
Norder x Norder least-squares system is solved with numpy.  The port uses
it to track (and optionally extrapolate) the PRD emission-profile ratios
in Context.prd_redistribute, on the populations in Context.stat_equil, and
per column (BatchedNg) in parallel/columns.py:ColumnBatch.
device_ng_init and device_ng_accelerate are the JAX package's device
variants on tensors, for Context.iterate_on_device: the ring buffer
stays on the device and nothing is read back to the host.
"""
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .linalg import solve_KxK_over_depth


@dataclass
class NgOptions:
    Norder: int = 0
    Nperiod: int = 0
    Ndelay: int = 0


class Ng:
    """Ng accelerator over flattened population vectors."""

    def __init__(self, Norder: int = 0, Nperiod: int = 0, Ndelay: int = 0,
                 sol: Optional[np.ndarray] = None):
        self.Norder = Norder
        self.Nperiod = max(Nperiod, 1)
        self.Ndelay = max(Ndelay, Nperiod + 2)
        self.count = 0
        self.init = False
        self.previous = None
        if sol is not None:
            sol = np.asarray(sol).ravel()
            self.len = sol.shape[0]
            self.previous = np.zeros((Norder + 2, self.len))
            self.previous[0] = sol
            self.count = 1
            self.init = True

    def _idx(self, cnt):
        return cnt % (self.Norder + 2)

    def accelerate(self, sol: np.ndarray, trustFactor: float = 0.0):
        """Store sol; every Nperiod steps after Ndelay, extrapolate it in
        place.  Returns (accelerated: bool, sol).

        trustFactor > 1 clips the extrapolated iterate elementwise to
        [sol/f, sol*f] around the raw iterate (used for positive
        quantities like PRD rho whose far wings make the unweighted
        extrapolation wild); the clipped value is what enters the
        history so subsequent extrapolations stay consistent."""
        sol = np.asarray(sol).ravel().copy()
        if not self.init:
            self.len = sol.shape[0]
            self.previous = np.zeros((max(self.Norder + 2, 2), self.len))
            self.init = True

        self.previous[self._idx(self.count)] = sol
        self.count += 1

        if not (self.Norder > 0 and self.count >= self.Ndelay
                and (self.count - self.Ndelay) % self.Nperiod == 0):
            return False, sol

        No = self.Norder
        Delta = np.empty((No + 1, self.len))
        for i in range(No + 1):
            ip = self._idx(self.count - i - 1)
            ipp = self._idx(self.count - i - 2)
            Delta[i] = self.previous[ip] - self.previous[ipp]
        weight = 1.0 / np.abs(sol)

        A = np.empty((No, No))
        b = np.empty(No)
        d0 = Delta[0]
        for j in range(No):
            b[j] = np.sum(weight * d0 * (d0 - Delta[j + 1]))
            for i in range(No):
                A[i, j] = np.sum(weight * (Delta[j + 1] - d0)
                                 * (Delta[i + 1] - d0))
        try:
            coeffs = np.linalg.solve(A, b)
        except np.linalg.LinAlgError:
            return False, sol

        i0 = self._idx(self.count - 1)
        raw = sol.copy()
        for i in range(No):
            ip = self._idx(self.count - i - 2)
            sol += coeffs[i] * (self.previous[ip] - self.previous[i0])
        if trustFactor > 1.0:
            lo = np.minimum(raw / trustFactor, raw * trustFactor)
            hi = np.maximum(raw / trustFactor, raw * trustFactor)
            sol = np.clip(sol, lo, hi)
        self.previous[i0] = sol
        return True, sol

    def max_change(self):
        if not self.init or self.count < 2:
            return 0.0
        old = self.previous[self._idx(self.count - 2)]
        cur = self.previous[self._idx(self.count - 1)]
        mask = cur != 0.0
        if not mask.any():
            return 0.0
        return float(np.max(np.abs((cur[mask] - old[mask]) / cur[mask])))

    def clear(self):
        if self.previous is not None:
            self.previous.fill(0.0)
        self.count = 0


def device_ng_init(sol, Norder: int):
    """Ring-buffer Ng state on the device: (hist [R, L], count), matching
    ``Ng(Norder, ..., sol=sol)`` (previous[0] = sol, count = 1).  count is
    a host int: the caller's loop knows it, so Ng's schedule is decided on
    the host and nothing is read back."""
    R = max(Norder + 2, 2)
    flat = sol.reshape(-1)
    hist = flat.new_zeros((R, flat.shape[0]))
    hist[0] = flat
    return hist, 1


def device_ng_accelerate(hist, count: int, sol, Norder: int, Nperiod: int,
                         Ndelay: int):
    """Equivalent of :meth:`Ng.accelerate` on the device, as the JAX
    package's device_ng_accelerate: store sol [L] into a copy of the ring
    buffer; every Nperiod steps after Ndelay solve the weighted Norder x
    Norder least-squares extrapolation (ops/linalg.py).  Returns (hist,
    count, solOut, dMax), dMax the max relative change between the last
    two stored iterates (:meth:`Ng.max_change`; a 0-d tensor).  A
    non-finite extrapolation keeps the plain iterate, like the host
    class; the choice is a select on the device, not a read back."""
    Nperiod = max(Nperiod, 1)
    Ndelay = max(Ndelay, Nperiod + 2)
    R = hist.shape[0]
    No = Norder

    hist = hist.clone()
    hist[count % R] = sol
    count += 1

    solOut = sol
    if No > 0 and count >= Ndelay and (count - Ndelay) % Nperiod == 0:
        # prev[i] = previous[(count - 1 - i) % R], i = 0..No+1
        prev = torch.stack([hist[(count - 1 - i) % R]
                            for i in range(No + 2)])    # [No+2, L]
        Delta = prev[:-1] - prev[1:]                    # [No+1, L]
        weight = 1.0 / torch.abs(sol)                   # [L]
        d0 = Delta[0]
        diff = Delta[1:] - d0[None, :]                  # [No, L]
        b = torch.sum(weight * d0 * (-diff), dim=1)     # [No]
        A = torch.einsum('l,il,jl->ij', weight, diff, diff)
        coeffs = solve_KxK_over_depth(A[:, :, None], b[:, None])[:, 0]
        accel = sol + torch.sum(
            coeffs[:, None] * (prev[1:No + 1] - prev[0][None, :]), dim=0)
        solOut = torch.where(torch.all(torch.isfinite(accel)), accel, sol)
        hist[(count - 1) % R] = solOut

    old = hist[(count - 2) % R]
    cur = hist[(count - 1) % R]
    nz = cur != 0.0
    dMax = torch.max(torch.abs(torch.where(
        nz, (cur - old) / torch.where(nz, cur, 1.0), 0.0)))
    return hist, count, solOut, dMax


class BatchedNg:
    """Per-column Ng acceleration over a batch of independent problems.

    Same ring-buffer formulation as :class:`Ng` but vectorised over a
    leading batch axis: iterates are [C, L], the Norder x Norder
    least-squares systems are solved per column with one stacked
    np.linalg.solve, and max_change is reported per column.
    Columns flagged in ``freeze`` keep their previous iterate (the 1.5D
    batch pins its converged columns this way while the others finish).
    """

    def __init__(self, Norder: int = 0, Nperiod: int = 0, Ndelay: int = 0,
                 sol: Optional[np.ndarray] = None):
        self.Norder = Norder
        self.Nperiod = max(Nperiod, 1)
        self.Ndelay = max(Ndelay, Nperiod + 2)
        self.count = 0
        self.previous = None
        if sol is not None:
            sol = np.asarray(sol)
            sol = sol.reshape(sol.shape[0], -1)
            self.C, self.len = sol.shape
            self.previous = np.zeros((max(self.Norder + 2, 2),
                                      self.C, self.len))
            self.previous[0] = sol
            self.count = 1

    def _idx(self, cnt):
        return cnt % max(self.Norder + 2, 2)

    def accelerate(self, sol: np.ndarray, freeze: Optional[np.ndarray] = None):
        """Store sol [C, ...]; extrapolate per column every Nperiod steps
        after Ndelay.  Returns (accelerated: bool, sol [C, L])."""
        sol = np.asarray(sol)
        sol = sol.reshape(sol.shape[0], -1).copy()
        if self.previous is None:
            self.C, self.len = sol.shape
            self.previous = np.zeros((max(self.Norder + 2, 2),
                                      self.C, self.len))
        if freeze is not None and self.count > 0:
            prev = self.previous[self._idx(self.count - 1)]
            sol[freeze] = prev[freeze]

        self.previous[self._idx(self.count)] = sol
        self.count += 1

        if not (self.Norder > 0 and self.count >= self.Ndelay
                and (self.count - self.Ndelay) % self.Nperiod == 0):
            return False, sol

        No = self.Norder
        Delta = np.empty((No + 1, self.C, self.len))
        for i in range(No + 1):
            ip = self._idx(self.count - i - 1)
            ipp = self._idx(self.count - i - 2)
            Delta[i] = self.previous[ip] - self.previous[ipp]
        weight = 1.0 / np.abs(sol)                      # [C, L]

        A = np.empty((self.C, No, No))
        b = np.empty((self.C, No))
        d0 = Delta[0]
        for j in range(No):
            b[:, j] = np.sum(weight * d0 * (d0 - Delta[j + 1]), axis=1)
            for i in range(No):
                A[:, i, j] = np.sum(weight * (Delta[j + 1] - d0)
                                    * (Delta[i + 1] - d0), axis=1)
        try:
            coeffs = np.linalg.solve(A, b[..., None])[..., 0]   # [C, No]
        except np.linalg.LinAlgError:
            return False, sol

        i0 = self._idx(self.count - 1)
        for i in range(No):
            ip = self._idx(self.count - i - 2)
            sol += coeffs[:, i:i + 1] * (self.previous[ip]
                                         - self.previous[i0])
        if freeze is not None:
            prev = self.previous[i0]
            sol[freeze] = prev[freeze]
        self.previous[i0] = sol
        return True, sol

    def max_change(self):
        """Per-column max relative change [C]."""
        if self.previous is None or self.count < 2:
            return np.zeros(getattr(self, 'C', 0))
        old = self.previous[self._idx(self.count - 2)]
        cur = self.previous[self._idx(self.count - 1)]
        rel = np.abs(np.where(cur != 0.0, (cur - old) / np.where(
            cur != 0.0, cur, 1.0), 0.0))
        return rel.max(axis=1)
