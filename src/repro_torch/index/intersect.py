"""Sorted-list intersection algorithms with exact work accounting.

The paper's analysis counts algorithm *steps*: ``Phi(x, y) = min(x, y)``
for the Lookup algorithm [14] and ``Phi(x, y) = x log(y/x)`` (x > y
swapped) for an asymptotically optimal comparison-based intersector
(Baeza-Yates [1], paper Appendix B).  This module provides

  * reference intersections (merge / vectorized binary search / galloping),
  * each returning ``(result, work)`` where ``work`` counts the
    comparisons/probes actually performed, and
  * the closed-form cost models used by the clustering objective.

All functions take sorted 1-D int arrays.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

__all__ = [
    "intersect_merge",
    "intersect_searchsorted",
    "intersect_gallop",
    "pair_cost",
    "COST_MODELS",
]


def _phi_min(x, y):
    """Lookup-algorithm cost model (paper's default objective)."""
    return np.minimum(x, y)


def _phi_sum(x, y):
    """Two-pointer merge cost model."""
    return x + y


def _phi_bs(x, y):
    """Per-element binary search of the shorter into the longer list."""
    lo = np.minimum(x, y).astype(np.float64)
    hi = np.maximum(x, y).astype(np.float64)
    return lo * np.ceil(np.log2(np.maximum(hi, 2.0)))


def _phi_cmp(x, y):
    """Baeza-Yates comparison-based model (paper Appendix B).

    The paper writes Phi(x,y) = x·log(y/x) for x > y; symmetrized here as
    min·log2(max/min + 1), floored at min(x,y) and 0 for empty lists.
    """
    lo = np.minimum(x, y).astype(np.float64)
    hi = np.maximum(x, y).astype(np.float64)
    out = np.zeros_like(lo, dtype=np.float64)
    nz = lo > 0
    out[nz] = np.maximum(lo[nz], lo[nz] * np.log2(hi[nz] / lo[nz] + 1.0))
    return out


COST_MODELS: Dict[str, Callable] = {
    "lookup": _phi_min,  # Phi = min(x, y)            -- paper Eq. objective
    "merge": _phi_sum,  # Phi = x + y
    "binary_search": _phi_bs,  # Phi = min * ceil(log2 max)
    "comparison": _phi_cmp,  # Phi = min * log2(max/min + 1)  -- App. B
}


def pair_cost(x, y, model: str = "lookup"):
    """Vectorized Phi(x, y) under a named cost model."""
    return COST_MODELS[model](np.asarray(x), np.asarray(y))


def intersect_merge(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, int]:
    """Two-pointer merge intersection. work = pointer advances."""
    i = j = 0
    out = []
    work = 0
    na, nb = len(a), len(b)
    while i < na and j < nb:
        work += 1
        if a[i] < b[j]:
            i += 1
        elif a[i] > b[j]:
            j += 1
        else:
            out.append(a[i])
            i += 1
            j += 1
    return np.asarray(out, dtype=a.dtype), work


def intersect_searchsorted(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, float]:
    """Vectorized: binary-search each element of the shorter list into the
    longer. work = min * ceil(log2 max) probe count. This is the pattern
    the intersect kernel vectorizes on the card."""
    if len(a) > len(b):
        a, b = b, a
    if len(a) == 0 or len(b) == 0:
        return np.empty(0, dtype=a.dtype), 0.0
    pos = np.searchsorted(b, a)
    hit = (pos < len(b)) & (b[np.minimum(pos, len(b) - 1)] == a)
    work = float(len(a) * max(1, int(np.ceil(np.log2(max(len(b), 2))))))
    return a[hit], work


def intersect_gallop(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, int]:
    """Galloping (exponential) search intersection — adaptive, O(min·log
    gap). work = comparisons performed. Scalar reference implementation."""
    if len(a) > len(b):
        a, b = b, a
    out = []
    work = 0
    j = 0
    nb = len(b)
    for x in a:
        # Gallop from j.
        step = 1
        lo = j
        while j + step < nb and b[j + step] < x:
            work += 1
            lo = j + step
            step <<= 1
        hi = min(j + step, nb - 1)
        work += 1
        # Binary search in (lo, hi].
        left, right = lo, hi
        while left < right:
            work += 1
            mid = (left + right) // 2
            if b[mid] < x:
                left = mid + 1
            else:
                right = mid
        j = left
        if j < nb and b[j] == x:
            out.append(x)
            j += 1
        if j >= nb:
            break
    return np.asarray(out, dtype=a.dtype), work
