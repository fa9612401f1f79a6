"""Pow2 length buckets — the single definition of the length-bucket
contract that :mod:`repro_torch.core.batched_query` bins with."""

from __future__ import annotations

import numpy as np

__all__ = ["pow2_buckets"]


def pow2_buckets(n: np.ndarray, min_exp: int = 2) -> np.ndarray:
    """Pow2-rounded length buckets ``1 << max(bit_length(n - 1), min_exp)``
    (0 -> ``1 << min_exp``), vectorized.  The single definition of the
    length-bucket contract — ``repro_torch.core.batched_query`` bins with it too."""
    n = np.asarray(n, np.int64)
    m = np.maximum(n - 1, 0)
    e = np.zeros(len(n), np.int64)
    while (m > 0).any():
        e += m > 0
        m >>= 1
    return (np.int64(1) << np.maximum(e, min_exp)).astype(np.int64)
