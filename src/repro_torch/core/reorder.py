"""Cluster-contiguous document reordering (paper §3.3).

"The j-th document in cluster i gets document id j + Σ_{l<i} |c_l|."
Beyond the renumbering the clustering is ignored — the ordinary
single-index Lookup intersection runs on the reordered index, and the
skewed local term density accelerates it (speedup S_R, the paper's
best-performing variant).
"""

from __future__ import annotations

import numpy as np

__all__ = ["reorder_permutation", "cluster_ranges"]


def reorder_permutation(assign: np.ndarray, k: int) -> np.ndarray:
    """perm[old_id] = new_id; documents sorted by (cluster, old_id).

    ``assign`` must be a valid assignment into [0, k): a stale array from
    an earlier clustering (or a wrong k) would otherwise be silently
    renumbered into a permutation that disagrees with ``cluster_ranges``.
    """
    assign = np.asarray(assign)
    if assign.size and (assign.min() < 0 or assign.max() >= k):
        raise ValueError(
            f"assignment out of range: values span [{assign.min()}, "
            f"{assign.max()}] but k = {k}"
        )
    order = np.argsort(assign, kind="stable")  # old ids in new order
    perm = np.empty_like(order)
    perm[order] = np.arange(len(order))
    return perm


def cluster_ranges(assign: np.ndarray, k: int) -> np.ndarray:
    """(k + 1,) boundaries of the cluster-contiguous id ranges after
    reordering: cluster i owns new ids [ranges[i], ranges[i+1])."""
    sizes = np.bincount(np.asarray(assign), minlength=k)
    out = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(sizes, out=out[1:])
    return out
