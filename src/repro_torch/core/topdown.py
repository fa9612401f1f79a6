"""TopDown hierarchical clustering (paper §3.2, "Refinements").

Flat K-means is at least linear in k per iteration, so for large k the
paper recursively *splits*: a subproblem of s documents (out of |D| total,
target k clusters) is split into ``min(χ, s·k/|D|)`` pieces while
``s > |D|/k``; χ = 8 by default (paper §4).  This yields between k and 2k
clusters, is orders of magnitude faster than flat clustering (paper
Fig. 6), and balances cluster sizes as a side effect.

Each split is solved by multilevel K-means at the small piece count, so the
per-level cost is O(χ·N_level) and the total O(χ·N·log_χ k).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.multilevel import multilevel_cluster
from repro_torch.core.objective import FrequentTermView

__all__ = ["TopDownResult", "topdown_cluster"]


@dataclasses.dataclass
class TopDownResult:
    assign: np.ndarray  # (n_docs,) int64 in [0, k_actual)
    k_actual: int
    n_splits: int


def topdown_cluster(
    view: FrequentTermView,
    k: int,
    chi: int = 8,
    eps: float = 0.1,
    max_iters: int = 100,
    min_rel_improvement: float = 0.01,
    doc_grained_below: int = 2_048,
    seed: int = 0,
    kmeans_fn: Optional[Callable] = None,
) -> TopDownResult:
    """``kmeans_fn`` is forwarded to every ``multilevel_cluster`` split —
    pass ``repro_torch.dist.cluster_dist.distributed_kmeans_fn(devices)`` to
    solve the big top-level splits on the devices (the CUDA
    ``cluster_score`` kernel scores them) while small recursion leaves stay
    on the host."""
    n_total = view.n_docs
    leaf_size = n_total / max(k, 1)
    next_cluster = 0
    n_splits = 0
    assign = np.zeros(n_total, dtype=np.int64)

    # Explicit stack; each entry is a doc-id array.
    stack: List[np.ndarray] = [np.arange(n_total, dtype=np.int64)]
    rng = np.random.default_rng(seed)
    while stack:
        ids = stack.pop()
        s = len(ids)
        if s <= leaf_size or s <= 1:
            assign[ids] = next_cluster
            next_cluster += 1
            continue
        q = int(min(chi, max(2, round(s * k / n_total))))
        q = min(q, s)  # never more pieces than documents
        sub = view.subset(ids)
        res = multilevel_cluster(
            sub,
            q,
            eps=eps,
            max_iters=max_iters,
            min_rel_improvement=min_rel_improvement,
            doc_grained_below=doc_grained_below,
            seed=int(rng.integers(0, 2**31)),
            kmeans_fn=kmeans_fn,
        )
        n_splits += 1
        pieces = 0
        for j in range(q):
            piece = ids[res.assign == j]
            if len(piece):
                stack.append(piece)
                pieces += 1
        if pieces <= 1:
            # Degenerate split (all docs identical): make it a leaf.
            stack.pop()
            assign[ids] = next_cluster
            next_cluster += 1
    return TopDownResult(assign=assign, k_actual=next_cluster, n_splits=n_splits)
