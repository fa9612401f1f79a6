"""Multilevel initialization for K-means (paper §3.2, "Refinements").

For a scaling factor ε < 1: take a sample of size max(k, ε·|D|), cluster it
*recursively* into k clusters (trivial base case |D| = k: one document per
cluster), then initialize the full problem from the sample's clustering and
run K-means.  The paper notes this initialization "may be of independent
interest" — it converges far faster than random init because each level
starts from a high-quality coarse solution.

The base case and small levels use the document-grained update mode
(oscillation fix, paper §3.2 last paragraph).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from repro_torch.core.kmeans import KMeansResult, kmeans
from repro_torch.core.objective import (
    FrequentTermView,
    assignment_scores,
    cluster_counts,
    delta_add_tables,
)

__all__ = ["multilevel_cluster"]


def multilevel_cluster(
    view: FrequentTermView,
    k: int,
    eps: float = 0.1,
    max_iters: int = 100,
    min_rel_improvement: float = 0.01,
    doc_grained_below: int = 2_048,
    seed: int = 0,
    kmeans_fn: Optional[Callable[..., KMeansResult]] = None,
    _depth: int = 0,
) -> KMeansResult:
    """Recursive ε-sampling initialization + K-means at every level.

    ``kmeans_fn`` replaces the host K-means at every level — pass
    ``repro_torch.dist.cluster_dist.distributed_kmeans_fn(devices)`` to run
    the large levels as row shards on the devices.  It must accept the
    keyword signature of :func:`repro_torch.core.kmeans.kmeans`.
    """
    solve = kmeans_fn or kmeans
    n = view.n_docs
    rng = np.random.default_rng(seed + 1_000_003 * _depth)
    base = max(k, doc_grained_below // 2)

    sample_size = max(k, int(np.ceil(eps * n)))
    if n <= base or sample_size >= n or eps >= 1.0:
        # Base level: trivial init (round-robin over a random permutation —
        # for |D| == k this is exactly "one document per cluster").
        init = np.empty(n, dtype=np.int64)
        init[rng.permutation(n)] = np.arange(n) % k
        return solve(
            view,
            k,
            init_assign=init,
            max_iters=max_iters,
            min_rel_improvement=min_rel_improvement,
            doc_grained_below=doc_grained_below,
            seed=seed,
        )

    sample_ids = rng.choice(n, size=sample_size, replace=False)
    sub = view.subset(sample_ids)
    sub_res = multilevel_cluster(
        sub,
        k,
        eps=eps,
        max_iters=max_iters,
        min_rel_improvement=min_rel_improvement,
        doc_grained_below=doc_grained_below,
        seed=seed,
        kmeans_fn=kmeans_fn,
        _depth=_depth + 1,
    )

    # Project the sample clustering to all documents: score every document
    # against the sample clusters' δ⁺ tables, take the argmin.
    counts = cluster_counts(sub, sub_res.assign, k)
    tables = delta_add_tables(counts, view.p_freq)
    init = np.argmin(assignment_scores(view, tables), axis=1)
    # Keep the sample's assignments (they were optimized at this k).
    init[sample_ids] = sub_res.assign

    return solve(
        view,
        k,
        init_assign=init,
        max_iters=max_iters,
        min_rel_improvement=min_rel_improvement,
        doc_grained_below=doc_grained_below,
        seed=seed,
    )
