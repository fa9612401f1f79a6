"""Two-level cluster index (paper §3.3) — now a thin L = 2 facade over
the arbitrary-depth hierarchical core (``repro_torch.core.hier_index``).

A *cluster index* is an inverted index over a corpus of k "documents",
each the concatenation of one cluster: for every term it lists the
clusters containing at least one document with that term.  A conjunctive
query (t_1, ..., t_a) first intersects the a cluster lists (Lookup,
bucket size 8 — paper §4), then runs the ordinary intersection only
inside the common clusters (Lookup, bucket size 16).

Both levels use a *cost-ordered plan* under the paper's lookup cost
model Φ(x, y) = min(x, y) (``repro_torch.index.intersect.pair_cost``): lists
are intersected smallest-first, so the probing side of every Lookup is
the running intersection — never longer than any remaining list.  For
two terms this degenerates to the classic "shorter list probes the
longer" rule; ties keep the original term order (stable).

We build it over the *reordered* index (cluster-contiguous ids), so each
(term, cluster) posting segment is a contiguous slice — one ``searchsorted``
per query side, no data duplication.  Construction is O(nnz) via
run-length encoding of the (term, cluster) pairs.

The query algorithms live in :class:`repro_torch.core.hier_index.HierIndex`;
this class is exactly its L = 2 instantiation (``as_hier`` shares the
arrays, copying nothing) and exists so the historical two-level API —
and every caller pickled to it — keeps working unchanged, bit-for-bit
(results and work dicts, property-tested in ``tests/test_hier_index.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.hier_index import HierIndex, HierLevel, build_hier_index
from repro_torch.index.build import InvertedIndex
from repro_torch.index.lookup import cost_order

__all__ = ["ClusterIndex", "build_cluster_index", "cost_order"]


@dataclasses.dataclass
class ClusterIndex:
    """CSR of (term -> clusters containing it, with posting segments)."""

    cl_ptr: np.ndarray  # (n_terms + 1,) int64
    cl_ids: np.ndarray  # (nnz_c,) int32 — sorted cluster ids per term
    seg_start: np.ndarray  # (nnz_c,) int64 — posting-slice start (absolute)
    seg_end: np.ndarray  # (nnz_c,) int64
    ranges: np.ndarray  # (k + 1,) cluster id-range boundaries
    index: InvertedIndex  # the reordered index the segments point into
    bucket_size_clusters: int = 8
    bucket_size_postings: int = 16

    @property
    def k(self) -> int:
        return len(self.ranges) - 1

    def term_clusters(self, t: int) -> np.ndarray:
        return self.cl_ids[self.cl_ptr[t] : self.cl_ptr[t + 1]]

    def term_segments(self, t: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        lo, hi = self.cl_ptr[t], self.cl_ptr[t + 1]
        return self.cl_ids[lo:hi], self.seg_start[lo:hi], self.seg_end[lo:hi]

    # ------------------------------------------------------------------
    # The L = 2 view (shared arrays, built once)
    # ------------------------------------------------------------------

    def as_hier(self) -> HierIndex:
        """This index as the L = 2 :class:`HierIndex` — same arrays, no
        copies; the single source of the query algorithms."""
        cached = self.__dict__.get("_hier")
        if cached is None:
            cached = HierIndex(
                levels=(
                    HierLevel(
                        cl_ptr=self.cl_ptr,
                        cl_ids=self.cl_ids,
                        seg_start=self.seg_start,
                        seg_end=self.seg_end,
                        ranges=np.asarray(self.ranges, dtype=np.int64),
                    ),
                ),
                index=self.index,
                bucket_size_clusters=self.bucket_size_clusters,
                bucket_size_postings=self.bucket_size_postings,
            )
            self.__dict__["_hier"] = cached
        return cached

    # ------------------------------------------------------------------
    # Query algorithms (delegating facades)
    # ------------------------------------------------------------------

    def query(self, *terms) -> Tuple[np.ndarray, Dict[str, float]]:
        """Two-level conjunctive query over k >= 1 terms: cost-ordered
        cluster-list intersection, then a cost-ordered per-cluster posting
        chain.  Returns (result doc ids, work dict)."""
        return self.as_hier().query(*terms)

    def query_all_clusters(self, *terms) -> Tuple[np.ndarray, Dict[str, float]]:
        """Two-level query WITHOUT the level-1 Lookup: the cluster lists
        are merge-joined directly (work = Σ lengths per chain stage) and
        the posting intersection runs inside every common cluster.  This
        is the 'most direct way' of §3.3 — competitive when k is small,
        and the oracle the bucketed level-1 Lookup of :meth:`query` must
        match exactly."""
        return self.as_hier().query_all_clusters(*terms)

    def query_batch(
        self, queries
    ) -> Tuple[np.ndarray, np.ndarray, Dict[str, float]]:
        """Vectorized :meth:`query` over a query batch — an ``(n, k)``
        term array (``QUERY_PAD`` entries for ragged rows) or a
        :class:`repro_torch.core.queries.ConjunctiveQueries`.

        Returns CSR ``(ptr, docs, work)``: ``docs[ptr[i] : ptr[i + 1]]``
        is bit-identical to ``self.query(*terms_i)`` and ``work``
        sums the per-query work dicts — no Python per-query loop (see
        ``repro_torch.core.batched_query``).
        """
        from repro_torch.core.batched_query import batched_query

        return batched_query(self, queries)

    def device(self, device=None):
        """The upload-once device mirror (cached on the shared L = 2
        hierarchical view — see :meth:`HierIndex.device`)."""
        return self.as_hier().device(device)


def build_cluster_index(
    reordered_index: InvertedIndex,
    ranges: np.ndarray,
    bucket_size_clusters: int = 8,
    bucket_size_postings: int = 16,
) -> ClusterIndex:
    """O(nnz) construction via RLE over (term, cluster) pairs.

    ``reordered_index`` must use cluster-contiguous document ids with
    cluster i owning [ranges[i], ranges[i+1)).  Exactly the leaf level of
    :func:`repro_torch.core.hier_index.build_hier_index` with a single cluster
    level.
    """
    hier = build_hier_index(
        reordered_index,
        [np.asarray(ranges, dtype=np.int64)],
        bucket_size_clusters=bucket_size_clusters,
        bucket_size_postings=bucket_size_postings,
    )
    leaf = hier.levels[0]
    cidx = ClusterIndex(
        cl_ptr=leaf.cl_ptr,
        cl_ids=leaf.cl_ids,
        seg_start=leaf.seg_start,
        seg_end=leaf.seg_end,
        ranges=leaf.ranges,
        index=reordered_index,
        bucket_size_clusters=bucket_size_clusters,
        bucket_size_postings=bucket_size_postings,
    )
    cidx.__dict__["_hier"] = hier
    return cidx
