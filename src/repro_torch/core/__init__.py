"""SeCluD core — the paper's primary contribution.

Search with Clustered Documents (Dimond & Sanders): cluster documents so
conjunctive posting-list intersections get cheaper, losslessly.

* ``objective``     — the query-cost objective ψ (Eq. 2), δ⁺/δ⁻ lookup
                      tables, frequent-term restriction (TC cutoff)
* ``kmeans``        — flat K-means on ψ with round-based and
                      document-grained update modes
* ``multilevel``    — ε-sampling multilevel initialization
* ``topdown``       — hierarchical TopDown splitting (χ splitting factor)
* ``queries``       — arbitrary-arity conjunctive query batches (ragged
                      CSR + padded forms)
* ``hier_index``    — arbitrary-depth hierarchical cluster index: the
                      flat Lookup index is L = 1, the paper's cluster
                      index is L = 2, super-clusters/shard routers above
* ``cluster_index`` — the historical two-level cluster index (query
                      speedup S_C) as a thin L = 2 facade over
                      ``hier_index``; cost-ordered plans for k >= 1 terms
* ``batched_query`` — batched hierarchical engine: vectorized per-level
                      descent planning for whole query batches (bit-exact vs the
                      per-query loop at every depth)
* ``reorder``       — cluster-contiguous renumbering (query speedup S_R)
* ``seclud``        — SecludPipeline: fit + query + speedup report
* ``device_engine`` — the upload-once device index and the fold kernel
"""

from repro_torch.core.objective import (
    FrequentTermView,
    frequent_term_view,
    cluster_counts,
    psi_from_counts,
    delta_add_tables,
    delta_remove_tables,
    assignment_scores,
    query_set_cost,
    hier_query_set_cost,
)
from repro_torch.core.kmeans import kmeans, KMeansResult
from repro_torch.core.multilevel import multilevel_cluster
from repro_torch.core.topdown import topdown_cluster
from repro_torch.core.batched_query import (
    SegmentPlan,
    batched_counts,
    batched_lookup,
    batched_query,
    plan_segment_pairs,
)
from repro_torch.core.cluster_index import ClusterIndex, build_cluster_index, cost_order
from repro_torch.core.hier_index import HierIndex, HierLevel, as_hier, build_hier_index
from repro_torch.core.queries import QUERY_PAD, ConjunctiveQueries, as_queries
from repro_torch.core.reorder import reorder_permutation
from repro_torch.core.seclud import SecludPipeline, SecludResult, result_from_arrays

__all__ = [
    "FrequentTermView",
    "frequent_term_view",
    "cluster_counts",
    "psi_from_counts",
    "delta_add_tables",
    "delta_remove_tables",
    "assignment_scores",
    "query_set_cost",
    "hier_query_set_cost",
    "kmeans",
    "KMeansResult",
    "multilevel_cluster",
    "topdown_cluster",
    "ClusterIndex",
    "build_cluster_index",
    "cost_order",
    "HierIndex",
    "HierLevel",
    "as_hier",
    "build_hier_index",
    "QUERY_PAD",
    "ConjunctiveQueries",
    "as_queries",
    "SegmentPlan",
    "plan_segment_pairs",
    "batched_query",
    "batched_counts",
    "batched_lookup",
    "reorder_permutation",
    "SecludPipeline",
    "SecludResult",
    "result_from_arrays",
]
