"""Inverted-index substrate (host numpy).

* ``build``     — CSR inverted index over a Corpus, remapping, permutation
* ``intersect`` — intersection algorithms + exact work accounting
* ``lookup``    — the bucketed Lookup algorithm of Sanders & Transier
* ``batched``   — pow2 length buckets of the batched planner, and the
                  non-clustered baseline's padded bins (``batch_queries``)
* ``compress``  — posting-list compression (paper Appendix A)
"""

from repro_torch.index.build import InvertedIndex, build_index, permute_docs
from repro_torch.index.lookup import BucketedList, bucketize, lookup_intersect
from repro_torch.index.batched import BatchedQueries, batch_queries

__all__ = [
    "InvertedIndex",
    "build_index",
    "permute_docs",
    "BucketedList",
    "bucketize",
    "lookup_intersect",
    "BatchedQueries",
    "batch_queries",
]
