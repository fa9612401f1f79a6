"""Inverted-index substrate (host numpy).

* ``build``     — CSR inverted index over a Corpus, remapping, permutation
* ``intersect`` — intersection algorithms + exact work accounting
* ``lookup``    — the bucketed Lookup algorithm of Sanders & Transier
* ``batched``   — pow2 length buckets of the batched planner
"""

from repro_torch.index.build import InvertedIndex, build_index, permute_docs
from repro_torch.index.lookup import BucketedList, bucketize, lookup_intersect

__all__ = [
    "InvertedIndex",
    "build_index",
    "permute_docs",
    "BucketedList",
    "bucketize",
    "lookup_intersect",
]
