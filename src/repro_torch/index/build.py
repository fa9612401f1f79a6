"""Inverted-index construction.

The index is CSR over terms:

  * ``post_ptr``  -- int64 (n_terms + 1,)
  * ``post_docs`` -- int32 (nnz,); ``post_docs[post_ptr[t]:post_ptr[t+1]]``
    is the sorted posting list (document ids) of term t.

Building is a single stable counting sort of the corpus' (term, doc)
pairs — O(nnz), fully vectorized.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.data.corpus import Corpus

__all__ = ["InvertedIndex", "build_index", "permute_docs"]


@dataclasses.dataclass
class InvertedIndex:
    post_ptr: np.ndarray  # (n_terms + 1,) int64
    post_docs: np.ndarray  # (nnz,) int32, sorted within each term
    n_docs: int

    @property
    def n_terms(self) -> int:
        return len(self.post_ptr) - 1

    @property
    def nnz(self) -> int:
        return int(self.post_ptr[-1])

    def postings(self, t: int) -> np.ndarray:
        return self.post_docs[self.post_ptr[t] : self.post_ptr[t + 1]]

    def lengths(self) -> np.ndarray:
        return np.diff(self.post_ptr)

    def size_bytes(self) -> int:
        """Uncompressed int32 posting payload (paper Table 1's 'index size')."""
        return self.nnz * 4


def build_index(corpus: Corpus) -> InvertedIndex:
    """Invert a CSR corpus. O(nnz) via counting sort."""
    n, m = corpus.n_docs, corpus.n_terms
    terms = corpus.doc_terms.astype(np.int64)
    docs = np.repeat(np.arange(n, dtype=np.int64), np.diff(corpus.doc_ptr))
    # Stable sort by term keeps docs sorted within each term (docs are
    # visited in increasing order already).
    order = np.argsort(terms, kind="stable")
    post_docs = docs[order].astype(np.int32)
    counts = np.bincount(terms, minlength=m)
    post_ptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(counts, out=post_ptr[1:])
    return InvertedIndex(post_ptr=post_ptr, post_docs=post_docs, n_docs=n)


def permute_docs(index: InvertedIndex, perm: np.ndarray) -> InvertedIndex:
    """Renumber documents: new_id = perm[old_id]; posting lists re-sorted.

    Used both for the randomization required by the Lookup algorithm [14]
    (uniform ids) and for SeCluD's cluster-contiguous reordering (§3.3).
    O(nnz log max_list) via per-list sorts done as one segmented sort.
    """
    new_docs = perm.astype(np.int32)[index.post_docs]
    # Segmented re-sort: sort by (term_segment, new_doc).
    seg = np.repeat(
        np.arange(index.n_terms, dtype=np.int64), np.diff(index.post_ptr)
    )
    order = np.lexsort((new_docs, seg))
    return InvertedIndex(
        post_ptr=index.post_ptr.copy(),
        post_docs=new_docs[order],
        n_docs=index.n_docs,
    )
