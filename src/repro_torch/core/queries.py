"""Arbitrary-arity conjunctive queries as a ragged (CSR) batch.

The paper's analysis is about *conjunctive queries* in general; the
2-term query is just its smallest instance.  This module is the single
representation every query path (``ClusterIndex.query``, the batched
engine, ``SearchService``, ``SecludPipeline.evaluate``) accepts:

* ragged/CSR — ``(q_ptr, q_terms)``: query i asks for the conjunction of
  ``q_terms[q_ptr[i] : q_ptr[i + 1]]`` (k_i >= 1 terms);
* padded — an ``(n_queries, max_arity)`` int array where rows shorter
  than ``max_arity`` are filled with ``QUERY_PAD`` (= -1, never a valid
  term id).  The historical ``(n, 2)`` term-pair array is the degenerate
  pad-free case.

``as_queries`` coerces either form (or a list of per-query term
sequences) so callers never branch on arity.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

__all__ = ["QUERY_PAD", "ConjunctiveQueries", "as_queries"]

# Pad sentinel of the rectangular convenience form. Term ids are >= 0.
QUERY_PAD = -1


@dataclasses.dataclass
class ConjunctiveQueries:
    """A batch of conjunctive queries in CSR form."""

    q_ptr: np.ndarray  # (n_queries + 1,) int64
    q_terms: np.ndarray  # (nnz,) int64 term ids, >= 0

    def __post_init__(self):
        self.q_ptr = np.asarray(self.q_ptr, dtype=np.int64)
        self.q_terms = np.asarray(self.q_terms, dtype=np.int64)
        if len(self.q_ptr) == 0 or self.q_ptr[0] != 0:
            raise ValueError("q_ptr must start at 0")
        if self.q_ptr[-1] != len(self.q_terms):
            raise ValueError("q_ptr[-1] must equal len(q_terms)")
        if (np.diff(self.q_ptr) < 1).any():
            raise ValueError("every conjunctive query needs >= 1 term")
        if len(self.q_terms) and self.q_terms.min() < 0:
            raise ValueError("term ids must be >= 0")

    # -- shape ---------------------------------------------------------

    @property
    def n_queries(self) -> int:
        return len(self.q_ptr) - 1

    def __len__(self) -> int:
        return self.n_queries

    @property
    def arities(self) -> np.ndarray:
        return np.diff(self.q_ptr)

    @property
    def max_arity(self) -> int:
        return int(self.arities.max()) if self.n_queries else 0

    def terms(self, i: int) -> np.ndarray:
        return self.q_terms[self.q_ptr[i] : self.q_ptr[i + 1]]

    def __iter__(self):
        for i in range(self.n_queries):
            yield self.terms(i)

    def __getitem__(self, s: slice) -> "ConjunctiveQueries":
        if not isinstance(s, slice):
            raise TypeError("only slicing is supported")
        start, stop, step = s.indices(self.n_queries)
        if step != 1:
            raise ValueError("only unit-stride slices")
        lo, hi = self.q_ptr[start], self.q_ptr[stop]
        return ConjunctiveQueries(
            q_ptr=self.q_ptr[start : stop + 1] - lo, q_terms=self.q_terms[lo:hi]
        )

    # -- conversions ---------------------------------------------------

    def padded(self, pad: int = QUERY_PAD, width: int | None = None) -> np.ndarray:
        """The ``(n_queries, width)`` rectangular form, ``pad``-filled."""
        width = self.max_arity if width is None else int(width)
        out = np.full((self.n_queries, max(width, 1)), pad, dtype=np.int64)
        lens = self.arities
        rows = np.repeat(np.arange(self.n_queries), lens)
        within = np.arange(len(self.q_terms)) - self.q_ptr[:-1][rows]
        out[rows, within] = self.q_terms
        return out

    @classmethod
    def from_padded(cls, arr: np.ndarray, pad: int = QUERY_PAD) -> "ConjunctiveQueries":
        """Build from an ``(n, max_arity)`` array; entries == ``pad`` (or
        any negative id) are dropped.  Pads may appear anywhere in a row;
        term order of the survivors is preserved."""
        arr = np.asarray(arr, dtype=np.int64)
        if arr.ndim != 2:
            raise ValueError(f"padded query array must be 2-D, got shape {arr.shape}")
        keep = (arr != pad) & (arr >= 0)
        ptr = np.zeros(arr.shape[0] + 1, dtype=np.int64)
        np.cumsum(keep.sum(axis=1), out=ptr[1:])
        return cls(q_ptr=ptr, q_terms=arr[keep])

    @classmethod
    def from_lists(cls, lists: Iterable[Sequence[int]]) -> "ConjunctiveQueries":
        lists = [np.asarray(x, dtype=np.int64).ravel() for x in lists]
        ptr = np.zeros(len(lists) + 1, dtype=np.int64)
        np.cumsum([len(x) for x in lists], out=ptr[1:])
        terms = np.concatenate(lists) if lists else np.zeros(0, np.int64)
        return cls(q_ptr=ptr, q_terms=terms)


def as_queries(queries) -> ConjunctiveQueries:
    """Coerce any accepted query form to :class:`ConjunctiveQueries`.

    Accepts a ``ConjunctiveQueries``, an ``(n, k)`` int array (``k >= 1``,
    ``QUERY_PAD`` entries allowed for ragged rows), or an iterable of
    per-query term sequences.
    """
    if isinstance(queries, ConjunctiveQueries):
        return queries
    if isinstance(queries, np.ndarray):
        if queries.ndim == 2 and queries.shape[0] == 0:
            return ConjunctiveQueries(
                q_ptr=np.zeros(1, np.int64), q_terms=np.zeros(0, np.int64)
            )
        return ConjunctiveQueries.from_padded(queries)
    if isinstance(queries, (list, tuple)):
        first = queries[0] if len(queries) else None
        if first is not None and np.isscalar(first):
            raise ValueError(
                "a flat term sequence is ambiguous; pass [[t0, t1, ...]] "
                "for a single query or an (n, k) array for a batch"
            )
        return ConjunctiveQueries.from_lists(queries)
    return ConjunctiveQueries.from_padded(np.asarray(queries))
