"""Fixed-shape batched query layouts: the non-clustered baseline.

Posting lists are ragged; a kernel wants rows of one width.  Queries are
binned by the pow2-rounded lengths of their (shorter, longer) posting
lists and each bin is padded with PAD to its bucket widths.  Padding
waste is bounded by 2x per axis and is measured (``padding_overhead``)
rather than assumed.

:func:`batch_queries` over the randomized-id ``base_index`` of a fit is
the paper's non-clustered baseline.  Each bin is counted by
:data:`count_intersections`, which is
:func:`repro_torch.kernels.intersect.ops.intersect_count`: the plain
PyTorch version for CPU tensors (numpy bins land there), the CUDA count
kernel for tensors on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.index.build import InvertedIndex
from repro_torch.kernels.intersect.ops import intersect_count
from repro_torch.kernels.intersect.ref import PAD as _PAD

__all__ = ["BatchedQueries", "QueryBin", "batch_queries", "count_intersections", "pow2_buckets"]

# The per-bin count: one definition of the intersect oracle's contract
# (PAD value, sorted long rows, int32 counts) for the baseline and the
# block path alike.
count_intersections = intersect_count


@dataclasses.dataclass
class QueryBin:
    """One (short_len_bucket, long_len_bucket) bin of padded queries."""

    short: np.ndarray  # (B, Ls) int32, PAD-padded, each row sorted
    long: np.ndarray  # (B, Ll) int32, PAD-padded, each row sorted
    n_short: np.ndarray  # (B,) true lengths
    n_long: np.ndarray  # (B,)
    query_ids: np.ndarray  # (B,) position in the original query array


@dataclasses.dataclass
class BatchedQueries:
    bins: List[QueryBin]
    n_queries: int

    def padding_overhead(self) -> float:
        """Padded cells / true cells — the fixed-shape tax we pay."""
        true = padded = 0
        for b in self.bins:
            true += int(b.n_short.sum() + b.n_long.sum())
            padded += b.short.size + b.long.size
        return padded / max(true, 1)


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


def batch_queries(
    index: InvertedIndex,
    queries: np.ndarray,
    max_list_len: int | None = None,
) -> BatchedQueries:
    """Gather + pad posting lists for an (n_queries, 2) term-pair array.

    The shorter list of each pair goes to ``short`` (the first term's on a
    tie).  Lists longer than ``max_list_len`` are truncated (None = no
    limit, which keeps the counts exact).  Bins come sorted by their
    ``(Ls, Ll)`` key, rows in query order.
    """
    lens = index.lengths()
    t, u = queries[:, 0], queries[:, 1]
    lt, lu = lens[t], lens[u]
    short_t = np.where(lt <= lu, t, u)
    long_t = np.where(lt <= lu, u, t)
    ls = np.minimum(lt, lu)
    ll = np.maximum(lt, lu)
    if max_list_len is not None:
        ls = np.minimum(ls, max_list_len)
        ll = np.minimum(ll, max_list_len)

    keys = list(zip(pow2_buckets(ls).tolist(), pow2_buckets(ll).tolist(), strict=True))
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)

    bins = []
    for (bs, bl), idxs in sorted(groups.items()):
        idxs = np.asarray(idxs)
        B = len(idxs)
        sh = np.full((B, bs), _PAD, dtype=np.int32)
        lg = np.full((B, bl), _PAD, dtype=np.int32)
        for r, qi in enumerate(idxs):
            ps = index.postings(int(short_t[qi]))[: int(ls[qi])]
            pl = index.postings(int(long_t[qi]))[: int(ll[qi])]
            sh[r, : len(ps)] = ps
            lg[r, : len(pl)] = pl
        bins.append(
            QueryBin(
                short=sh,
                long=lg,
                n_short=ls[idxs].astype(np.int32),
                n_long=ll[idxs].astype(np.int32),
                query_ids=idxs.astype(np.int32),
            )
        )
    return BatchedQueries(bins=bins, n_queries=len(queries))
