"""Fixed-shape batched query layouts: the non-clustered baseline.

Posting lists are ragged; a kernel wants rows of one width.  Queries are
binned by the pow2-rounded lengths of their (shorter, longer) posting
lists and each bin is padded with PAD to its bucket widths.  Padding
waste is bounded by 2x per axis and is measured (``padding_overhead``)
rather than assumed.

:func:`batch_queries` over the randomized-id ``base_index`` of a fit is
the paper's non-clustered baseline.  A bin can be counted alone by
:data:`count_intersections`, which is
:func:`repro_torch.kernels.intersect.ops.intersect_count`: the plain
PyTorch version for CPU tensors (numpy bins land there), the CUDA count
kernel for tensors on the card.  The whole batch is counted at once by
:func:`count_queries` over its device form (:func:`upload_bins`: every
bin's rows laid end to end in two buffers and a work table of rows and
chunks of rows), one kernel launch on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.index.build import InvertedIndex
from repro_torch.kernels.intersect import kernel as _kernel
from repro_torch.kernels.intersect.ops import intersect_count, intersect_count_bins
from repro_torch.kernels.intersect.ref import PAD as _PAD

__all__ = ["BatchedQueries", "DeviceBins", "QueryBin", "batch_queries", "count_intersections",
           "count_queries", "pow2_buckets", "upload_bins", "work_table"]

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


# Columns of DeviceBins.rows: one row a query, in bin order.
ROW_COLUMNS = ("short_off", "long_off", "n_short", "n_long", "query_id")


def work_table(rows: np.ndarray, merge_tile: int = _kernel.MERGE_TILE,
               search_chunk: int = _kernel.SEARCH_CHUNK,
               ratio_cut: float = _kernel.RATIO_CUT) -> np.ndarray:
    """The (n_items, 8) int64 work table (``kernel.ITEM_COLUMNS``) of the
    ``rows`` (n_rows, 5) (:data:`ROW_COLUMNS`).  A row with no short or no
    long element has no item.  A row whose long list is more than
    ``ratio_cut`` times its short one and that does not fit one merge tile
    is cut into SEARCH items of ``search_chunk`` short elements; any other
    row into MERGE items of ``merge_tile`` positions of its merge path (its
    n_short + n_long).  Search items come first, then merge items, each by
    longer long rows first and then longer items: the heaviest first, so
    that the warps walking the table finish together."""
    so, lo, ns, nl, qid = (np.asarray(rows, np.int64).reshape(-1, len(ROW_COLUMNS)).T)
    live = (ns > 0) & (nl > 0)
    search = live & (nl > ratio_cut * np.maximum(ns, 1)) & (ns + nl > merge_tile)
    span = np.where(live, np.where(search, ns, ns + nl), 0)
    chunk = np.where(search, search_chunk, merge_tile).astype(np.int64)
    n_items = -(-span // chunk)
    row = np.repeat(np.arange(len(ns)), n_items)
    first = np.cumsum(n_items) - n_items
    start = (np.arange(len(row)) - first[row]) * chunk[row]
    length = np.minimum(chunk[row], span[row] - start)
    kind = np.where(search[row], _kernel.SEARCH, _kernel.MERGE)
    table = np.stack([so[row], lo[row], ns[row], nl[row], start, length, qid[row], kind], axis=1)
    order = np.lexsort((-length, -nl[row], kind == _kernel.MERGE))
    return np.ascontiguousarray(table[order], dtype=np.int64)


@dataclasses.dataclass
class DeviceBins:
    """A :class:`BatchedQueries` on a device: every bin's padded rows laid
    end to end in ``short`` and ``long`` (1-D int32), and the work table
    ``items`` of :func:`work_table` built with ``merge_tile``,
    ``search_chunk`` and ``ratio_cut``.  ``rows`` (host, :data:`ROW_COLUMNS`),
    ``bins`` (each ``(short_base, long_base, rows, ls, ll, row_base)``) and
    ``query_ids`` (each row's, in bin order) describe the layout."""

    short: torch.Tensor
    long: torch.Tensor
    items: torch.Tensor
    rows: np.ndarray
    bins: Tuple[Tuple[int, int, int, int, int, int], ...]
    query_ids: torch.Tensor
    n_queries: int
    merge_tile: int
    search_chunk: int
    ratio_cut: float

    def bin_rows(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Each bin's (rows, Ls) short and (rows, Ll) long rows: views of
        the two buffers."""
        return [(self.short[sb:sb + n * ls].view(n, ls), self.long[lb:lb + n * ll].view(n, ll))
                for sb, lb, n, ls, ll, _ in self.bins]

    def with_design(self, merge_tile: int, search_chunk: int, ratio_cut: float) -> "DeviceBins":
        """The same buffers with the work table of another design."""
        items = torch.from_numpy(work_table(self.rows, merge_tile, search_chunk, ratio_cut))
        return dataclasses.replace(self, items=items.to(self.short.device),
                                   merge_tile=merge_tile, search_chunk=search_chunk,
                                   ratio_cut=ratio_cut)


def upload_bins(batched: BatchedQueries, device=None, merge_tile: int = _kernel.MERGE_TILE,
                search_chunk: int = _kernel.SEARCH_CHUNK,
                ratio_cut: float = _kernel.RATIO_CUT) -> DeviceBins:
    """The device form of ``batched`` on ``device`` (``"cuda"`` unless
    named: raises without a GPU).  The bins' padded rows are copied as
    they are, bin after bin; the work table is built on the host.  Bin
    widths must be multiples of 4 (``batch_queries``' are powers of two of
    at least 4), so that every row starts 16-byte aligned, and at most
    2^30."""
    from repro_torch.core.device_engine import resolve_device

    dev = resolve_device(device)
    bins, rows = [], []
    n_short = n_long = n_rows = 0
    for b in batched.bins:
        n, ls = b.short.shape
        ll = b.long.shape[1]
        if ls % 4 or ll % 4 or max(ls, ll) > 1 << 30:
            raise ValueError(f"upload_bins: bin widths ({ls}, {ll}) are not multiples of 4 "
                             f"up to 2^30 (the kernel's positions in a row are int32)")
        bins.append((n_short, n_long, n, ls, ll, n_rows))
        r = np.arange(n, dtype=np.int64)
        rows.append(np.stack([n_short + r * ls, n_long + r * ll, b.n_short, b.n_long,
                              b.query_ids], axis=1).astype(np.int64))
        n_short, n_long, n_rows = n_short + n * ls, n_long + n * ll, n_rows + n
    rows = np.concatenate(rows) if rows else np.zeros((0, len(ROW_COLUMNS)), np.int64)
    short = torch.empty(n_short, dtype=torch.int32, device=dev)
    long = torch.empty(n_long, dtype=torch.int32, device=dev)
    for (sb, lb, n, ls, ll, _), b in zip(bins, batched.bins, strict=True):
        short[sb:sb + n * ls].copy_(torch.from_numpy(np.ascontiguousarray(b.short).ravel()))
        long[lb:lb + n * ll].copy_(torch.from_numpy(np.ascontiguousarray(b.long).ravel()))
    items = torch.from_numpy(work_table(rows, merge_tile, search_chunk, ratio_cut)).to(dev)
    return DeviceBins(short=short, long=long, items=items, rows=rows, bins=tuple(bins),
                      query_ids=torch.from_numpy(rows[:, 4].copy()).to(dev),
                      n_queries=batched.n_queries, merge_tile=merge_tile,
                      search_chunk=search_chunk, ratio_cut=ratio_cut)


def count_queries(dbins: DeviceBins) -> torch.Tensor:
    """Per-query |short ∩ long| (n_queries,) int32 of every bin, in query
    order: one kernel launch over the work table on the card, each bin
    through the plain version on the CPU."""
    return intersect_count_bins(dbins.short, dbins.long, dbins.items, dbins.bins,
                                dbins.query_ids, dbins.n_queries, dbins.merge_tile,
                                dbins.search_chunk)
