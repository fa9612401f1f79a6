"""Batched conjunctive-query engine — the per-query Python loops, vectorized.

The paper's speedups were measured by looping queries one at a time in
interpreted numpy (``SecludPipeline.evaluate``, ``ClusterIndex.query``,
``SearchService.serve_counts``).  This module executes a whole batch of
arbitrary-arity conjunctive queries (``repro_torch.core.queries``) at once, in
three layers:

* ``_lookup_many`` — one vectorized pass that replicates
  ``lookup_intersect(short, bucketize(long, universe, B))`` *bit-exactly*
  (results, ``probes`` and ``scanned``) for many (short, long) pairs:
  per-pair arrays are keyed as ``pair * BASE + value`` so a single global
  ``searchsorted`` answers every per-pair directory probe at once.
  ``_chain_stage`` applies it to one stage of a cost-ordered intersection
  chain (the running intersection of every active item probes its next
  list) — the batched mirror of ``ClusterIndex.query``'s smallest-first
  plan.

* planning — ``plan_segment_pairs`` descends an arbitrary-depth
  :class:`repro_torch.core.hier_index.HierIndex` for the whole batch: at every
  cluster level the surviving node lists of all query terms are chained
  smallest-first (CSR set-intersection, no Python per-query loop), the
  common nodes resolve each term's next-level slices, and the leaf level
  yields every (query, common-leaf-cluster) *segment group* — the k
  posting segments of that cluster, cost-ordered — plus the per-level
  work accounting of ``HierIndex.query``.  The historical two-level
  ``ClusterIndex`` is the L = 2 case (``as_hier`` view, no copies); the
  flat L = 1 index plans one whole-universe group per query.

* execution — either the host path ``batched_query`` (exact doc ids +
  the work dict of ``ClusterIndex.query``, summed), or the device path
  ``batched_counts``: segment groups are folded pairwise, stage by stage;
  each stage is length-bucketed and padded like ``repro_torch.index.batched``,
  intermediate stages run a vectorized membership select
  (``intersect_members_ref``) and the final pairwise reduction of each
  group runs through the batched intersect kernel (CUDA on the card, its
  plain torch version on the CPU); a segment-sum maps per-group counts back to per-query
  counts.

Exactness guarantee: ``batched_query`` returns, for every query, the
identical (sorted) result array and the identical work totals as calling
``ClusterIndex.query`` in a loop; ``batched_counts`` returns the identical
per-query counts.  ``batched_lookup`` does the same for the single-index
Lookup chain (the baseline / S_R paths of ``SecludPipeline.evaluate``).
2-term queries are the degenerate case: one chain stage, one reduction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.analysis.runtime import maybe_validate
from repro_torch.core.hier_index import _concat_ranges, as_hier
from repro_torch.core.queries import ConjunctiveQueries, as_queries
from repro_torch.index.batched import pow2_buckets
from repro_torch.kernels.intersect.ref import PAD

__all__ = [
    "SegmentPlan",
    "plan_segment_pairs",
    "batched_query",
    "batched_counts",
    "batched_lookup",
    "gather_padded",
    "pow2_buckets",
]


# ----------------------------------------------------------------------
# Ragged helpers
# ----------------------------------------------------------------------


def _ragged_indices(lengths: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(row id, offset within row) of every cell of a ragged row layout."""
    rows = np.repeat(np.arange(len(lengths)), lengths)
    within = np.arange(int(lengths.sum())) - (np.cumsum(lengths) - lengths)[rows]
    return rows, within


def _ragged_gather(values: np.ndarray, starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Concatenate ``values[starts[i] : starts[i] + lengths[i]]`` for all i."""
    if int(lengths.sum()) == 0:
        return np.empty(0, values.dtype)
    rows, within = _ragged_indices(lengths)
    return values[starts[rows] + within]


def _csr_starts(lengths: np.ndarray) -> np.ndarray:
    out = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=out[1:])
    return out


def _ragged_range_idx(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Flat gather indices ``concat(arange(starts[i], starts[i] + lengths[i]))``
    — the (starts, lengths) spelling of ``hier_index._concat_ranges``,
    which owns the single implementation."""
    return _concat_ranges(starts, starts + lengths)


def gather_padded(
    values: np.ndarray,
    starts: np.ndarray,
    lengths: np.ndarray,
    width: int,
    fill: np.int32 = PAD,
) -> np.ndarray:
    """Gather ragged slices into a PAD-padded ``(len(starts), width)`` int32
    block without a per-row Python loop."""
    out = np.full((len(starts), width), fill, np.int32)
    if int(lengths.sum()):
        rows, within = _ragged_indices(lengths)
        out[rows, within] = values[starts[rows] + within]
    return out


# ----------------------------------------------------------------------
# The vectorized Lookup primitive
# ----------------------------------------------------------------------


def _lookup_many(
    short_vals: np.ndarray,
    short_ptr: np.ndarray,
    long_vals: np.ndarray,
    long_ptr: np.ndarray,
    universes: np.ndarray,
    bucket_size: int,
    track_work: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized ``lookup_intersect(short_p, bucketize(long_p, U_p, B))``
    over P pairs at once.

    ``short_vals`` / ``long_vals`` are the per-pair sorted arrays
    concatenated in pair order (values in ``[0, U_p)``); ``*_ptr`` are the
    (P + 1,) CSR offsets.  Returns ``(hit, probes, scanned, pos)`` where
    ``hit`` masks ``short_vals`` (matched elements), ``probes`` / ``scanned``
    are per-pair int64 work counts bit-identical to looping
    ``repro_torch.index.lookup.lookup_intersect``, and ``pos`` is the global index
    into ``long_vals`` of each short element's match candidate (valid where
    ``hit``).

    ``track_work=False`` skips the directory-probe bookkeeping (bucket
    bounds, resumable-scan pointers) and returns zero ``probes`` /
    ``scanned``: the ``hit`` mask — hence the surviving intersection — is
    identical, at roughly a third of the ``searchsorted`` work.  The
    device engine plans with this (it needs the layout, not the paper's
    work metric); every host path keeps the exact accounting.
    """
    n_pairs = len(universes)
    short_len = np.diff(short_ptr)
    long_len = np.diff(long_ptr)
    n_short = len(short_vals)
    if n_pairs == 0 or n_short == 0:
        return (
            np.zeros(n_short, bool),
            np.zeros(n_pairs, np.int64),
            np.zeros(n_pairs, np.int64),
            np.zeros(n_short, np.int64),
        )
    universes = universes.astype(np.int64)
    pair_s = np.repeat(np.arange(n_pairs, dtype=np.int64), short_len)
    x = short_vals.astype(np.int64)
    if not track_work:
        # Membership only: one keyed searchsorted; keys are unique
        # (pair * base + value), so equality at the insertion point IS the
        # hit test — no bucket directory needed.
        base = int(universes.max()) + 1
        keyed_long = (
            np.repeat(np.arange(n_pairs, dtype=np.int64), long_len) * base
            + long_vals.astype(np.int64)
        )
        key0 = pair_s * base
        pos = np.searchsorted(keyed_long, key0 + x)
        if len(keyed_long):
            hit = keyed_long[np.minimum(pos, len(keyed_long) - 1)] == key0 + x
        else:
            hit = np.zeros(n_short, bool)
        zeros = np.zeros(n_pairs, np.int64)
        return hit, zeros, zeros.copy(), pos
    # Per-pair bucket shift, exactly `_pick_shift` (only consumed when the
    # long side is non-empty; empty pairs cost nothing below).
    target = np.maximum(
        1.0, universes * float(bucket_size) / np.maximum(long_len, 1)
    )
    shift = np.maximum(np.floor(np.log2(target)).astype(np.int64), 0)
    n_buckets = np.maximum(
        (universes + (np.int64(1) << shift) - 1) >> shift, 1
    )
    # Key space: pair * BASE + value.  BASE exceeds every in-pair key —
    # values (< U) and bucket boundaries (<= n_buckets << shift) — so keyed
    # arrays stay globally sorted and probes never cross pair boundaries.
    base = int((n_buckets << shift).max()) + 1

    keyed_long = (
        np.repeat(np.arange(n_pairs, dtype=np.int64), long_len) * base
        + long_vals.astype(np.int64)
    )
    sh = shift[pair_s]
    b = np.clip(x >> sh, 0, n_buckets[pair_s] - 1)
    key0 = pair_s * base
    lo = np.searchsorted(keyed_long, key0 + (b << sh))
    hi = np.searchsorted(keyed_long, key0 + ((b + 1) << sh))
    pos = np.searchsorted(keyed_long, key0 + x)
    stop = np.minimum(pos, hi)
    # Resumable scan: within a run of probes sharing (pair, bucket) the
    # pointer starts where the previous probe left it.
    start = lo.copy()
    if n_short > 1:
        same = (b[1:] == b[:-1]) & (pair_s[1:] == pair_s[:-1])
        start[1:] = np.where(same, np.maximum(stop[:-1], lo[1:]), lo[1:])
    scanned_el = np.maximum(stop - start, 0)
    if len(keyed_long):
        hit = (pos < hi) & (
            keyed_long[np.minimum(pos, len(keyed_long) - 1)] == key0 + x
        )
    else:
        hit = np.zeros(n_short, bool)
    # lookup_intersect charges zero work when either side is empty.
    probes = np.where(long_len > 0, short_len, 0).astype(np.int64)
    scanned = np.zeros(n_pairs, np.int64)
    np.add.at(scanned, pair_s, scanned_el)
    return hit, probes, scanned, pos


def _chain_stage(
    cur_vals: np.ndarray,
    cur_lens: np.ndarray,
    act_idx: np.ndarray,
    long_vals: np.ndarray,
    long_lens: np.ndarray,
    universes: np.ndarray,
    bucket_size: int,
    track_work: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One stage of a batched cost-ordered intersection chain.

    ``(cur_vals, cur_lens)`` is the running intersection of every item as
    a CSR; items listed in ``act_idx`` probe their next list
    (``long_vals``/``long_lens``, CSR over the active items in order) via
    ``_lookup_many`` and are filtered in place; the rest pass through.
    Returns ``(new_vals, new_lens, probes, scanned)`` with per-active-item
    work arrays bit-identical to looping ``lookup_intersect``.
    """
    cur_starts = _csr_starts(cur_lens)[:-1]
    sub_lens = cur_lens[act_idx]
    sub_vals = _ragged_gather(cur_vals, cur_starts[act_idx], sub_lens)
    hit, probes, scanned, _ = _lookup_many(
        sub_vals,
        _csr_starts(sub_lens),
        long_vals,
        _csr_starts(long_lens),
        universes,
        bucket_size,
        track_work=track_work,
    )
    rows, within = _ragged_indices(sub_lens)
    keep = np.ones(len(cur_vals), bool)
    keep[cur_starts[act_idx][rows] + within] = hit
    new_vals = cur_vals[keep]
    new_lens = cur_lens.copy()
    new_lens[act_idx] = np.bincount(rows[hit], minlength=len(act_idx)).astype(np.int64)
    return new_vals, new_lens, probes, scanned


def _cost_ordered_terms(cq: ConjunctiveQueries, slot_lens: np.ndarray) -> np.ndarray:
    """Each query's terms reordered by list length ascending (stable), the
    batched mirror of ``repro_torch.core.cluster_index.cost_order``.  Returns a
    flat array aligned with ``cq.q_ptr``: position ``q_ptr[i] + r`` holds
    query i's rank-r (r-th cheapest) term."""
    slot_q = np.repeat(np.arange(cq.n_queries, dtype=np.int64), cq.arities)
    slot_pos = np.arange(len(cq.q_terms), dtype=np.int64) - cq.q_ptr[:-1][slot_q]
    order = np.lexsort((slot_pos, slot_lens, slot_q))
    return cq.q_terms[order]


# ----------------------------------------------------------------------
# Planning: all (query, common-cluster) segment groups in one shot
# ----------------------------------------------------------------------


@dataclasses.dataclass
class SegmentPlan:
    """Every (query, common-leaf-cluster) segment group of a batch,
    ordered by (query, cluster) — the order ``HierIndex.query`` emits.

    A group holds one posting segment per query term (``arity`` of them),
    stored flat in ``seg_start``/``seg_len`` (absolute slices into
    ``index.post_docs``), *cost-ordered*: within a group, ``seg_ptr[g] +
    r`` is the r-th shortest segment (ties keep original term order) —
    the chain order of the per-cluster intersection.  ``level_work``
    holds one per-query work array per cluster level of the descent
    (empty for the flat L = 1 index); ``cluster_work`` is their
    element-wise sum — at L = 2, exactly the historical level-1 lookup
    work.
    """

    pair_query: np.ndarray  # (G,) int64 — query id of each segment group
    cluster: np.ndarray  # (G,) int64 — common leaf cluster id
    base: np.ndarray  # (G,) int64 — leaf_ranges[cluster]
    width: np.ndarray  # (G,) int64 — cluster width (leaf-level universe)
    arity: np.ndarray  # (G,) int64 — segments per group (= query arity)
    seg_ptr: np.ndarray  # (G + 1,) int64 — group offsets into seg_*
    seg_start: np.ndarray  # (S,) int64 — rank-ordered within each group
    seg_len: np.ndarray  # (S,) int64
    cluster_work: np.ndarray  # (n_queries,) int64 — summed descent work
    n_queries: int
    max_arity: int
    level_work: Tuple[np.ndarray, ...] = ()  # per cluster level, (n_queries,)

    @property
    def n_pairs(self) -> int:
        return len(self.pair_query)

    def validate(self) -> None:
        """Structural invariants of the plan (debug head: ``REPRO_DEBUG``).

        Group arrays are parallel, ``seg_ptr`` is the CSR of ``arity``,
        groups come out in the (query, cluster) emission order, every
        segment is a sane slice, and each group's segments are
        cost-ordered (nondecreasing length) — the chain-order premise of
        both the host chain and the device fold.
        """
        g = self.n_pairs
        for name in ("cluster", "base", "width", "arity"):
            if len(getattr(self, name)) != g:
                raise ValueError(f"SegmentPlan: {name} not parallel to pair_query")
        if len(self.seg_ptr) != g + 1 or self.seg_ptr[0] != 0:
            raise ValueError("SegmentPlan: seg_ptr must be a (G + 1,) CSR from 0")
        if (np.diff(self.seg_ptr) != self.arity).any():
            raise ValueError("SegmentPlan: seg_ptr increments must equal arity")
        n_seg = int(self.seg_ptr[-1])
        if len(self.seg_start) != n_seg or len(self.seg_len) != n_seg:
            raise ValueError("SegmentPlan: segment arrays disagree with seg_ptr")
        if g:
            if int(self.arity.min()) < 1:
                raise ValueError("SegmentPlan: every group needs >= 1 segment")
            if ((self.pair_query < 0) | (self.pair_query >= self.n_queries)).any():
                raise ValueError("SegmentPlan: pair_query outside [0, n_queries)")
            if (np.diff(self.pair_query) < 0).any():
                raise ValueError("SegmentPlan: groups must be query-ordered")
            if (self.width < 0).any() or (self.base < 0).any():
                raise ValueError("SegmentPlan: negative cluster base/width")
            if int(self.arity.max()) > int(self.max_arity):
                raise ValueError("SegmentPlan: max_arity below a group's arity")
        if n_seg and ((self.seg_start < 0) | (self.seg_len < 0)).any():
            raise ValueError("SegmentPlan: negative segment start/length")
        if n_seg > 1:
            starts = np.zeros(n_seg + 1, bool)
            starts[self.seg_ptr] = True
            ok = (np.diff(self.seg_len) >= 0) | starts[1:n_seg]
            if not ok.all():
                raise ValueError(
                    "SegmentPlan: segments within a group must be "
                    "cost-ordered (nondecreasing length)"
                )
        if len(self.cluster_work) != self.n_queries:
            raise ValueError("SegmentPlan: cluster_work not (n_queries,)")

    # Rank-0 / rank-1 views — the historical (short, long) segment pair of
    # a 2-term batch; ``long_len`` is 0 for single-term groups.

    @property
    def short_start(self) -> np.ndarray:
        return self.seg_start[self.seg_ptr[:-1]]

    @property
    def short_len(self) -> np.ndarray:
        return self.seg_len[self.seg_ptr[:-1]]

    @property
    def long_start(self) -> np.ndarray:
        return self.seg_start[self.seg_ptr[:-1] + np.minimum(self.arity - 1, 1)]

    @property
    def long_len(self) -> np.ndarray:
        i = self.seg_ptr[:-1] + np.minimum(self.arity - 1, 1)
        return np.where(self.arity >= 2, self.seg_len[i], 0)


def _empty_plan(n_levels: int) -> SegmentPlan:
    empty = np.zeros(0, np.int64)
    return SegmentPlan(
        pair_query=empty,
        cluster=empty,
        base=empty,
        width=empty,
        arity=empty,
        seg_ptr=np.zeros(1, np.int64),
        seg_start=empty,
        seg_len=empty,
        cluster_work=np.zeros(0, np.int64),
        n_queries=0,
        max_arity=0,
        level_work=tuple(np.zeros(0, np.int64) for _ in range(n_levels)),
    )


def _plan_flat_root(hidx, cq: ConjunctiveQueries) -> SegmentPlan:
    """The L = 1 plan: every query owns one whole-universe group whose
    segments are its full posting lists — the leaf chain then IS the
    cost-ordered single-index Lookup of ``chain_lookup``."""
    n = cq.n_queries
    ar = cq.arities
    max_a = cq.max_arity
    ptr = hidx.index.post_ptr
    parts_g, parts_pos, parts_st, parts_ln = [], [], [], []
    for r in range(max_a):
        qa = np.flatnonzero(ar > r)
        if len(qa) == 0:
            break
        t = cq.q_terms[cq.q_ptr[:-1][qa] + r]
        parts_g.append(qa)
        parts_pos.append(np.full(len(qa), r, np.int64))
        parts_st.append(ptr[t])
        parts_ln.append(ptr[t + 1] - ptr[t])
    if parts_g:
        flat_g = np.concatenate(parts_g)
        flat_pos = np.concatenate(parts_pos)
        flat_st = np.concatenate(parts_st)
        flat_ln = np.concatenate(parts_ln)
    else:
        flat_g = flat_pos = flat_st = flat_ln = np.zeros(0, np.int64)
    order2 = np.lexsort((flat_pos, flat_ln, flat_g))
    g_arity = ar.astype(np.int64)
    return SegmentPlan(
        pair_query=np.arange(n, dtype=np.int64),
        cluster=np.zeros(n, np.int64),
        base=np.zeros(n, np.int64),
        width=np.full(n, hidx.index.n_docs, np.int64),
        arity=g_arity,
        seg_ptr=_csr_starts(g_arity),
        seg_start=flat_st[order2],
        seg_len=flat_ln[order2],
        cluster_work=np.zeros(n, np.int64),
        n_queries=n,
        max_arity=max_a,
        level_work=(),
    )


def plan_segment_pairs(cidx, queries, track_work: bool = True) -> SegmentPlan:
    """Vectorized descent of the hierarchy for a whole batch.

    At every cluster level, each query's surviving node lists are chained
    smallest-first via keyed ``searchsorted`` — no Python per-query loop —
    with the same running-intersection probing (and work accounting) as
    ``HierIndex.query``; the common nodes of a level resolve, per
    original term slot, the contiguous child slice of the next level,
    and the leaf level resolves every common cluster to one posting
    segment per term, cost-ordered for the final per-cluster chain.

    ``cidx`` may be a :class:`repro_torch.core.hier_index.HierIndex` of any
    depth or the two-level ``ClusterIndex`` facade (the L = 2 view).

    ``track_work=False`` plans the identical segment groups without the
    per-level work accounting (``cluster_work`` / ``level_work`` come
    back zero) — the device engine's cheaper planning mode; every path
    that reports the paper's work metric must keep the default.
    """
    hidx = as_hier(cidx)
    cq = as_queries(queries)
    n = cq.n_queries
    ar = cq.arities
    max_a = cq.max_arity
    nlev = len(hidx.levels)
    if n == 0:
        return maybe_validate(_empty_plan(nlev))
    if nlev == 0:
        return maybe_validate(_plan_flat_root(hidx, cq))

    # Per-(slot, query) rows over the current level's CSR arrays.  At the
    # top level every row is a CONTIGUOUS slice of the level arrays, so
    # ``row_start`` holds global starts and no index scratch is needed
    # (`gi is None`); after a descent, rows are unions of child slices,
    # so ``gi`` flattens their global indices and ``row_start`` indexes
    # into it: row (r, q) is gi[row_start[r, q] :][: row_len[r, q]].
    lev = hidx.levels[0]
    row_len = np.zeros((max_a, n), np.int64)
    row_start = np.zeros((max_a, n), np.int64)
    for r in range(max_a):
        qa = np.flatnonzero(ar > r)
        t = cq.q_terms[cq.q_ptr[:-1][qa] + r]
        row_len[r, qa] = (lev.cl_ptr[t + 1] - lev.cl_ptr[t]).astype(np.int64)
        row_start[r, qa] = lev.cl_ptr[t]
    gi = None

    qarange = np.arange(n, dtype=np.int64)
    sentinel = np.iinfo(np.int64).max
    level_work = []
    for li in range(nlev):
        lev = hidx.levels[li]
        # vals_src is addressed by row positions: the level array itself
        # in contiguous mode, the gathered batch otherwise.
        vals_src = (
            lev.cl_ids.astype(np.int64)
            if gi is None
            else lev.cl_ids[gi].astype(np.int64)
        )

        # Cost order of each query's slots by current list length
        # (stable argsort → ties keep slot order, exactly `cost_order`).
        lens_m = np.where(
            np.arange(max_a)[:, None] < ar[None, :], row_len, sentinel
        )
        rank_slot = np.argsort(lens_m, axis=0, kind="stable")

        # Chain: the running intersection of every query probes its next
        # (rank-s) list, bucketized over this level's node universe.
        s0 = rank_slot[0]
        cur_lens = row_len[s0, qarange]
        cur_vals = vals_src[_ragged_range_idx(row_start[s0, qarange], cur_lens)]
        wk = np.zeros(n, np.int64)
        for s in range(1, max_a):
            act = np.flatnonzero(ar > s)
            if len(act) == 0:
                break
            sl = rank_slot[s, act]
            l_lens = row_len[sl, act]
            l_vals = vals_src[_ragged_range_idx(row_start[sl, act], l_lens)]
            cur_vals, cur_lens, probes, scanned = _chain_stage(
                cur_vals,
                cur_lens,
                act,
                l_vals,
                l_lens,
                np.full(len(act), lev.k, np.int64),
                hidx.bucket_size_clusters,
                track_work=track_work,
            )
            wk[act] += probes + scanned
        level_work.append(wk)

        # Groups: one per surviving (query, common node) at this level.
        group_query = np.repeat(qarange, cur_lens)
        g_arity = ar[group_query] if len(group_query) else np.zeros(0, np.int64)

        # Resolve each group to one entry per ORIGINAL term slot: the
        # common node is present in every slot's list, so a keyed
        # searchsorted per slot finds its row position exactly.
        key_base = lev.k + 1
        res_g, res_pos, res_gi = [], [], []
        for r in range(max_a):
            qa = np.flatnonzero(ar > r)
            if len(qa) == 0:
                break
            gm = np.flatnonzero(g_arity > r)
            lens_r = row_len[r, qa]
            l_ptr = _csr_starts(lens_r)
            keyed_long = (
                np.repeat(np.arange(len(qa), dtype=np.int64), lens_r) * key_base
                + vals_src[_ragged_range_idx(row_start[r, qa], lens_r)]
            )
            qrank = np.full(n, -1, np.int64)
            qrank[qa] = np.arange(len(qa))
            gq = qrank[group_query[gm]]
            pos = np.searchsorted(keyed_long, gq * key_base + cur_vals[gm])
            src_pos = row_start[r, qa][gq] + (pos - l_ptr[gq])
            res_g.append(gm)
            res_pos.append(np.full(len(gm), r, np.int64))
            res_gi.append(src_pos if gi is None else gi[src_pos])

        if li == nlev - 1:
            break

        # Descend: slot (r, q)'s next-level row is the concatenation of
        # its child slices over q's common nodes — parents ascend, so the
        # concatenation stays sorted.
        new_row_len = np.zeros((max_a, n), np.int64)
        new_row_start = np.zeros((max_a, n), np.int64)
        gi_parts = []
        off = 0
        for r, (gm, gidx) in enumerate(zip(res_g, res_gi, strict=True)):
            child_s = lev.seg_start[gidx]
            child_ln = lev.seg_end[gidx] - lev.seg_start[gidx]
            qa = np.flatnonzero(ar > r)
            lens_q = np.zeros(n, np.int64)
            np.add.at(lens_q, group_query[gm], child_ln)
            new_row_len[r] = lens_q
            new_row_start[r, qa] = off + _csr_starts(lens_q[qa])[:-1]
            gi_parts.append(_ragged_range_idx(child_s, child_ln))
            off += int(child_ln.sum())
        row_len, row_start = new_row_len, new_row_start
        gi = np.concatenate(gi_parts) if gi_parts else np.empty(0, np.int64)

    # Leaf resolution: flatten per-slot segments, cost-ordered within each
    # group (length ascending, ties by term order — exactly `cost_order`).
    if res_g:
        flat_g = np.concatenate(res_g)
        flat_pos = np.concatenate(res_pos)
        flat_gi = np.concatenate(res_gi)
        flat_st = lev.seg_start[flat_gi]
        flat_ln = lev.seg_end[flat_gi] - lev.seg_start[flat_gi]
    else:
        flat_g = flat_pos = flat_st = flat_ln = np.zeros(0, np.int64)
    order2 = np.lexsort((flat_pos, flat_ln, flat_g))
    cluster = cur_vals.astype(np.int64)
    plan = SegmentPlan(
        pair_query=group_query,
        cluster=cluster,
        base=lev.ranges[cluster],
        width=lev.ranges[cluster + 1] - lev.ranges[cluster],
        arity=g_arity,
        seg_ptr=_csr_starts(g_arity),
        seg_start=flat_st[order2],
        seg_len=flat_ln[order2],
        cluster_work=sum(level_work, np.zeros(n, np.int64)),
        n_queries=n,
        max_arity=max_a,
        level_work=tuple(level_work),
    )
    return maybe_validate(plan)


# ----------------------------------------------------------------------
# Host execution: exact doc ids + exact work accounting
# ----------------------------------------------------------------------


def batched_query(
    cidx, queries
) -> Tuple[np.ndarray, np.ndarray, Dict[str, float]]:
    """The whole hierarchical conjunctive-query batch on the host, exactly.

    ``cidx`` is a ``HierIndex`` of any depth or the two-level
    ``ClusterIndex`` facade.  Returns ``(ptr, docs, work)``:
    ``docs[ptr[i] : ptr[i + 1]]`` is bit-identical to
    ``cidx.query(*terms_i)[0]`` and ``work`` holds the summed per-query
    work dict of the loop (including the per-level ``level_{l}`` keys).
    """
    cq = as_queries(queries)
    plan = plan_segment_pairs(cidx, cq)
    docs64 = cidx.index.post_docs.astype(np.int64)
    n_g = plan.n_pairs
    r0 = plan.seg_ptr[:-1]
    cur_lens = plan.seg_len[r0].astype(np.int64)
    cur_vals = (
        _ragged_gather(docs64, plan.seg_start[r0], cur_lens)
        - plan.base[np.repeat(np.arange(n_g), cur_lens)]
    )
    probes_tot = scanned_tot = 0
    for s in range(1, plan.max_arity):
        act = np.flatnonzero(plan.arity > s)
        if len(act) == 0:
            break
        si = r0[act] + s
        l_lens = plan.seg_len[si].astype(np.int64)
        l_vals = (
            _ragged_gather(docs64, plan.seg_start[si], l_lens)
            - plan.base[act][np.repeat(np.arange(len(act)), l_lens)]
        )
        cur_vals, cur_lens, probes, scanned = _chain_stage(
            cur_vals,
            cur_lens,
            act,
            l_vals,
            l_lens,
            np.maximum(plan.width[act], 1),
            cidx.bucket_size_postings,
        )
        probes_tot += int(probes.sum())
        scanned_tot += int(scanned.sum())
    docs = (cur_vals + plan.base[np.repeat(np.arange(n_g), cur_lens)]).astype(
        np.int32
    )
    counts = np.zeros(plan.n_queries, np.int64)
    np.add.at(counts, plan.pair_query, cur_lens)
    ptr = np.zeros(plan.n_queries + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    cluster_level = int(plan.cluster_work.sum())
    work = {f"level_{i}": float(w.sum()) for i, w in enumerate(plan.level_work)}
    work.update(
        {
            "cluster_level": float(cluster_level),
            "probes": float(probes_tot),
            "scanned": float(scanned_tot),
            "total": float(cluster_level + probes_tot + scanned_tot),
        }
    )
    return ptr, docs, work


def batched_lookup(
    index, queries, bucket_size: int = 16
) -> Tuple[np.ndarray, np.ndarray, Dict[str, float]]:
    """The single-index Lookup chain, vectorized and exact.

    For each query: its posting lists, smallest-first, with the running
    intersection probing the next bucketized list — bit-identical results
    and work to the per-query ``lookup_intersect`` chain of
    ``SecludPipeline.evaluate`` (for 2 terms: the shorter list probes the
    longer, the historical loop).  Returns ``(ptr, docs, work)`` CSR.
    """
    cq = as_queries(queries)
    n = cq.n_queries
    docs64 = index.post_docs.astype(np.int64)
    lens_all = index.lengths()
    ord_terms = _cost_ordered_terms(cq, lens_all[cq.q_terms].astype(np.int64))
    t0 = ord_terms[cq.q_ptr[:-1]]
    cur_lens = lens_all[t0].astype(np.int64)
    cur_vals = _ragged_gather(docs64, index.post_ptr[t0], cur_lens)
    probes_tot = scanned_tot = 0
    for s in range(1, cq.max_arity):
        act = np.flatnonzero(cq.arities > s)
        if len(act) == 0:
            break
        ts = ord_terms[cq.q_ptr[:-1][act] + s]
        l_lens = lens_all[ts].astype(np.int64)
        l_vals = _ragged_gather(docs64, index.post_ptr[ts], l_lens)
        cur_vals, cur_lens, probes, scanned = _chain_stage(
            cur_vals,
            cur_lens,
            act,
            l_vals,
            l_lens,
            np.full(len(act), index.n_docs, np.int64),
            bucket_size,
        )
        probes_tot += int(probes.sum())
        scanned_tot += int(scanned.sum())
    docs = cur_vals.astype(np.int32)
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(cur_lens, out=ptr[1:])
    work = {
        "probes": float(probes_tot),
        "scanned": float(scanned_tot),
        "total": float(probes_tot + scanned_tot),
    }
    return ptr, docs, work


# ----------------------------------------------------------------------
# Device execution: the upload-once fused fold
# ----------------------------------------------------------------------


def batched_counts(
    cidx,
    queries,
    plan: SegmentPlan | None = None,
) -> Tuple[np.ndarray, Dict[str, float]]:
    """Per-query result counts through the device-resident engine.

    Delegates to :func:`repro_torch.core.device_engine.device_counts`: the
    index is uploaded once (cached on ``cidx``), the whole cost-ordered
    k-way chain runs as ONE fold kernel launch probing the resident posting
    array in place, and only the final counts return to host.  Counts
    are identical to ``HierIndex.query`` (and to the ``ClusterIndex``
    facade at L = 2) at any depth — the plan already encodes the whole
    descent.  ``info`` reports ``n_kernel_calls``, the total
    ``padding_overhead`` and per-stage attribution (see
    ``device_counts``).
    """
    from repro_torch.core.device_engine import device_counts

    return device_counts(cidx, queries, plan=plan)
