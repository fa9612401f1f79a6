"""Arbitrary-depth hierarchical cluster index — depth is a parameter,
not an architecture.

The paper's clustering is explicitly *multilevel* (§3.2) and motivates
clusters as a way to "distribute the work over many machines" (§1), yet
the original query side hard-coded exactly two levels.  A
:class:`HierIndex` generalizes the §3.3 cluster index to L levels:

    postings (level L-1)  <-  clusters  <-  super-clusters  <-  ...  <- top

Every *cluster level* l (0 = coarsest .. L-2 = leaf clusters) is one
uniform CSR :class:`HierLevel` ``(cl_ptr, cl_ids, seg_start, seg_end,
ranges)``: for each term, the sorted ids of the level-l nodes containing
it, and for each (term, node) entry the contiguous slice of the *next*
level's ``cl_ids`` holding that node's children for the term — at the
leaf level the slice points into ``index.post_docs`` (the posting
segment).  Nodes own contiguous document-id ranges (``ranges``) and a
parent's children occupy a contiguous id block, which is what makes every
per-(term, node) restriction a single slice — no data duplication at any
depth.

Degeneracies (the compatibility contract, property-tested):

* **L = 1** — zero cluster levels: a query is exactly the single-index
  cost-ordered Lookup chain of Sanders & Transier [14]
  (``repro_torch.index.lookup.chain_lookup`` — bucket size 16, universe
  ``n_docs``), results and work bit-for-bit.
* **L = 2** — one cluster level: exactly the historical
  ``ClusterIndex`` — same arrays, same cost-ordered two-level query,
  same ``cluster_level/probes/scanned/total`` work accounting bit-for-bit
  (``repro_torch.core.cluster_index.ClusterIndex`` is now a thin facade over
  this module).

Querying descends the hierarchy with the existing cost-ordered chain at
every level: at each cluster level the surviving node lists are
intersected smallest-first through the bucketed Lookup (bucket size 8,
universe k_l), the common nodes resolve each term's next-level slices,
and the leaf level runs the per-cluster posting chain (bucket size 16,
local universe = cluster width).  The work dict gains one ``level_{l}``
key per cluster level while preserving the historical totals.

Exactness stays the defining invariant: every depth returns the
identical result set.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.analysis.runtime import maybe_validate
from repro_torch.index.build import InvertedIndex
from repro_torch.index.lookup import bucketize, cost_order, lookup_intersect

__all__ = [
    "HierLevel",
    "HierIndex",
    "build_hier_index",
    "as_hier",
    "shard_tops",
]


def _flatten_terms(terms: Sequence) -> Tuple[int, ...]:
    """query(t, u), query(t, u, v), query([t, u, v]) all mean the same."""
    if len(terms) == 1 and not np.isscalar(terms[0]) and hasattr(terms[0], "__len__"):
        terms = tuple(terms[0])
    out = tuple(int(t) for t in terms)
    if not out:
        raise ValueError("a conjunctive query needs >= 1 term")
    return out


def _concat_ranges(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Concatenate ``arange(starts[i], ends[i])`` for all i, vectorized."""
    lens = (ends - starts).astype(np.int64)
    tot = int(lens.sum())
    if tot == 0:
        return np.empty(0, np.int64)
    rows = np.repeat(np.arange(len(starts)), lens)
    within = np.arange(tot, dtype=np.int64) - (np.cumsum(lens) - lens)[rows]
    return starts[rows] + within


@dataclasses.dataclass
class HierLevel:
    """One cluster level: CSR of (term -> nodes containing it, with the
    child slice of each (term, node) entry in the next level's array)."""

    cl_ptr: np.ndarray  # (n_terms + 1,) int64
    cl_ids: np.ndarray  # (nnz_l,) int32 — sorted node ids per term
    seg_start: np.ndarray  # (nnz_l,) int64 — child-slice start (absolute)
    seg_end: np.ndarray  # (nnz_l,) int64
    ranges: np.ndarray  # (k_l + 1,) int64 — node doc-id boundaries

    @property
    def k(self) -> int:
        return len(self.ranges) - 1

    def term_entries(
        self, t: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        lo, hi = self.cl_ptr[t], self.cl_ptr[t + 1]
        return self.cl_ids[lo:hi], self.seg_start[lo:hi], self.seg_end[lo:hi]


@dataclasses.dataclass
class HierIndex:
    """L-level hierarchical cluster index over a reordered inverted index.

    ``levels`` runs coarse -> fine; ``levels[-1]``'s segments are posting
    slices into ``index.post_docs``.  ``levels == ()`` is the flat L = 1
    single-index Lookup.
    """

    levels: Tuple[HierLevel, ...]
    index: InvertedIndex
    bucket_size_clusters: int = 8
    bucket_size_postings: int = 16

    @property
    def depth(self) -> int:
        """L: number of levels including the posting level."""
        return len(self.levels) + 1

    @property
    def k(self) -> int:
        """Leaf cluster count (1 for the flat L = 1 index)."""
        return self.levels[-1].k if self.levels else 1

    @property
    def leaf_ranges(self) -> np.ndarray:
        if self.levels:
            return self.levels[-1].ranges
        return np.array([0, self.index.n_docs], dtype=np.int64)

    @property
    def top_ranges(self) -> np.ndarray:
        """Level-0 (coarsest) node doc-id boundaries — the machine-level
        partitioning unit (one implicit root for the flat L = 1 index)."""
        if self.levels:
            return self.levels[0].ranges
        return np.array([0, self.index.n_docs], dtype=np.int64)

    def validate(self) -> None:
        """Structural invariants of the hierarchy (debug head:
        ``REPRO_DEBUG`` via :mod:`repro_torch.analysis.runtime`).

        Every level's ranges are a monotone boundary array over [0, n]
        nested in the next finer level; every level CSR is monotone with
        sorted node ids per term and in-bounds child segments; postings
        are strictly increasing within each term segment — the premise
        of both the host chain and the device binary search.
        """
        n = self.index.n_docs
        m = self.index.n_terms
        post_ptr = np.asarray(self.index.post_ptr)
        post_docs = np.asarray(self.index.post_docs)
        n_post = len(post_docs)
        if len(post_ptr) != m + 1 or post_ptr[0] != 0 or post_ptr[-1] != n_post:
            raise ValueError("HierIndex: post_ptr must span [0, n_postings]")
        if (np.diff(post_ptr) < 0).any():
            raise ValueError("HierIndex: post_ptr must be nondecreasing")
        if n_post > 1:
            seg_start = np.zeros(n_post + 1, bool)
            seg_start[post_ptr] = True
            if not ((np.diff(post_docs) > 0) | seg_start[1:n_post]).all():
                raise ValueError(
                    "HierIndex: postings must be strictly increasing "
                    "within each term segment"
                )
        ranges_list = [lev.ranges for lev in self.levels]
        for r in ranges_list:
            if len(r) < 2 or r[0] != 0 or r[-1] != n or (np.diff(r) < 0).any():
                raise ValueError(
                    "HierIndex: level ranges must be a nondecreasing "
                    f"boundary array spanning [0, {n}]"
                )
        for coarse, fine in zip(ranges_list, ranges_list[1:], strict=False):
            _check_nested(coarse, fine)
        for i, lev in enumerate(self.levels):
            nnz = len(lev.cl_ids)
            if (
                len(lev.cl_ptr) != m + 1
                or lev.cl_ptr[0] != 0
                or lev.cl_ptr[-1] != nnz
                or (np.diff(lev.cl_ptr) < 0).any()
            ):
                raise ValueError(f"HierIndex: level {i} cl_ptr not a CSR over terms")
            if len(lev.seg_start) != nnz or len(lev.seg_end) != nnz:
                raise ValueError(f"HierIndex: level {i} segment arrays mismatch")
            if nnz and ((lev.cl_ids < 0) | (lev.cl_ids >= lev.k)).any():
                raise ValueError(f"HierIndex: level {i} node ids outside [0, k)")
            if nnz > 1:
                term_start = np.zeros(nnz + 1, bool)
                term_start[lev.cl_ptr] = True
                if not ((np.diff(lev.cl_ids) > 0) | term_start[1:nnz]).all():
                    raise ValueError(
                        f"HierIndex: level {i} node ids must be strictly "
                        "increasing per term"
                    )
            bound = (
                len(self.levels[i + 1].cl_ids)
                if i + 1 < len(self.levels)
                else n_post
            )
            if nnz and (
                (lev.seg_start < 0)
                | (lev.seg_start > lev.seg_end)
                | (lev.seg_end > bound)
            ).any():
                raise ValueError(
                    f"HierIndex: level {i} child segments out of bounds "
                    "or inverted"
                )

    def slice_top(self, top_lo: int, top_hi: int) -> "HierIndex":
        """The index restricted to top-level nodes ``[top_lo, top_hi)`` —
        the host view of one corpus shard.

        The returned index keeps the ORIGINAL doc-id space, node ids and
        posting array (shared, no copies of ``post_docs``); only the
        per-term CSR entries of nodes outside the top range are dropped,
        so a query returns exactly the global result docs that live in
        the shard's doc range.  Because every leaf cluster lies wholly in
        one shard, summed per-shard counts (and the union of per-shard
        result sets) reproduce the global query bit-for-bit — the oracle
        the sharded device engine is tested against.
        """
        if not self.levels:
            if (top_lo, top_hi) != (0, 1):
                raise ValueError("flat index has exactly one top node")
            return self
        top = self.levels[0]
        if not (0 <= top_lo <= top_hi <= top.k):
            raise ValueError(
                f"top range [{top_lo}, {top_hi}) outside [0, {top.k}]"
            )
        doc_lo = int(top.ranges[top_lo])
        doc_hi = int(top.ranges[top_hi])
        # Per level: the kept node-id range (nested ranges ⇒ doc_lo/doc_hi
        # are boundaries of every level) and the entry keep-mask.
        masks, shifts = [], []
        for lev in self.levels:
            nlo = int(np.searchsorted(lev.ranges, doc_lo))
            nhi = int(np.searchsorted(lev.ranges, doc_hi))
            mask = (lev.cl_ids >= nlo) & (lev.cl_ids < nhi)
            # shift[i] = entries removed before position i (inclusive of
            # nothing at i); one extra slot so seg_end == len remaps too.
            shift = np.zeros(len(mask) + 1, np.int64)
            np.cumsum(~mask, out=shift[1:])
            masks.append(mask)
            shifts.append(shift)
        new_levels = []
        m = self.index.n_terms
        for li, lev in enumerate(self.levels):
            mask = masks[li]
            term_of = np.repeat(np.arange(m, dtype=np.int64), np.diff(lev.cl_ptr))
            cl_ptr = np.zeros(m + 1, np.int64)
            np.add.at(cl_ptr, term_of[mask] + 1, 1)
            np.cumsum(cl_ptr, out=cl_ptr)
            seg_start = lev.seg_start[mask]
            seg_end = lev.seg_end[mask]
            if li < len(self.levels) - 1:
                # Child slices index the next level's (filtered) cl_ids: a
                # kept node's children are all kept, so the whole slice
                # shifts by one constant.
                sh = shifts[li + 1]
                seg_start = seg_start - sh[seg_start]
                seg_end = seg_end - sh[seg_end]
            # Leaf slices stay absolute into the shared post_docs.
            new_levels.append(
                HierLevel(
                    cl_ptr=cl_ptr,
                    cl_ids=lev.cl_ids[mask],
                    seg_start=seg_start,
                    seg_end=seg_end,
                    ranges=lev.ranges,
                )
            )
        return HierIndex(
            levels=tuple(new_levels),
            index=self.index,
            bucket_size_clusters=self.bucket_size_clusters,
            bucket_size_postings=self.bucket_size_postings,
        )

    # ------------------------------------------------------------------
    # Descent
    # ------------------------------------------------------------------

    def _descend(self, terms: Tuple[int, ...], merge: bool):
        """Walk the cluster levels with a cost-ordered chain at each one.

        Returns ``(common, pos, seg_s, seg_e, ranges, work_levels)``:
        the common leaf clusters, each term's entry positions for them,
        the term's leaf segment arrays, the leaf ranges and the per-level
        chain work.  ``merge=True`` replaces the bucketed Lookup with a
        direct merge-join (work = sum of list lengths per chain stage) —
        the 'most direct way' of §3.3, kept as an independent oracle.
        """
        a = len(terms)
        work_levels: List[float] = []
        if not self.levels:
            # L = 1: a single implicit root node covering every document.
            ptr = self.index.post_ptr
            common = np.zeros(1, np.int32)
            pos = [np.zeros(1, np.int64)] * a
            seg_s = [np.array([ptr[t]], np.int64) for t in terms]
            seg_e = [np.array([ptr[t + 1]], np.int64) for t in terms]
            return common, pos, seg_s, seg_e, self.leaf_ranges, work_levels

        lev = self.levels[0]
        entries = [lev.term_entries(t) for t in terms]
        ids = [e[0] for e in entries]
        ss = [e[1] for e in entries]
        se = [e[2] for e in entries]
        for li, lev in enumerate(self.levels):
            order = cost_order([len(x) for x in ids])
            if merge:
                common = ids[order[0]]
                w_lvl = 0.0
                for i in order[1:]:
                    w_lvl += float(len(common) + len(ids[i]))
                    common = np.intersect1d(common, ids[i])
            else:
                common = ids[order[0]].astype(np.int32)
                w_lvl = 0.0
                for i in order[1:]:
                    common, w1 = lookup_intersect(
                        common,
                        bucketize(
                            ids[i].astype(np.int32),
                            lev.k,
                            self.bucket_size_clusters,
                        ),
                    )
                    w_lvl += w1["total"]
            work_levels.append(w_lvl)
            pos = [np.searchsorted(ids[i], common) for i in range(a)]
            if li == len(self.levels) - 1:
                return common, pos, ss, se, lev.ranges, work_levels
            nxt = self.levels[li + 1]
            new_ids, new_ss, new_se = [], [], []
            for i in range(a):
                gi = _concat_ranges(ss[i][pos[i]], se[i][pos[i]])
                new_ids.append(nxt.cl_ids[gi])
                new_ss.append(nxt.seg_start[gi])
                new_se.append(nxt.seg_end[gi])
            ids, ss, se = new_ids, new_ss, new_se
        raise AssertionError("unreachable")

    def _leaf_chain(
        self,
        terms: Tuple[int, ...],
        common: np.ndarray,
        pos: List[np.ndarray],
        seg_s: List[np.ndarray],
        seg_e: List[np.ndarray],
        ranges: np.ndarray,
    ) -> Tuple[np.ndarray, int, int]:
        """Per-cluster posting intersection, cost-ordered chain (bucket
        size 16, local universe = cluster width)."""
        docs = self.index.post_docs
        results = []
        probes = scanned = 0
        for j, ci in enumerate(common):
            base = ranges[ci]
            width = int(ranges[ci + 1] - base)
            slices = [
                docs[seg_s[i][pos[i][j]] : seg_e[i][pos[i][j]]]
                for i in range(len(terms))
            ]
            order = cost_order([len(s) for s in slices])
            cur = (slices[order[0]] - base).astype(np.int32)
            for i in order[1:]:
                blong = bucketize(
                    slices[i] - base, max(width, 1), self.bucket_size_postings
                )
                cur, w2 = lookup_intersect(cur, blong)
                probes += w2["probes"]
                scanned += w2["scanned"]
            if len(cur):
                results.append(cur.astype(np.int64) + base)
        out = (
            np.concatenate(results).astype(np.int32)
            if results
            else np.empty(0, np.int32)
        )
        return out, probes, scanned

    @staticmethod
    def _work_dict(
        work_levels: List[float], probes: int, scanned: int
    ) -> Dict[str, float]:
        cluster_level = float(sum(work_levels))
        work = {f"level_{li}": float(w) for li, w in enumerate(work_levels)}
        work.update(
            {
                "cluster_level": cluster_level,
                "probes": float(probes),
                "scanned": float(scanned),
                "total": cluster_level + probes + scanned,
            }
        )
        return work

    # ------------------------------------------------------------------
    # Query algorithms
    # ------------------------------------------------------------------

    def query(self, *terms) -> Tuple[np.ndarray, Dict[str, float]]:
        """L-level conjunctive query over k >= 1 terms: a cost-ordered
        bucketed-Lookup chain at every cluster level, then the
        cost-ordered per-cluster posting chain.  Returns (result doc ids,
        work dict with per-level ``level_{l}`` keys plus the historical
        ``cluster_level/probes/scanned/total`` totals)."""
        terms = _flatten_terms(terms)
        common, pos, seg_s, seg_e, ranges, work_levels = self._descend(
            terms, merge=False
        )
        out, probes, scanned = self._leaf_chain(
            terms, common, pos, seg_s, seg_e, ranges
        )
        return out, self._work_dict(work_levels, probes, scanned)

    def query_all_clusters(self, *terms) -> Tuple[np.ndarray, Dict[str, float]]:
        """The descent WITHOUT the bucketed Lookup at the cluster levels:
        node lists are merge-joined directly (work = Σ lengths per chain
        stage) and the posting chain runs inside every common leaf
        cluster.  This is the 'most direct way' of §3.3 — competitive when
        k is small, and the oracle the bucketed chain of :meth:`query`
        must match exactly at every depth."""
        terms = _flatten_terms(terms)
        common, pos, seg_s, seg_e, ranges, work_levels = self._descend(
            terms, merge=True
        )
        out, probes, scanned = self._leaf_chain(
            terms, common, pos, seg_s, seg_e, ranges
        )
        return out, self._work_dict(work_levels, probes, scanned)

    def query_batch(self, queries) -> Tuple[np.ndarray, np.ndarray, Dict[str, float]]:
        """Vectorized :meth:`query` over a query batch — see
        ``repro_torch.core.batched_query.batched_query`` (bit-identical results
        and work dicts, no per-query Python loop)."""
        from repro_torch.core.batched_query import batched_query

        return batched_query(self, queries)

    def device(self, device=None):
        """The upload-once device mirror of this index
        (:class:`repro_torch.core.device_engine.DeviceIndex`): ``post_docs``
        and every level CSR resident as tensors on ``device`` (default
        ``"cuda"``), built on first call and cached on this object — every
        device batch afterwards reuses the same copy."""
        from repro_torch.core.device_engine import device_index

        return device_index(self, device)


# ----------------------------------------------------------------------
# Construction
# ----------------------------------------------------------------------


def _rle_term_parent(
    ptr: np.ndarray, parent: np.ndarray, m: int, k: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """O(nnz) run-length encoding of (term, parent) runs over a per-term
    CSR whose items are already grouped by parent within each term.

    Returns ``(cl_ptr, cl_ids, seg_start, seg_end)`` where the segments
    are absolute slices into the item array ``ptr`` indexes.
    """
    term = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
    key = term * k + parent.astype(np.int64)
    change = np.empty(len(key), dtype=bool)
    if len(key):
        change[0] = True
        np.not_equal(key[1:], key[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    ukey = key[starts]
    ends = np.append(starts[1:], len(key))
    cl_ids = (ukey % k).astype(np.int32)
    uterm = ukey // k
    cl_ptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(cl_ptr, uterm + 1, 1)
    np.cumsum(cl_ptr, out=cl_ptr)
    return cl_ptr, cl_ids, starts.astype(np.int64), ends.astype(np.int64)


def _check_nested(coarse: np.ndarray, fine: np.ndarray) -> None:
    """Every coarse boundary must be a fine boundary (children of a node
    occupy a contiguous block of the finer level)."""
    pos = np.searchsorted(fine, coarse)
    ok = (pos < len(fine)) & (fine[np.minimum(pos, len(fine) - 1)] == coarse)
    if not ok.all():
        bad = coarse[~ok]
        raise ValueError(
            f"level ranges are not nested: boundaries {bad[:5].tolist()} of a "
            "coarser level are not boundaries of the next finer level"
        )


def build_hier_index(
    reordered_index: InvertedIndex,
    level_ranges: Sequence[np.ndarray],
    bucket_size_clusters: int = 8,
    bucket_size_postings: int = 16,
) -> HierIndex:
    """Build an L-level index from nested per-level cluster boundaries.

    ``level_ranges`` runs coarse -> fine (L - 1 arrays; ``[]`` builds the
    flat L = 1 index); each is a ``(k_l + 1,)`` boundary array over the
    *reordered* (cluster-contiguous) document-id space, and every coarser
    boundary must also be a boundary of the next finer level.  O(nnz)
    per level via run-length encoding — the leaf level over the posting
    array, each upper level over the level below's ``cl_ids``.
    """
    level_ranges = [np.asarray(r, dtype=np.int64) for r in level_ranges]
    n = reordered_index.n_docs
    m = reordered_index.n_terms
    for r in level_ranges:
        if len(r) < 2 or r[0] != 0 or r[-1] != n or (np.diff(r) < 0).any():
            raise ValueError(
                "each level's ranges must be a nondecreasing boundary array "
                f"spanning [0, {n}], got {r[:5]}..."
            )
    for coarse, fine in zip(level_ranges, level_ranges[1:], strict=False):
        _check_nested(coarse, fine)

    if not level_ranges:
        return maybe_validate(
            HierIndex(
                levels=(),
                index=reordered_index,
                bucket_size_clusters=bucket_size_clusters,
                bucket_size_postings=bucket_size_postings,
            )
        )

    # Leaf level: RLE over (term, leaf cluster) pairs of the posting array.
    leaf_ranges = level_ranges[-1]
    docs = reordered_index.post_docs.astype(np.int64)
    parent = np.searchsorted(leaf_ranges, docs, side="right") - 1
    cl_ptr, cl_ids, seg_s, seg_e = _rle_term_parent(
        reordered_index.post_ptr, parent, m, len(leaf_ranges) - 1
    )
    levels = [
        HierLevel(
            cl_ptr=cl_ptr,
            cl_ids=cl_ids,
            seg_start=seg_s,
            seg_end=seg_e,
            ranges=leaf_ranges,
        )
    ]
    # Upper levels, fine -> coarse: the level-l entry of a term segments
    # the level-(l+1) cl_ids of that term by parent node.
    child_ranges = leaf_ranges
    for up_ranges in reversed(level_ranges[:-1]):
        child = levels[0]
        # Parent of each child NODE via its doc-range start (empty nodes
        # map somewhere harmlessly — they never appear in cl_ids).
        parent_of_node = (
            np.searchsorted(up_ranges, child_ranges[:-1], side="right") - 1
        ).astype(np.int64)
        parent_items = parent_of_node[child.cl_ids]
        cl_ptr, cl_ids, seg_s, seg_e = _rle_term_parent(
            child.cl_ptr, parent_items, m, len(up_ranges) - 1
        )
        levels.insert(
            0,
            HierLevel(
                cl_ptr=cl_ptr,
                cl_ids=cl_ids,
                seg_start=seg_s,
                seg_end=seg_e,
                ranges=up_ranges,
            ),
        )
        child_ranges = up_ranges
    return maybe_validate(
        HierIndex(
            levels=tuple(levels),
            index=reordered_index,
            bucket_size_clusters=bucket_size_clusters,
            bucket_size_postings=bucket_size_postings,
        )
    )


def shard_tops(hidx: HierIndex, n_shards: int) -> np.ndarray:
    """Contiguous partition of the top-level nodes into ``n_shards``
    shards, balanced by posting mass.

    Returns the ``(n_shards + 1,)`` top-node boundary array: shard s owns
    top nodes ``[bounds[s], bounds[s + 1])`` — and therefore (nested
    contiguous ranges) the contiguous doc-id range
    ``[top_ranges[bounds[s]], top_ranges[bounds[s + 1]])`` and every
    posting of every document in it.  Splits sit at the posting-mass
    quantiles, so shards carry roughly equal intersection work; with more
    shards than top nodes the tail shards come back empty (boundaries
    repeat) rather than splitting a top node — a top cluster is the
    paper's unit of machine-level distribution and never straddles two
    shards.
    """
    hidx = as_hier(hidx)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    top_ranges = hidx.top_ranges
    k0 = len(top_ranges) - 1
    docs = hidx.index.post_docs.astype(np.int64)
    top_of_post = np.searchsorted(top_ranges, docs, side="right") - 1
    mass = np.bincount(top_of_post, minlength=k0).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(mass)])
    total = int(cum[-1])
    targets = total * np.arange(1, n_shards, dtype=np.float64) / n_shards
    cuts = np.searchsorted(cum, targets, side="left").astype(np.int64)
    bounds = np.concatenate([[0], np.minimum(cuts, k0), [k0]])
    return np.maximum.accumulate(bounds)


def as_hier(idx) -> HierIndex:
    """Coerce a query index to :class:`HierIndex`.

    Accepts a ``HierIndex`` (returned as-is) or anything exposing the
    two-level ``ClusterIndex`` protocol (``cl_ptr/cl_ids/seg_start/
    seg_end/ranges/index``) — the historical facade, viewed as the L = 2
    case without copying any array.
    """
    if isinstance(idx, HierIndex):
        return idx
    if hasattr(idx, "as_hier"):
        return idx.as_hier()
    return HierIndex(
        levels=(
            HierLevel(
                cl_ptr=idx.cl_ptr,
                cl_ids=idx.cl_ids,
                seg_start=idx.seg_start,
                seg_end=idx.seg_end,
                ranges=idx.ranges,
            ),
        ),
        index=idx.index,
        bucket_size_clusters=idx.bucket_size_clusters,
        bucket_size_postings=idx.bucket_size_postings,
    )
