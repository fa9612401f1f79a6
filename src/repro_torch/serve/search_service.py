"""SeCluD search service on one device.

The paper's query algorithm as a serving system, at any hierarchy depth.
Queries are arbitrary-arity conjunctions (``repro_torch.core.queries``):
the historical ``(n, 2)`` term-pair array, the padded ``(n, max_arity)``
form, or a ``ConjunctiveQueries``.  Execution paths with the same
contract, all on the batched planner (``repro_torch.core.batched_query``
— no per-query loop), all routed through the fitted ``hier_index`` when
the result carries one (the two-level ``cluster_index`` otherwise):

  * ``serve_counts``        — host path (vectorized numpy Lookup, exact
    work metric, bit-identical to looping ``HierIndex.query``);
  * ``serve_counts_device`` — the device-resident engine: one fold kernel
    launch per batch against the uploaded index;
  * ``pack`` + ``device_counts`` — block path: fixed-shape padded rank-r
    segment blocks.  All-pair batches run the single ``intersect_count``
    kernel; mixed/higher arities fold the blocks pairwise with the masked
    members kernel, and the last stage counts its hits with the members
    count kernel.

The service runs on one explicit device (default ``"cuda"``; raises
without a GPU; ``device="cpu"`` runs the plain PyTorch path).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.batched_query import batched_query, gather_padded, plan_segment_pairs
from repro_torch.core.device_engine import resolve_device
from repro_torch.core.hier_index import as_hier
from repro_torch.core.queries import as_queries
from repro_torch.core.seclud import SecludResult
from repro_torch.kernels.intersect.ref import PAD

__all__ = ["SearchService", "PackedClusters"]


@dataclasses.dataclass
class PackedClusters:
    """Block layout: for each (query, leaf-cluster-of-query) group the
    cost-ordered posting segments, padded to fixed per-rank widths and
    stacked.  ``segments[r]`` is the (R, L_r) rank-r block; rows whose
    query has fewer than r + 1 terms are all-PAD.  ``row_top`` is each
    row's top-level (level-0) ancestor cluster (equal to the leaf cluster
    at L = 2, 0 at L = 1)."""

    segments: Tuple[np.ndarray, ...]
    row_query: np.ndarray  # (R,) query id of each row
    row_arity: np.ndarray  # (R,) int32 — segments actually present per row
    n_queries: int
    row_top: Optional[np.ndarray] = None  # (R,) int32 — level-0 ancestor

    @property
    def short(self) -> np.ndarray:
        """Rank-0 block (the probing side of every row's chain)."""
        return self.segments[0]

    @property
    def long(self) -> np.ndarray:
        """Rank-1 block — THE long side for the historical 2-term pack."""
        return self.segments[1]


class SearchService:
    def __init__(self, result: SecludResult, device=None):
        self.res = result
        self.device = resolve_device(device)
        self._device_index = None

    @property
    def query_index(self):
        """The index queries route through: the fitted L-level
        ``hier_index`` when the result carries one, else the two-level
        ``cluster_index``."""
        hier = getattr(self.res, "hier_index", None)
        return hier if hier is not None else self.res.cluster_index

    @property
    def device_index(self):
        """The upload-once :class:`repro_torch.core.device_engine.DeviceIndex`
        on this service's device.  Built on first access (or inherited
        from ``SecludPipeline.fit`` on the same device, which caches it
        on the fitted index) and reused by every subsequent batch."""
        if self._device_index is None:
            from repro_torch.core.device_engine import device_index

            self._device_index = device_index(self.query_index, self.device)
        return self._device_index

    # -- host path -------------------------------------------------------

    def serve_counts(self, queries) -> Tuple[np.ndarray, dict]:
        """Exact per-query result counts via the hierarchical descent.

        One vectorized engine pass (``repro_torch.core.batched_query``) —
        counts and total work are bit-identical to looping
        ``query_index.query`` over the conjunctions, at any depth.
        """
        ptr, _docs, work = batched_query(self.query_index, queries)
        return np.diff(ptr).astype(np.int64), {"work": work["total"]}

    # -- device path ------------------------------------------------------

    def serve_counts_device(self, queries, return_docs: bool = False):
        """Exact per-query counts through the device-resident engine.

        The whole cost-ordered k-way chain runs as one fold kernel launch
        against the persistent :attr:`device_index`; only the counts (and,
        on request, the member doc ids) return to the host.  Counts are
        bit-identical to :meth:`serve_counts`; ``info`` carries the
        engine's ``n_kernel_calls`` / ``padding_overhead`` attribution.
        """
        from repro_torch.core.device_engine import device_counts

        return device_counts(
            self.query_index,
            queries,
            dindex=self.device_index,
            return_docs=return_docs,
        )

    def pack(self, queries, pad_to: int = 128, pin_top: bool = False) -> PackedClusters:
        """Build the fixed-shape per-(query, leaf-cluster) segment batch.

        Rows come from the batched planner (one CSR descent for the whole
        batch, no per-query loop); each query contributes one row per
        common leaf cluster holding its ``arity`` cost-ordered segments.
        An empty plan yields an honestly-empty ``(0, pad_to)`` pack.

        ``pin_top=True`` orders rows by their top-level (level-0)
        ancestor, so a contiguous row split pins each level-0 cluster's
        work to one part.  Counts are unaffected — the per-query sum is
        order-invariant.
        """
        cq = as_queries(queries)
        qidx = self.query_index
        hidx = as_hier(qidx)
        plan = plan_segment_pairs(hidx, cq)
        docs = hidx.index.post_docs
        n_rows = plan.n_pairs
        if hidx.levels:
            top_ranges = hidx.levels[0].ranges
            row_top = (
                np.searchsorted(top_ranges, plan.base, side="right") - 1
            ).astype(np.int32)
        else:
            row_top = np.zeros(n_rows, np.int32)
        sel = (
            np.argsort(row_top, kind="stable")
            if pin_top
            else np.arange(n_rows)
        )
        max_a = max(plan.max_arity, 2)  # always expose short+long blocks
        segments = []
        for r in range(max_a):
            has = plan.arity[sel] > r
            si = np.where(has, plan.seg_ptr[:-1][sel] + r, 0)  # 0 = safe index
            starts = plan.seg_start[si]
            lens = np.where(has, plan.seg_len[si], 0)
            width = max(int(lens.max()) if n_rows else 0, pad_to)
            width = -(-width // pad_to) * pad_to
            segments.append(gather_padded(docs, starts, lens, width))
        return PackedClusters(
            segments=tuple(segments),
            row_query=plan.pair_query[sel].astype(np.int32),
            row_arity=plan.arity[sel].astype(np.int32),
            n_queries=cq.n_queries,
            row_top=row_top[sel],
        )

    def device_counts(self, packed: PackedClusters) -> torch.Tensor:
        """Intersect all rows on this service's device; per-query counts
        as an int32 tensor there.

        Pairs-only batches run one ``intersect_count`` reduction.  Mixed
        or higher arities keep each row's running intersection in the
        rank-0 block: every rank but the last filters it in place with the
        masked members kernel (rows with arity > r); the last rank only
        needs the survivors' number, so rows that reach it count their
        hits with the members count kernel and the others count their
        surviving cells.
        """
        from repro_torch.kernels.intersect.ops import intersect_count, intersect_members

        nq = packed.n_queries
        dev = self.device
        if packed.short.shape[0] == 0:
            return torch.zeros(nq, dtype=torch.int32, device=dev)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

        segs = tuple(put(b) for b in packed.segments)
        rq = put(packed.row_query).long()
        ra = put(packed.row_arity)
        pairs_only = bool((packed.row_arity == 2).all()) and len(segs) == 2
        if pairs_only:
            c = intersect_count(segs[0], segs[1])
        else:
            cur = segs[0]
            last = len(segs) - 1
            for r in range(1, last):
                masked = intersect_members(cur, segs[r], reduce="mask")
                cur = torch.where((ra > r)[:, None], masked, cur)
            hits = intersect_members(cur, segs[last], reduce="count")
            c = torch.where(ra > last, hits, (cur != int(PAD)).sum(dim=1).to(torch.int32))
        out = torch.zeros(nq, dtype=torch.int32, device=dev)
        return out.index_add_(0, rq, c)
