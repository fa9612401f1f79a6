"""SeCluD search service: one device, or shard slots over several.

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
    count kernel.  ``device_counts(packed, devices=...)`` splits the rows
    into contiguous blocks, one per device, and sums the counts.

The clusters also distribute the work (the paper §1: "the resulting
clusters are also useful ... for distributing the work over many
machines"): after :meth:`SearchService.enable_sharded` the device engine
partitions the corpus by top-level cluster over shard slots, runs one
fold launch per shard, and evicts a persistently slow shard (its slot is
dropped, the corpus re-partitioned over the survivors) without changing
a single answer.

The service runs on one explicit device (default ``"cuda"``; raises
without a GPU; ``device="cpu"`` runs the plain PyTorch path).  Shards
are slots of explicit devices (``devices=["cpu"] * S`` on the CPU,
``[cuda:0] * S`` on one GPU); without ``devices`` they take every
visible CUDA device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

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
        self._sharded = None  # ShardedDeviceIndex once enable_sharded ran
        self._elastic = None  # ElasticMesh owning the serving slot pool
        self._monitor = None  # StragglerMonitor over the shards
        self._faults = None  # FaultInjector threaded into the engines

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

        After :meth:`enable_sharded` the same call serves through the
        sharded engine — one fold launch per shard over the per-shard
        corpus partitions, counts summed — with results still
        bit-identical (``info`` gains the sharding attribution).
        """
        from repro_torch.core.device_engine import device_counts, sharded_device_counts

        if self._sharded is not None:
            out = sharded_device_counts(
                self.query_index,
                queries,
                sidx=self._sharded,
                return_docs=return_docs,
                fault_hook=self._faults,
            )
            # Failover is fed from the serving path itself: every sharded
            # dispatch reports its per-shard times to the straggler
            # monitor.  Empty-plan batches (no device work, all-zero
            # times) are skipped — a dead batch says nothing about shard
            # health and must not reset a straggler's consecutive strikes.
            info = out[-1]
            times = info.get("shard_times")
            if (
                self._monitor is not None
                and times is not None
                and info.get("n_kernel_calls", 0.0)
                and len(times) == self._monitor.n_hosts
            ):
                _verdicts, remeshed = self.record_shard_times(times)
                info["remeshed"] = remeshed
            return out
        return device_counts(
            self.query_index,
            queries,
            dindex=self.device_index,
            return_docs=return_docs,
            fault_hook=self._faults,
        )

    # -- async serving loop -----------------------------------------------

    def serve_async(self, config=None, **config_kwargs):
        """An :class:`repro_torch.serve.loop.AsyncServingLoop` over this
        service's device path: arrivals accumulate under a
        deadline/max-batch policy and each sealed batch dispatches as one
        engine call (through the sharded fold after
        :meth:`enable_sharded`).

        Pass a :class:`repro_torch.serve.loop.ServeConfig` or its fields as
        keywords (``max_batch=``, ``deadline_s=``); ``await start()``
        inside a running event loop.
        """
        from repro_torch.serve.loop import AsyncServingLoop, ServeConfig

        return AsyncServingLoop(self, config or ServeConfig(**config_kwargs))

    # -- fault injection (chaos harness) -----------------------------------

    def install_faults(self, injector):
        """Thread a :class:`repro_torch.serve.faults.FaultInjector` into this
        service's device dispatch paths (``None`` uninstalls).  Scheduled
        faults then fire inside ``device_counts`` /
        ``sharded_device_counts`` — the real dispatch path.  Returns the
        injector for chaining."""
        self._faults = injector
        return injector

    # -- sharded serving + failover ---------------------------------------

    @property
    def sharded_index(self):
        """The active :class:`repro_torch.core.device_engine.ShardedDeviceIndex`
        (None until :meth:`enable_sharded`)."""
        return self._sharded

    @property
    def n_shards(self) -> int:
        return self._sharded.n_shards if self._sharded is not None else 0

    def enable_sharded(
        self,
        n_shards: Optional[int] = None,
        devices: Optional[Sequence] = None,
        deadline_factor: float = 1.5,
        strikes_to_evict: int = 3,
    ):
        """Partition the corpus over ``n_shards`` slots of ``devices``
        (every visible CUDA device when omitted; a device may repeat) and
        route :meth:`serve_counts_device` through the sharded engine.

        The slot pool is owned by an ``ElasticMesh`` and each shard is
        watched by a ``StragglerMonitor`` (one "host" per shard): feed
        per-step shard times to :meth:`record_shard_times` and an evicted
        shard's slot is dropped from the pool, the mesh rebuilt one shard
        smaller, and the corpus re-partitioned — the lost shard's
        top-level clusters are absorbed by the survivors, results stay
        bit-identical.
        """
        from repro_torch.core.device_engine import shard_devices, sharded_device_index
        from repro_torch.dist.fault_tolerance import ElasticMesh, StragglerMonitor

        self._elastic = ElasticMesh()
        self._elastic.remesh(shard_devices(n_shards, devices))
        self._sharded = sharded_device_index(self.query_index, mesh=self._elastic.mesh)
        self._monitor = StragglerMonitor(
            self._sharded.n_shards,
            deadline_factor=deadline_factor,
            strikes_to_evict=strikes_to_evict,
        )
        return self._sharded

    def record_shard_times(self, step_times):
        """Report one serving step's per-shard wall-clock times.

        Returns ``(verdicts, remeshed)``.  When the monitor's consecutive
        strikes evict a shard, its slot is excluded from the elastic pool,
        the mesh rebuilt from the survivors, the corpus re-partitioned
        over the smaller mesh (top clusters of the lost shard re-routed
        to its neighbors) and a fresh monitor started for the new shard
        count.
        """
        if self._monitor is None:
            raise RuntimeError("sharded serving not enabled")
        from repro_torch.core.device_engine import sharded_device_index
        from repro_torch.dist.fault_tolerance import StragglerMonitor

        verdicts = self._monitor.record(step_times)
        evictees = [v.host for v in verdicts if v.evict]
        if not evictees:
            return verdicts, False
        for h in evictees:
            self._elastic.exclude_device(self._sharded.mesh[h].id)
        mesh = self._elastic.remesh()
        self._sharded = sharded_device_index(self.query_index, mesh=mesh)
        self._monitor = StragglerMonitor(
            self._sharded.n_shards,
            deadline_factor=self._monitor.deadline_factor,
            strikes_to_evict=self._monitor.strikes_to_evict,
        )
        return verdicts, True

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

    def device_counts(
        self, packed: PackedClusters, devices: Optional[Sequence] = None
    ) -> torch.Tensor:
        """Intersect all rows on this service's device; per-query counts
        as an int32 tensor there.

        Pairs-only batches run one ``intersect_count`` reduction.  Mixed
        or higher arities keep each row's running intersection in the
        rank-0 block: every rank but the last filters it in place with the
        masked members kernel (rows with arity > r); the last rank only
        needs the survivors' number, so rows that reach it count their
        hits with the members count kernel and the others count their
        surviving cells.

        With ``devices`` (a device may repeat) the rows are padded to a
        multiple of their number and split into contiguous blocks, block s
        intersected on ``devices[s]``; the per-query counts are summed on
        the first device.  Padding rows carry query id ``n_queries``: they
        add into one extra count slot that is sliced off.
        """
        from repro_torch.dist.fault_tolerance import as_slots

        nq = packed.n_queries
        if devices is None:
            devs = [self.device]
        else:
            devs = [slot.device for slot in as_slots(list(devices))]
            if not devs:
                raise ValueError("device_counts: devices must name at least one device")
        if packed.short.shape[0] == 0:
            return torch.zeros(nq, dtype=torch.int32, device=devs[0])
        pairs_only = bool((packed.row_arity == 2).all()) and len(packed.segments) == 2
        out = torch.zeros(nq + 1, dtype=torch.int32, device=devs[0])
        for (segs, rq, ra), dev in zip(_row_blocks(packed, devs), devs, strict=True):
            c, rq_d = _block_counts(segs, rq, ra, pairs_only, dev)
            part = torch.zeros(nq + 1, dtype=torch.int32, device=dev).index_add_(0, rq_d, c)
            out += part.to(devs[0])
        return out[:nq]


def _row_blocks(packed: PackedClusters, devices: Sequence) -> List[Tuple[tuple, np.ndarray, np.ndarray]]:
    """``packed``'s rows padded to a multiple of ``len(devices)``
    (``shard_rows``) and split into one contiguous ``(segments,
    row_query, row_arity)`` block per device.  Padding rows are all PAD,
    of arity 0, and carry query id ``n_queries`` — beyond every real
    query."""
    from repro_torch.dist.sharding import shard_rows

    n_blocks = len(devices)
    segs, rq, ra = packed.segments, packed.row_query, packed.row_arity
    pad = shard_rows(segs[0].shape[0], devices)
    if pad:
        segs = tuple(np.pad(s, ((0, pad), (0, 0)), constant_values=PAD) for s in segs)
        rq = np.pad(rq, (0, pad), constant_values=packed.n_queries)
        ra = np.pad(ra, (0, pad), constant_values=0)
    per = segs[0].shape[0] // n_blocks
    return [
        (tuple(s[b * per : (b + 1) * per] for s in segs), rq[b * per : (b + 1) * per],
         ra[b * per : (b + 1) * per])
        for b in range(n_blocks)
    ]


def _block_counts(segs, rq, ra, pairs_only: bool, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row result counts of one row block on ``dev``, and its query
    ids there."""
    from repro_torch.kernels.intersect.ops import intersect_count, intersect_members

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    segs = tuple(put(b) for b in segs)
    ra = put(ra)
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
    return c, put(rq).long()
