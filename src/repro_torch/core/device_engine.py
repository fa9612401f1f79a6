"""Device-resident batched query engine — upload the index once, run the
whole cost-ordered k-way chain on the device, return only final
counts/docs.

Three pieces:

* :class:`DeviceIndex` — ``post_docs`` plus every :class:`HierLevel` CSR
  of a :class:`repro_torch.core.hier_index.HierIndex` as torch tensors on
  one device, uploaded once and cached on the host index object (so
  ``SecludPipeline.fit`` / ``SearchService`` construct it a single time
  and every batch reuses the resident tensors).

* ``lower_plan`` — lowers a host :class:`SegmentPlan` to the device *cell
  layout*: every group's rank-0 (cheapest) segment becomes a run of cells
  in one flat vector, groups ordered by arity (descending, stable).  The
  long sides are never materialized — each stage probes its posting
  segments *in place* inside the resident ``post_docs`` — so the only
  padding is the flat vector's tail quantization.  Cell count, per-stage
  group width and query count are rounded up at ~1/8 granularity and the
  per-stage binary-search depths to even values, exactly as the JAX
  engine lowers them, so both engines see the same plan arrays.

* the fold — ONE launch of the ``segment_fold`` CUDA kernel
  (:mod:`repro_torch.kernels.intersect`) executes every chain stage:
  stage s binary-searches the surviving cells of the still-active groups
  (``arity > s``) into their group's rank-s segment; misses become PAD
  in registers, so intermediate survivor lists never touch memory.  The
  kernel adds each survivor into its query's count.  Only the counts
  (and, on request, the member doc ids) return to the host.  On the CPU
  the same fold runs as its plain PyTorch version.

The sharded engine (``sharded_device_counts``) partitions the postings
by top-level cluster over shard slots and runs the fold once per shard;
``prewarm`` and its helpers are the serving loop's startup hooks.

Exactness: counts (and docs) are bit-identical to looping
``HierIndex.query`` / ``ClusterIndex.query`` at every depth and arity —
the plan already encodes the descent, and masked binary-search
intersection is exact set intersection.

The device is explicit: every entry point defaults to ``"cuda"`` and
raises when no GPU is present; ``device="cpu"`` runs the plain path.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.runtime import maybe_validate
from repro_torch.core.batched_query import _ragged_gather, _ragged_indices
from repro_torch.core.hier_index import HierIndex, as_hier, shard_tops
from repro_torch.core.queries import as_queries
from repro_torch.kernels.intersect.ops import segment_fold
from repro_torch.kernels.intersect.ref import PAD

__all__ = [
    "DeviceIndex",
    "DeviceLevel",
    "LoweredPlan",
    "resolve_device",
    "device_index",
    "lower_plan",
    "device_fold",
    "fold_cache_size",
    "plan_shape_key",
    "warm_fold",
    "prewarm",
    "device_counts",
    "shard_devices",
    "ShardedDeviceIndex",
    "sharded_device_index",
    "ShardedLoweredPlan",
    "lower_plan_sharded",
    "sharded_fold",
    "sharded_device_counts",
]

_CELL_ALIGN = 8  # flat cell vector tail alignment (the only padding left)


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on: ``"cuda"`` unless the
    caller names another.  A CUDA device without a GPU raises — the port
    never quietly moves to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _quantize(n: int) -> int:
    """Round ``n`` up at ~1/8 granularity (min 8) — the JAX engine's shape
    grid, kept so both engines lower a plan to identical arrays; the
    waste is bounded by 12.5% and counted in ``padding_overhead``."""
    g = max(_CELL_ALIGN, 1 << max(int(max(n, 1) - 1).bit_length() - 3, 0))
    return -(-max(n, 1) // g) * g


# ----------------------------------------------------------------------
# The upload-once index
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceLevel:
    """One :class:`repro_torch.core.hier_index.HierLevel` CSR, resident."""

    cl_ptr: torch.Tensor  # (n_terms + 1,) int64
    cl_ids: torch.Tensor  # (nnz_l,) int32
    seg_start: torch.Tensor  # (nnz_l,) int64
    seg_end: torch.Tensor  # (nnz_l,) int64
    ranges: torch.Tensor  # (k_l + 1,) int64


_LEVEL_FIELDS = ("cl_ptr", "cl_ids", "seg_start", "seg_end", "ranges")


@dataclasses.dataclass(frozen=True)
class DeviceIndex:
    """The whole hierarchical index resident on ``device``, uploaded once.

    ``post_docs`` is the array every fold probes; the level CSRs ride
    along so a device-side descent finds them already resident.
    ``host`` is the host-side :class:`HierIndex` the planner runs on.
    """

    post_docs: torch.Tensor  # (n_postings,) int32
    post_ptr: torch.Tensor  # (n_terms + 1,) int64
    levels: Tuple[DeviceLevel, ...]
    n_docs: int
    n_postings: int
    search_iters: int  # bit length of the longest posting list
    host: HierIndex
    device: torch.device

    @property
    def nbytes(self) -> int:
        """Resident bytes (post_docs + ptr + level CSRs) — what upload
        amortizes over every subsequent batch."""
        tensors = [self.post_docs, self.post_ptr]
        for lev in self.levels:
            tensors += [getattr(lev, f) for f in _LEVEL_FIELDS]
        return sum(t.numel() * t.element_size() for t in tensors)

    def validate(self) -> None:
        """Structural invariants the fold's exactness rests on
        (debug head: ``REPRO_DEBUG`` via :mod:`repro_torch.analysis.runtime`).

        * ``post_ptr`` is a monotone CSR spanning the posting array;
        * postings are strictly increasing inside every term segment —
          the binary search is only exact on sorted, duplicate-free
          segments;
        * every level CSR is monotone with in-bounds nested segments;
        * ``search_iters`` covers the longest posting list.
        """
        post_ptr = self.post_ptr.cpu().numpy()
        post_docs = self.post_docs.cpu().numpy()
        n_post = self.n_postings
        if len(post_docs) != n_post:
            raise ValueError("DeviceIndex: post_docs length != n_postings")
        if post_ptr[0] != 0 or post_ptr[-1] != n_post:
            raise ValueError("DeviceIndex: post_ptr must span [0, n_postings]")
        if (np.diff(post_ptr) < 0).any():
            raise ValueError("DeviceIndex: post_ptr must be nondecreasing")
        if n_post and ((post_docs < 0) | (post_docs >= self.n_docs)).any():
            raise ValueError("DeviceIndex: posting doc ids outside [0, n_docs)")
        if n_post > 1:
            seg_start = np.zeros(n_post + 1, bool)
            seg_start[post_ptr] = True
            ok = (np.diff(post_docs) > 0) | seg_start[1:n_post]
            if not ok.all():
                raise ValueError(
                    "DeviceIndex: postings must be strictly increasing "
                    "within each term segment (binary-search invariant)"
                )
        lens = np.diff(post_ptr)
        max_len = int(lens.max()) if len(lens) else 0
        if self.search_iters < max(max_len.bit_length(), 1):
            raise ValueError(
                "DeviceIndex: search_iters below the longest posting "
                "list's bit length — the fold would miss matches"
            )
        for i, lev in enumerate(self.levels):
            cl_ptr, cl_ids, seg_s, seg_e, ranges = (
                getattr(lev, f).cpu().numpy() for f in _LEVEL_FIELDS
            )
            nnz = len(cl_ids)
            if cl_ptr[0] != 0 or cl_ptr[-1] != nnz or (np.diff(cl_ptr) < 0).any():
                raise ValueError(f"DeviceIndex: level {i} cl_ptr not a CSR")
            if len(seg_s) != nnz or len(seg_e) != nnz:
                raise ValueError(f"DeviceIndex: level {i} segment arity mismatch")
            bound = (
                self.levels[i + 1].cl_ids.numel()
                if i + 1 < len(self.levels)
                else n_post
            )
            if nnz and ((seg_s > seg_e) | (seg_s < 0) | (seg_e > bound)).any():
                raise ValueError(
                    f"DeviceIndex: level {i} segments not nested in bounds"
                )
            if (np.diff(ranges) < 0).any():
                raise ValueError(f"DeviceIndex: level {i} ranges not monotone")
            k = len(ranges) - 1
            if nnz and ((cl_ids < 0) | (cl_ids >= k)).any():
                raise ValueError(f"DeviceIndex: level {i} node ids outside [0, k)")


def device_index(cidx, device=None) -> DeviceIndex:
    """The cached :class:`DeviceIndex` of ``cidx`` (a ``HierIndex`` of any
    depth or the two-level ``ClusterIndex`` facade) on ``device`` (default
    ``"cuda"``), uploading on first use only.  The cache lives on the
    host ``HierIndex`` object, one copy per device, so every caller
    sharing an index — pipeline, service — shares one device copy."""
    dev = resolve_device(device)
    hidx = as_hier(cidx)
    cache = hidx.__dict__.setdefault("_device_indexes", {})
    cached = cache.get(str(dev))
    if cached is not None:
        return cached
    index = hidx.index

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    lens = np.diff(index.post_ptr)
    max_len = int(lens.max()) if len(lens) else 0
    di = DeviceIndex(
        post_docs=put(index.post_docs, np.int32),
        post_ptr=put(index.post_ptr, np.int64),
        levels=tuple(
            DeviceLevel(
                cl_ptr=put(lev.cl_ptr, np.int64),
                cl_ids=put(lev.cl_ids, np.int32),
                seg_start=put(lev.seg_start, np.int64),
                seg_end=put(lev.seg_end, np.int64),
                ranges=put(lev.ranges, np.int64),
            )
            for lev in hidx.levels
        ),
        n_docs=index.n_docs,
        n_postings=len(index.post_docs),
        search_iters=max(max_len.bit_length(), 1),
        host=hidx,
        device=dev,
    )
    maybe_validate(di)  # REPRO_DEBUG: structural check before caching
    cache[str(dev)] = di
    return di


# ----------------------------------------------------------------------
# Plan lowering: SegmentPlan -> flat device cell layout
# ----------------------------------------------------------------------


@dataclasses.dataclass
class LoweredPlan:
    """A :class:`SegmentPlan` in the device cell layout.

    Groups are permuted arity-descending (stable), each contributing one
    cell per element of its rank-0 segment; chain stage s (1-based)
    filters the cells whose ``cell_arity > s`` (the first
    ``group_prefix[s - 1]`` groups / ``cell_prefix[s - 1]`` cells — kept
    for attribution; the fold itself masks on the arity row).
    ``stage_seg`` holds, per stage, each group's rank-s posting segment
    ``(start, len)`` (absolute into ``post_docs``; zeros for groups
    without one).  Tail cells (quantization) carry ``cell_post = PAD``,
    ``arity = 0`` and ``cell_query >= n_queries`` so the fold masks them
    and the count drops them.
    """

    cells: np.ndarray  # (4, N) int32 rows: post index (PAD = pad), group
    #                    id, query id (>= n_queries = pad), arity (0 =
    #                    pad) — one upload for the whole batch
    stage_seg: np.ndarray  # (2, n_stages * group_width) int32 — per
    #                        stage, every group's (start, len), zeros
    #                        where the group has no rank-s segment
    group_width: int  # quantized per-stage width of stage_seg
    cell_prefix: Tuple[int, ...]  # true active cells per stage (host info)
    group_prefix: Tuple[int, ...]  # true active groups per stage
    stage_iters: Tuple[int, ...]  # per-stage binary-search depth
    order: np.ndarray  # (G,) the arity-descending group permutation
    cell_counts: np.ndarray  # (G,) cells per permuted group (= rank-0 len)
    n_queries: int
    n_queries_pad: int  # quantized count width
    n_cells_true: int

    @property
    def n_cells(self) -> int:
        return self.cells.shape[1]

    @property
    def n_stages(self) -> int:
        return len(self.stage_iters)

    def stage_len_sum(self, s: int) -> int:
        w = self.group_width
        return int(self.stage_seg[1, s * w : (s + 1) * w].sum())


def lower_plan(plan) -> LoweredPlan:
    """Lower a host :class:`repro_torch.core.batched_query.SegmentPlan` to
    the flat cell layout (pure numpy; the small per-batch arrays this
    builds are the only per-batch upload)."""
    n_queries = plan.n_queries
    g_arity = plan.arity.astype(np.int64)
    order = np.argsort(-g_arity, kind="stable")
    r0 = plan.seg_ptr[:-1][order]
    cell_counts = plan.seg_len[r0].astype(np.int64)
    starts0 = plan.seg_start[r0]
    n_true = int(cell_counts.sum())
    n_cells = _quantize(n_true)

    cells = np.empty((4, n_cells), np.int32)
    cells[0] = PAD
    cells[1] = len(order)
    cells[2] = n_queries
    cells[3] = 0
    if n_true:
        rows, within = _ragged_indices(cell_counts)
        cells[0, :n_true] = starts0[rows] + within
        cells[1, :n_true] = rows
        cells[2, :n_true] = plan.pair_query[order][rows]
        cells[3, :n_true] = g_arity[order][rows]

    cell_cum = np.concatenate([[0], np.cumsum(cell_counts)])
    sorted_arity = g_arity[order]
    group_width = _quantize(len(order))
    cell_prefix: List[int] = []
    group_prefix: List[int] = []
    stage_iters: List[int] = []
    seg_parts: List[np.ndarray] = []
    for s in range(1, int(plan.max_arity)):
        # Groups still active at stage s are those with arity > s — a
        # prefix of the arity-descending order; the rest keep (0, 0)
        # segments and are mask-protected by the arity row.
        n_g = int(np.searchsorted(-sorted_arity, -s, side="left"))
        if n_g == 0:
            break
        si = r0[:n_g] + s
        lens = plan.seg_len[si]
        seg = np.zeros((2, group_width), np.int32)
        seg[0, :n_g] = plan.seg_start[si]
        seg[1, :n_g] = lens
        seg_parts.append(seg)
        group_prefix.append(n_g)
        cell_prefix.append(int(cell_cum[n_g]))
        # The probed segments are cluster-local slices, usually far
        # shorter than the longest posting list: size the binary search
        # to THIS stage's longest segment (rounded up to even depth).
        it = max(int(lens.max()).bit_length(), 1)
        stage_iters.append(it + (it & 1))
    stage_seg = (
        np.concatenate(seg_parts, axis=1)
        if seg_parts
        else np.zeros((2, 0), np.int32)
    )
    return LoweredPlan(
        cells=cells,
        stage_seg=stage_seg,
        group_width=group_width,
        cell_prefix=tuple(cell_prefix),
        group_prefix=tuple(group_prefix),
        stage_iters=tuple(stage_iters),
        order=order,
        cell_counts=cell_counts,
        n_queries=n_queries,
        n_queries_pad=_quantize(n_queries),
        n_cells_true=n_true,
    )


# ----------------------------------------------------------------------
# The fold: every chain stage in one kernel launch
# ----------------------------------------------------------------------


def device_fold(
    dindex: DeviceIndex,
    lowered: LoweredPlan,
    return_members: bool = False,
):
    """Run the fold of a lowered plan against a resident index.  Returns
    ``(counts, entering, members)`` — tensors on the index's device;
    ``counts`` has the quantized ``n_queries_pad`` width and ``members``
    is None unless requested."""
    dev = dindex.device
    return segment_fold(
        dindex.post_docs,
        torch.from_numpy(lowered.cells).to(dev),
        torch.from_numpy(lowered.stage_seg).to(dev),
        group_width=lowered.group_width,
        stage_iters=lowered.stage_iters,
        n_queries_pad=lowered.n_queries_pad,
        return_members=return_members,
    )


# The kernel library behind the fold (``analysis.sanitize.jit_cache_size``).
device_fold.kernel_sources = ("fold",)


# ----------------------------------------------------------------------
# Shape-grid prewarm: the serving loop's startup hooks
# ----------------------------------------------------------------------
#
# The JAX engine compiles one executable per quantized shape key
# (n_cells, group_width, stage_iters, n_queries_pad), so its serving loop
# enumerates the keys a batch plan will produce and compiles each at
# startup.  The fold kernel here takes every shape as a runtime argument
# and its library is built once, so nothing compiles per key: the probe
# is the constant 0 and ``prewarm`` only enumerates the keys.
# ``warm_fold`` launches the fold once on a key's dead content, which
# checks that the kernel masks dead cells.


def fold_cache_size() -> int:
    """Compiled fold entries per shape — the serving loop's compile
    counter.  Always 0: the fold kernel compiles nothing per shape."""
    return 0


def plan_shape_key(lowered: LoweredPlan) -> Tuple[int, int, Tuple[int, ...], int]:
    """The quantized shape tuple ``(n_cells, group_width, stage_iters,
    n_queries_pad)`` of a lowered plan — the JAX engine's cache key."""
    return (
        lowered.n_cells,
        lowered.group_width,
        lowered.stage_iters,
        lowered.n_queries_pad,
    )


def warm_fold(
    dindex: DeviceIndex,
    key: Tuple[int, int, Tuple[int, ...], int],
    return_members: bool = False,
) -> None:
    """Launch the fold once for one shape key without a real plan.

    Builds dead content of exactly the key's shapes — all-PAD cells with
    arity 0 and out-of-range query ids, zero-length segments — and
    raises unless the fold leaves every count and stage total at 0 (the
    fold must mask dead cells everywhere)."""
    n_cells, group_width, stage_iters, n_queries_pad = key
    cells = np.empty((4, n_cells), np.int32)
    cells[0] = PAD
    cells[1] = 0
    cells[2] = n_queries_pad
    cells[3] = 0
    stage_seg = np.zeros((2, len(stage_iters) * group_width), np.int32)
    dev = dindex.device
    counts, entering, _members = segment_fold(
        dindex.post_docs,
        torch.from_numpy(cells).to(dev),
        torch.from_numpy(stage_seg).to(dev),
        group_width=group_width,
        stage_iters=tuple(stage_iters),
        n_queries_pad=n_queries_pad,
        return_members=return_members,
    )
    if bool(counts.any()) or bool(entering.any()):
        raise RuntimeError(f"warm_fold: dead cells counted at shape key {key}")


def prewarm(
    cidx,
    queries,
    batch_sizes: Optional[Sequence[int]] = None,
    batches: Optional[Sequence[Tuple[int, int]]] = None,
) -> Dict[str, object]:
    """Plan and lower a workload's windows and list their shape keys.

    ``queries`` is a representative sample; either ``batches`` gives
    explicit ``(start, end)`` windows into it — e.g. the windows
    :func:`repro_torch.serve.loop.plan_batches` will dispatch — or
    ``batch_sizes`` names prefix sizes.  Each window is planned and
    lowered on the host to find its shape key, in the order the JAX
    engine compiles them; nothing is launched, since nothing compiles
    per key here.

    Returns ``{"n_batches", "n_keys", "n_compiles", "keys"}`` —
    ``n_compiles`` is always 0 (:func:`fold_cache_size`).
    """
    from repro_torch.core.batched_query import plan_segment_pairs

    cq = as_queries(queries)
    hidx = as_hier(cidx)
    if batches is None:
        if batch_sizes is None:
            raise ValueError("prewarm needs batch_sizes or explicit batches")
        batches = [(0, min(int(b), cq.n_queries)) for b in batch_sizes]
    before = fold_cache_size()
    keys: List[Tuple[int, int, Tuple[int, ...], int]] = []
    seen = set()
    n_batches = 0
    for i, j in batches:
        if j <= i:
            continue
        n_batches += 1
        plan = plan_segment_pairs(hidx, cq[int(i) : int(j)], track_work=False)
        if plan.n_pairs == 0:
            continue  # empty plans never reach the fold
        key = plan_shape_key(lower_plan(plan))
        if key not in seen:
            seen.add(key)
            keys.append(key)
    return {
        "n_batches": n_batches,
        "n_keys": len(keys),
        "n_compiles": fold_cache_size() - before,
        "keys": keys,
    }


# ----------------------------------------------------------------------
# Public entry: counts (and docs) for a whole batch
# ----------------------------------------------------------------------


def _stage_info(lowered: LoweredPlan, entering: np.ndarray) -> List[Dict[str, float]]:
    """Per-stage attribution: how many cells the stage carried (padded),
    how many were live survivors (true), how many posting cells it probed
    in place, and the resulting padding overhead."""
    stages = []
    for s in range(len(lowered.cell_prefix)):
        carried = float(lowered.cell_prefix[s])
        live = float(entering[s]) if s < len(entering) else carried
        long_cells = float(lowered.stage_len_sum(s))
        stages.append(
            {
                "stage": float(s + 1),
                "cur_cells": carried,
                "cur_live": live,
                "long_cells": long_cells,
                "padding_overhead": (carried + long_cells)
                / max(live + long_cells, 1.0),
                "kernel_calls": 0.0,  # fused: no per-stage dispatch at all
            }
        )
    return stages


def _members_to_host(members) -> np.ndarray:
    """The fold's final cells on the host: one tensor, or the per-shard
    tensors of the sharded fold concatenated in shard order."""
    if isinstance(members, torch.Tensor):
        return members.cpu().numpy()
    return np.concatenate([m.cpu().numpy() for m in members])


def device_counts(
    cidx,
    queries,
    plan=None,
    dindex: Optional[DeviceIndex] = None,
    return_docs: bool = False,
    fault_hook=None,
    device=None,
):
    """Per-query result counts of a conjunctive batch, fully on device.

    ``cidx`` is a ``HierIndex`` of any depth or the ``ClusterIndex``
    facade; the resident :class:`DeviceIndex` on ``device`` (default
    ``"cuda"``) is looked up (or built on first use) unless passed
    explicitly.  Returns ``(counts, info)`` — or ``(counts, docs, info)``
    with ``return_docs=True``, where ``docs`` is the CSR value array
    bit-identical to ``batched_query``'s.

    ``info`` keys: ``n_pairs``, ``n_kernel_calls`` (fold launches for the
    whole batch — 1), ``padding_overhead`` (cells materialized / true
    cells; the long sides are probed in place and contribute zero
    padding), ``occupancy`` (live survivor cells / cells carried across
    all stages), and ``stages`` (per-stage attribution dicts).
    ``t_plan_s`` / ``t_lower_s`` / ``t_fold_s`` split the call into host
    planning, lowering, and the fold (uploads, launch and the copy of the
    counts back included; the member docs are copied after the clock
    stops, as in the JAX engine).  ``jit_compiles`` is always ``0.0``: the fold
    kernel takes every shape as a runtime argument, so nothing compiles
    per shape (the kernel library is built once, at first use).
    """
    from repro_torch.core.batched_query import plan_segment_pairs

    t0 = time.perf_counter()
    cq = as_queries(queries)
    if dindex is None:
        dindex = device_index(cidx, device)
    if plan is None:
        # The device path needs the segment layout, not the paper's work
        # metric — plan without the probe/scan accounting.
        plan = plan_segment_pairs(dindex.host, cq, track_work=False)
    t_plan = time.perf_counter() - t0
    if fault_hook is not None:
        # Injection point of a chaos harness: a scheduled fault raises
        # here, inside the real dispatch path, where a device error
        # would surface.
        fault_hook.on_dispatch(n_shards=1)
    if plan.n_pairs == 0:
        counts = np.zeros(plan.n_queries, np.int64)
        info = {
            "n_pairs": 0.0,
            "n_kernel_calls": 0.0,
            "padding_overhead": 1.0,
            "occupancy": 1.0,
            "stages": [],
            "t_plan_s": t_plan,
            "t_lower_s": 0.0,
            "t_fold_s": 0.0,
            "jit_compiles": 0.0,
        }
        if return_docs:
            return counts, np.empty(0, np.int32), info
        return counts, info

    t1 = time.perf_counter()
    lowered = lower_plan(plan)
    t_lower = time.perf_counter() - t1
    t2 = time.perf_counter()
    counts_d, entering_d, members_d = device_fold(
        dindex, lowered, return_members=return_docs
    )
    counts = counts_d[: lowered.n_queries].cpu().numpy().astype(np.int64)
    entering = entering_d.cpu().numpy()
    t_fold = time.perf_counter() - t2

    stages = _stage_info(lowered, entering)
    true_cells = float(lowered.n_cells_true)
    long_cells = float(sum(s["long_cells"] for s in stages))
    carried = float(lowered.n_cells) + sum(s["cur_cells"] for s in stages)
    live = true_cells + sum(s["cur_live"] for s in stages)
    info = {
        "n_pairs": float(plan.n_pairs),
        "n_kernel_calls": 1.0,
        "padding_overhead": (float(lowered.n_cells) + long_cells)
        / max(true_cells + long_cells, 1.0),
        "occupancy": live / max(carried, 1.0),
        "stages": stages,
        "t_plan_s": t_plan,
        "t_lower_s": t_lower,
        "t_fold_s": t_fold,
        "jit_compiles": 0.0,
    }
    if not return_docs:
        return counts, info

    # Un-permute the final cells to plan (query, cluster) order; dropping
    # PAD holes leaves exactly batched_query's doc array.
    members = _members_to_host(members_d)
    perm_start = np.concatenate([[0], np.cumsum(lowered.cell_counts)])[:-1]
    inv_order = np.empty(len(lowered.order), np.int64)
    inv_order[lowered.order] = np.arange(len(lowered.order))
    orig_cells = _ragged_gather(
        members, perm_start[inv_order], lowered.cell_counts[inv_order]
    )
    docs = orig_cells[orig_cells != PAD].astype(np.int32)
    return counts, docs, info


# ----------------------------------------------------------------------
# Sharded serving: per-shard postings, one fold launch per shard
# ----------------------------------------------------------------------
#
# The corpus is partitioned by level-0 ancestor into S contiguous doc-id
# ranges (``shard_tops`` balances posting mass), each shard holding the
# postings of its own docs as one row of a stacked (S, W) matrix; row s
# lives on slot s's device as its own tensor.  Because every segment
# group of a plan lives inside ONE leaf cluster — hence one top cluster,
# hence one shard — the global plan routes exactly: each group's cells
# land on the shard owning its docs, untouched shards receive only dead
# (masked) cells.  The fold then runs once per shard, on that shard's
# device, and the S count vectors are summed on the first slot's device
# (the JAX engine's shard_map + psum); member docs come back per shard
# and are re-concatenated on the host in original plan-group order,
# bit-identical to the single-device path.


def shard_devices(n_shards: Optional[int] = None, devices: Optional[Sequence] = None):
    """The mesh of the first ``n_shards`` of ``devices`` — every visible
    CUDA device when omitted (raises without a GPU) — as a tuple of
    :class:`repro_torch.dist.fault_tolerance.ShardSlot`, one shard each.
    An explicit list may repeat a device: on one GPU the shards are slots
    of ``cuda:0``, on the CPU of ``cpu``."""
    from repro_torch.dist.fault_tolerance import as_slots, visible_cuda_devices

    devs = list(devices) if devices is not None else visible_cuda_devices()
    if n_shards is None:
        n_shards = len(devs)
    if not 1 <= n_shards <= len(devs):
        raise ValueError(
            f"n_shards={n_shards} outside [1, {len(devs)}] available devices"
        )
    return tuple(as_slots(devs[:n_shards]))


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedDeviceIndex:
    """The corpus partitioned by level-0 ancestor over a mesh's slots.

    ``post_docs`` holds S rows of width W — row s holds shard s's
    postings (the global postings whose doc id falls in
    ``[doc_bounds[s], doc_bounds[s + 1])``, order preserved, PAD beyond
    ``shard_counts[s]``) — each a tensor on slot s's device.
    ``local_pos`` maps a global posting position to its position within
    its shard's row: a plan segment (contiguous globally, wholly inside
    one leaf cluster and therefore one shard) stays contiguous locally,
    so lowering only remaps segment starts.
    """

    mesh: Tuple[object, ...]  # ShardSlot s holds row s
    n_shards: int
    top_bounds: np.ndarray  # (S + 1,) level-0 node boundaries per shard
    doc_bounds: np.ndarray  # (S + 1,) doc-id boundaries per shard
    post_docs: Tuple[torch.Tensor, ...]  # S rows of (W,) int32, row s on slot s
    post_width: int  # W — quantized max shard posting count
    local_pos: np.ndarray  # (n_postings,) int64 — global -> within-shard
    shard_counts: np.ndarray  # (S,) int64 — true postings per shard
    search_iters: int
    host: HierIndex

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(slot.device for slot in self.mesh)

    @property
    def nbytes(self) -> int:
        """Total resident bytes across the shards (PAD tail included)."""
        return sum(t.numel() * t.element_size() for t in self.post_docs)

    def validate(self) -> None:
        """Shard partition exactness (debug head: ``REPRO_DEBUG``).

        The sharded fold is bit-identical to the single-device path only
        if the (S, W) stacked postings are an exact partition: every
        global posting sits at ``(shard_of(doc), local_pos)`` in its
        owner's row, rows carry nothing else but PAD tail, and the
        doc-range routing that ``lower_plan_sharded`` uses reproduces
        the row assignment.
        """
        S = self.n_shards
        if len(self.top_bounds) != S + 1 or len(self.doc_bounds) != S + 1:
            raise ValueError("ShardedDeviceIndex: bounds must have S + 1 entries")
        if (np.diff(self.top_bounds) < 0).any() or (
            np.diff(self.doc_bounds) < 0
        ).any():
            raise ValueError("ShardedDeviceIndex: shard bounds not monotone")
        docs = np.asarray(self.host.index.post_docs, np.int64)
        n_post = len(docs)
        if len(self.local_pos) != n_post:
            raise ValueError("ShardedDeviceIndex: local_pos length mismatch")
        if int(self.shard_counts.sum()) != n_post:
            raise ValueError(
                "ShardedDeviceIndex: shard_counts do not partition the postings"
            )
        if len(self.post_docs) != S or any(
            t.shape != (self.post_width,) or t.device != d
            for t, d in zip(self.post_docs, self.devices, strict=True)
        ):
            raise ValueError("ShardedDeviceIndex: stacked postings shape mismatch")
        stacked = np.stack([t.cpu().numpy() for t in self.post_docs])
        shard_of = np.clip(
            np.searchsorted(self.doc_bounds, docs, side="right") - 1, 0, S - 1
        )
        if not np.array_equal(
            np.bincount(shard_of, minlength=S).astype(np.int64),
            self.shard_counts,
        ):
            raise ValueError(
                "ShardedDeviceIndex: shard_counts disagree with doc-range routing"
            )
        live = np.zeros((S, self.post_width), bool)
        if n_post:
            if ((self.local_pos < 0) | (self.local_pos >= self.post_width)).any():
                raise ValueError("ShardedDeviceIndex: local_pos outside its row")
            if not (stacked[shard_of, self.local_pos] == docs).all():
                raise ValueError(
                    "ShardedDeviceIndex: a posting is not at its routed "
                    "(shard, local) slot — partition is not exact"
                )
            live[shard_of, self.local_pos] = True
            if int(live.sum()) != n_post:
                raise ValueError(
                    "ShardedDeviceIndex: local_pos collides within a shard"
                )
        if (stacked[~live] != PAD).any():
            raise ValueError(
                "ShardedDeviceIndex: non-PAD value outside the live partition"
            )


def _put_rows(stacked: np.ndarray, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Row s of ``stacked`` as a contiguous tensor on ``devices[s]``."""
    return [
        torch.from_numpy(np.ascontiguousarray(stacked[s])).to(d)
        for s, d in enumerate(devices)
    ]


def sharded_device_index(
    cidx, mesh=None, n_shards: Optional[int] = None, devices: Optional[Sequence] = None
) -> ShardedDeviceIndex:
    """The cached :class:`ShardedDeviceIndex` of ``cidx`` over ``mesh``
    (built by :func:`shard_devices` from ``n_shards`` and ``devices`` when
    omitted).  The host ``HierIndex`` keeps the index of the last tuple of
    slots asked for, so a remesh (shard failover) rebuilds once and the
    old mesh's rows are released with it."""
    from repro_torch.dist import sharding as sh

    hidx = as_hier(cidx)
    if mesh is None:
        mesh = shard_devices(n_shards, devices)
    mesh = tuple(mesh)
    cached = hidx.__dict__.get("_sharded_index")
    if cached is not None and cached.mesh == mesh:
        return cached
    hidx.__dict__.pop("_sharded_index", None)

    S = sh.device_count(mesh)
    top_bounds = shard_tops(hidx, S)
    doc_bounds = hidx.top_ranges[top_bounds].astype(np.int64)
    docs = np.asarray(hidx.index.post_docs, np.int64)
    n_post = len(docs)
    shard_of = np.clip(
        np.searchsorted(doc_bounds, docs, side="right") - 1, 0, S - 1
    )
    shard_counts = np.bincount(shard_of, minlength=S).astype(np.int64)
    shard_off = np.concatenate([[0], np.cumsum(shard_counts)])
    order = np.argsort(shard_of, kind="stable")
    local = np.arange(n_post, dtype=np.int64) - np.repeat(
        shard_off[:-1], shard_counts
    )
    local_pos = np.empty(n_post, np.int64)
    local_pos[order] = local
    width = _quantize(int(shard_counts.max()) if n_post else 1)
    stacked = np.full((S, width), PAD, np.int32)
    stacked[shard_of, local_pos] = docs.astype(np.int32)
    max_len = int(shard_counts.max()) if n_post else 0
    sidx = ShardedDeviceIndex(
        mesh=mesh,
        n_shards=S,
        top_bounds=top_bounds,
        doc_bounds=doc_bounds,
        post_docs=tuple(_put_rows(stacked, [slot.device for slot in mesh])),
        post_width=width,
        local_pos=local_pos,
        shard_counts=shard_counts,
        search_iters=max(max_len.bit_length(), 1),
        host=hidx,
    )
    maybe_validate(sidx)  # REPRO_DEBUG: partition exactness before caching
    hidx.__dict__["_sharded_index"] = sidx
    return sidx


def _take_groups(plan, g_idx: np.ndarray, sidx: ShardedDeviceIndex):
    """The sub-:class:`SegmentPlan` of groups ``g_idx``, segment starts
    remapped into the owning shard's local postings row.  Query ids stay
    global — per-shard counts add into the full query range and the
    cross-shard sum adds disjoint contributions."""
    from repro_torch.core.batched_query import SegmentPlan

    arity = plan.arity[g_idx].astype(np.int64)
    rows, within = _ragged_indices(arity)
    si = plan.seg_ptr[:-1][g_idx][rows] + within
    seg_len = plan.seg_len[si]
    gstart = plan.seg_start[si]
    n_post = len(sidx.local_pos)
    # Empty segments may sit at the postings tail (start == n_postings):
    # clamp the lookup, their remapped start is never probed.
    seg_start = np.where(
        seg_len > 0,
        sidx.local_pos[np.minimum(gstart, max(n_post - 1, 0))],
        0,
    )
    return SegmentPlan(
        pair_query=plan.pair_query[g_idx],
        cluster=plan.cluster[g_idx],
        base=plan.base[g_idx],
        width=plan.width[g_idx],
        arity=arity,
        seg_ptr=np.concatenate([[0], np.cumsum(arity)]).astype(np.int64),
        seg_start=seg_start.astype(np.int64),
        seg_len=seg_len.astype(np.int64),
        cluster_work=np.zeros(plan.n_queries, np.int64),
        n_queries=plan.n_queries,
        max_arity=int(plan.max_arity),
    )


@dataclasses.dataclass
class ShardedLoweredPlan:
    """A :class:`SegmentPlan` lowered per shard and stacked: shard s's
    cells/segments sit in row s (dead cells where another shard owns the
    group), shapes unified across shards.  ``grp_shard`` / ``grp_off`` /
    ``grp_cnt`` locate every original plan group inside the stacked
    member matrix — the host-side gather that restores single-device doc
    order exactly."""

    cells: np.ndarray  # (S, 4, C) int32 — per-shard cell layout
    stage_seg: np.ndarray  # (S, 2, n_stages * group_width) int32
    group_width: int  # unified quantized per-stage width
    stage_iters: Tuple[int, ...]  # per-stage max binary-search depth
    n_queries: int
    n_queries_pad: int
    n_cells_true: np.ndarray  # (S,) true cells per shard (load balance)
    grp_shard: np.ndarray  # (G,) owning shard of each original group
    grp_off: np.ndarray  # (G,) cell offset inside the shard's row
    grp_cnt: np.ndarray  # (G,) cells of the group (= rank-0 len)
    shards_touched: int
    n_shards: int

    @property
    def n_cells(self) -> int:
        return self.cells.shape[2]

    @property
    def n_stages(self) -> int:
        return len(self.stage_iters)


def lower_plan_sharded(plan, sidx: ShardedDeviceIndex) -> ShardedLoweredPlan:
    """Route a global plan's groups to their owning shards and lower each
    shard's slice (pure numpy).  A group's top-level ancestor decides its
    shard — the level-0 descent IS the router; shards outside the batch's
    descent receive only dead cells, which the fold masks."""
    S = sidx.n_shards
    top = np.searchsorted(sidx.host.top_ranges, plan.base, side="right") - 1
    gshard = np.clip(
        np.searchsorted(sidx.top_bounds, top, side="right") - 1, 0, S - 1
    ).astype(np.int64)

    lowereds = {}
    for s in np.unique(gshard):
        g_idx = np.flatnonzero(gshard == s)
        lowereds[int(s)] = (g_idx, lower_plan(_take_groups(plan, g_idx, sidx)))

    # Unify shapes across shards (the JAX engine's one executable).
    width = max(low.group_width for _, low in lowereds.values())
    n_cells = max(low.n_cells for _, low in lowereds.values())
    n_stages = max(low.n_stages for _, low in lowereds.values())
    iters = [0] * n_stages
    for _, low in lowereds.values():
        for t, it in enumerate(low.stage_iters):
            iters[t] = max(iters[t], it)
    n_queries = plan.n_queries

    cells = np.empty((S, 4, n_cells), np.int32)
    cells[:, 0] = PAD
    cells[:, 1] = width
    cells[:, 2] = n_queries
    cells[:, 3] = 0
    stage_seg = np.zeros((S, 2, n_stages * width), np.int32)
    n_true = np.zeros(S, np.int64)
    n_groups = plan.n_pairs
    grp_off = np.zeros(n_groups, np.int64)
    grp_cnt = np.zeros(n_groups, np.int64)
    for s, (g_idx, low) in lowereds.items():
        cells[s, :, : low.n_cells] = low.cells
        gw = low.group_width
        for t in range(low.n_stages):
            stage_seg[s, :, t * width : t * width + gw] = low.stage_seg[
                :, t * gw : (t + 1) * gw
            ]
        n_true[s] = low.n_cells_true
        perm_start = np.concatenate([[0], np.cumsum(low.cell_counts)])[:-1]
        inv = np.empty(len(low.order), np.int64)
        inv[low.order] = np.arange(len(low.order))
        grp_off[g_idx] = perm_start[inv]
        grp_cnt[g_idx] = low.cell_counts[inv]
    return ShardedLoweredPlan(
        cells=cells,
        stage_seg=stage_seg,
        group_width=width,
        stage_iters=tuple(iters),
        n_queries=n_queries,
        n_queries_pad=_quantize(n_queries),
        n_cells_true=n_true,
        grp_shard=gshard,
        grp_off=grp_off,
        grp_cnt=grp_cnt,
        shards_touched=len(lowereds),
        n_shards=S,
    )


def sharded_fold(
    sidx: ShardedDeviceIndex,
    lowered: ShardedLoweredPlan,
    return_members: bool = False,
):
    """The fold of a sharded plan: one fold launch per shard, on its
    slot's device, over its own postings row; the S count vectors and
    stage totals are summed on the first slot's device.  Returns
    ``(counts, entering, members)`` — ``members`` is the list of the S
    per-shard cell vectors, or None unless requested."""
    devices = sidx.devices
    cells = _put_rows(lowered.cells, devices)
    stage_seg = _put_rows(lowered.stage_seg, devices)
    outs = [
        segment_fold(
            sidx.post_docs[s],
            cells[s],
            stage_seg[s],
            group_width=lowered.group_width,
            stage_iters=lowered.stage_iters,
            n_queries_pad=lowered.n_queries_pad,
            return_members=return_members,
        )
        for s in range(sidx.n_shards)
    ]
    first = devices[0]
    counts = outs[0][0]
    entering = outs[0][1]
    for c, e, _m in outs[1:]:
        counts = counts + c.to(first)
        entering = entering + e.to(first)
    members = [m for _c, _e, m in outs] if return_members else None
    return counts, entering, members


def sharded_device_counts(
    cidx,
    queries,
    plan=None,
    sidx: Optional[ShardedDeviceIndex] = None,
    return_docs: bool = False,
    fault_hook=None,
):
    """Per-query result counts over the sharded corpus — one fold launch
    per shard, counts summed on the first slot's device.

    ``cidx`` is any host index (or a :class:`ShardedDeviceIndex`, whose
    mesh is then reused; otherwise the index over every visible CUDA
    device).  Counts AND member docs are bit-identical to
    :func:`device_counts` and the host loop: the plan is global, each
    group's work runs on the one shard owning its docs, and docs are
    re-gathered in original plan-group order on the host.

    ``info`` adds the sharding attribution: ``n_shards``,
    ``shards_touched`` (level-0 routing), ``shard_cells`` (true cells per
    shard), ``shard_times`` (per-shard dispatch seconds — what
    ``SearchService.record_shard_times`` consumes for failover),
    ``agg_throughput`` (total true cells / max per-shard true cells — the
    deterministic load-balance speedup bound) and ``load_balance`` (=
    agg_throughput / n_shards).  ``n_kernel_calls`` counts the fold
    launches: one per shard.  ``t_fold_s`` runs from the uploads to the
    counts on the host; member docs are copied after it.  ``fault_hook``
    is the chaos harness's injection point
    (:mod:`repro_torch.serve.faults`): called inside the dispatch path,
    where it may raise scheduled faults and perturb ``shard_times``."""
    from repro_torch.core.batched_query import plan_segment_pairs

    t0 = time.perf_counter()
    cq = as_queries(queries)
    if sidx is None:
        sidx = (
            cidx
            if isinstance(cidx, ShardedDeviceIndex)
            else sharded_device_index(cidx)
        )
    if plan is None:
        plan = plan_segment_pairs(sidx.host, cq, track_work=False)
    t_plan = time.perf_counter() - t0
    if fault_hook is not None:
        # Chaos-harness injection point: scheduled faults raise here,
        # inside the real sharded dispatch path; the hook also watches
        # n_shards to retire device-loss events once failover
        # re-partitioned without the lost shard.
        fault_hook.on_dispatch(n_shards=sidx.n_shards)
    if plan.n_pairs == 0:
        counts = np.zeros(plan.n_queries, np.int64)
        info = {
            "n_pairs": 0.0,
            "n_kernel_calls": 0.0,
            "n_shards": float(sidx.n_shards),
            "shards_touched": 0.0,
            "shard_cells": [0.0] * sidx.n_shards,
            "shard_times": [0.0] * sidx.n_shards,
            "agg_throughput": 1.0,
            "load_balance": 1.0 / max(sidx.n_shards, 1),
            "padding_overhead": 1.0,
            "t_plan_s": t_plan,
            "t_lower_s": 0.0,
            "t_fold_s": 0.0,
            "jit_compiles": 0.0,
        }
        if return_docs:
            return counts, np.empty(0, np.int32), info
        return counts, info

    t1 = time.perf_counter()
    lowered = lower_plan_sharded(plan, sidx)
    t_lower = time.perf_counter() - t1
    t2 = time.perf_counter()
    counts_d, _entering, members_d = sharded_fold(sidx, lowered, return_docs)
    counts = counts_d[: lowered.n_queries].cpu().numpy().astype(np.int64)
    t_fold = time.perf_counter() - t2
    total_true = float(lowered.n_cells_true.sum())
    max_true = float(lowered.n_cells_true.max())
    # Per-shard dispatch times for the straggler monitor: the shards'
    # launches share one stream and the counts wait for all of them, so
    # the honest per-shard attribution is the fold time itself, equal
    # across shards; a straggler (or an injected one) shows up as that
    # shard's entry inflating.
    shard_times = np.full(lowered.n_shards, t_fold, np.float64)
    if fault_hook is not None:
        shard_times = fault_hook.perturb_shard_times(shard_times)
    info = {
        "n_pairs": float(plan.n_pairs),
        "n_kernel_calls": float(lowered.n_shards),
        "n_shards": float(lowered.n_shards),
        "shards_touched": float(lowered.shards_touched),
        "shard_cells": lowered.n_cells_true.astype(float).tolist(),
        "shard_times": [float(x) for x in shard_times],
        "agg_throughput": total_true / max(max_true, 1.0),
        "load_balance": total_true
        / max(lowered.n_shards * max_true, 1.0),
        "padding_overhead": float(lowered.n_shards * lowered.n_cells)
        / max(total_true, 1.0),
        "t_plan_s": t_plan,
        "t_lower_s": t_lower,
        "t_fold_s": t_fold,
        "jit_compiles": 0.0,
    }
    if not return_docs:
        return counts, info

    # Per-shard members -> original plan-group order: each group's cells
    # sit contiguously inside its owning shard's row; gathering rows in
    # group order and dropping PAD holes restores exactly the
    # single-device (and host-loop) doc array.
    members = _members_to_host(members_d)
    starts = lowered.grp_shard * lowered.n_cells + lowered.grp_off
    orig_cells = _ragged_gather(members, starts, lowered.grp_cnt)
    docs = orig_cells[orig_cells != PAD].astype(np.int32)
    return counts, docs, info
