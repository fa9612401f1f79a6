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
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.runtime import maybe_validate
from repro_torch.core.batched_query import _ragged_gather, _ragged_indices
from repro_torch.core.hier_index import HierIndex, as_hier
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
    "device_counts",
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
    results back included).  ``jit_compiles`` is always ``0.0``: the fold
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
    members = members_d.cpu().numpy() if return_docs else None
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
    perm_start = np.concatenate([[0], np.cumsum(lowered.cell_counts)])[:-1]
    inv_order = np.empty(len(lowered.order), np.int64)
    inv_order[lowered.order] = np.arange(len(lowered.order))
    orig_cells = _ragged_gather(
        members, perm_start[inv_order], lowered.cell_counts[inv_order]
    )
    docs = orig_cells[orig_cells != PAD].astype(np.int32)
    return counts, docs, info
