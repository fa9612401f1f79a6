"""Plain PyTorch versions of the search kernels — the oracle the CUDA
kernels of :mod:`repro_torch.kernels.intersect.kernel` are held against,
and the path a wrapper in :mod:`repro_torch.kernels.intersect.ops` takes
for tensors that lie on the CPU.

Contract of the intersect trio: ``short`` (B, Ls) and ``long`` (B, Ll)
are int32 rows of doc ids padded with PAD = int32 max; ``long`` rows are
sorted (PAD last), ``short`` rows may hold PAD holes anywhere.  PAD never
matches.

Contract of the fold: the flat cell layout of
:class:`repro_torch.core.device_engine.LoweredPlan` probing the resident
``post_docs`` in place, stage by stage, with a fixed-depth leftmost
binary search per stage.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# numpy scalar, the sentinel every host and device array agrees on
PAD = np.int32(2**31 - 1)

__all__ = [
    "PAD",
    "intersect_members_ref",
    "intersect_members_docs_ref",
    "intersect_count_ref",
    "segment_fold_ref",
]


def intersect_members_ref(short: torch.Tensor, long: torch.Tensor) -> torch.Tensor:
    """Per-element membership (B, Ls) bool of ``short`` rows in the sorted
    ``long`` rows: a batched leftmost ``searchsorted`` plus a gather."""
    if long.shape[1] == 0:
        return torch.zeros(short.shape, dtype=torch.bool, device=short.device)
    pos = torch.searchsorted(long.contiguous(), short.contiguous())
    pos = pos.clamp_(max=long.shape[1] - 1)
    return (torch.gather(long, 1, pos) == short) & (short != int(PAD))


def intersect_members_docs_ref(short: torch.Tensor, long: torch.Tensor) -> torch.Tensor:
    """PAD-compacted member docs per row (B, Ls): survivors left-aligned
    and sorted, PAD filling the rest."""
    hit = intersect_members_ref(short, long)
    return torch.sort(torch.where(hit, short, int(PAD)), dim=1).values


def intersect_count_ref(short: torch.Tensor, long: torch.Tensor) -> torch.Tensor:
    """Per-row |short ∩ long| as int32 (B,)."""
    return intersect_members_ref(short, long).sum(dim=1).to(torch.int32)


def _search_segments(post_docs, cur, lo, hi, iters: int):
    """Leftmost position of each ``cur`` element inside its own posting
    segment ``post_docs[lo : hi]``: ``iters`` fixed halving steps with
    per-element bounds, the same integer steps as the reference engine."""
    n = post_docs.shape[0]
    end = hi
    for _ in range(iters):
        mid = (lo + hi) >> 1
        v = post_docs[mid.clamp(max=n - 1)]
        below = v < cur
        lo = torch.where(below, mid + 1, lo)
        hi = torch.where(below, hi, mid)
    return (lo < end) & (post_docs[lo.clamp(max=n - 1)] == cur)


def segment_fold_ref(
    post_docs: torch.Tensor,
    cells: torch.Tensor,
    stage_seg: torch.Tensor,
    group_width: int,
    stage_iters: Sequence[int],
    n_queries_pad: int,
    return_members: bool,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The whole multi-stage fold of a lowered plan.

    Returns per-query counts (int32, ``n_queries_pad`` wide), the live
    active cells entering each stage (int32, one per stage) and — when
    ``return_members`` — the final cell vector with PAD holes in place.
    Stage s filters only cells whose group is still active (``arity >
    s``); finished groups and pad cells pass through untouched.
    """
    n = post_docs.shape[0]
    pad = int(PAD)
    cell_post = cells[0].long()
    cell_group = cells[1].long()
    cell_query = cells[2].long()
    cell_arity = cells[3]
    if n:
        cur = post_docs[cell_post.clamp(0, n - 1)]
        cur = torch.where(cell_post != pad, cur, pad)
    else:
        cur = torch.full_like(cells[0], pad)
    entering = []
    for s, iters in enumerate(stage_iters, start=1):
        seg = stage_seg[:, (s - 1) * group_width : s * group_width].long()
        # pad cells carry group id G, which may equal group_width: clamp
        # the gather (their arity of 0 masks the result anyway)
        g = cell_group.clamp(max=group_width - 1)
        lo = seg[0][g]
        hi = lo + seg[1][g]
        act = cell_arity > s
        entering.append(((cur != pad) & act).sum())
        found = _search_segments(post_docs, cur, lo, hi, int(iters))
        cur = torch.where(act & ~found, pad, cur)
    live = (cur != pad) & (cell_query < n_queries_pad)
    counts = torch.zeros(n_queries_pad, dtype=torch.int32, device=cells.device)
    counts.index_add_(
        0, cell_query[live], torch.ones_like(cell_query[live], dtype=torch.int32)
    )
    entering_t = (
        torch.stack(entering).to(torch.int32)
        if entering
        else torch.zeros(0, dtype=torch.int32, device=cells.device)
    )
    return counts, entering_t, (cur if return_members else None)
