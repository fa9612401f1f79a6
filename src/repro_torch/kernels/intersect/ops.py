"""Public wrappers of the search kernels.

A tensor that lies on the CPU takes the plain PyTorch version of
:mod:`repro_torch.kernels.intersect.ref`; a CUDA tensor launches the
hand-written kernel of :mod:`repro_torch.kernels.intersect.kernel` or
raises.  Nothing falls back from the card to the plain version.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.intersect import kernel as _k
from repro_torch.kernels.intersect.ref import (
    PAD,
    intersect_count_ref,
    intersect_members_ref,
    segment_fold_ref,
)

__all__ = ["intersect_count", "intersect_members", "segment_fold"]


def _as_rows(x) -> torch.Tensor:
    """int32 tensor on the caller's device (numpy input lands on the CPU)."""
    return torch.as_tensor(x, dtype=torch.int32).contiguous()


def intersect_count(short, long) -> torch.Tensor:
    """Per-row |short ∩ long| (B,) int32 for PAD-padded sorted int32 rows."""
    short, long = _as_rows(short), _as_rows(long)
    if short.is_cuda:
        return _k.intersect_count_cuda(short, long)
    return intersect_count_ref(short, long)


def intersect_members(short, long, reduce: str = "docs") -> torch.Tensor:
    """Members of ``short_row ∩ long_row`` for PAD-padded int32 rows — the
    pairwise select step of a k-way intersection fold.

    ``reduce``:
      * ``"docs"``  — (B, Ls) PAD-compacted member docs (survivors
        left-aligned, sorted; PAD fills the rest);
      * ``"mask"``  — (B, Ls) docs *in place*: matches keep their value,
        misses become PAD (what a masked chain stage consumes);
      * ``"count"`` — (B,) int32 |short ∩ long| through the members
        probe's count reduction.

    Only ``long`` rows must be sorted (PAD last); ``short`` rows may carry
    PAD holes anywhere.
    """
    if reduce not in ("docs", "mask", "count"):
        raise ValueError(f"unknown reduce mode {reduce!r}")
    short, long = _as_rows(short), _as_rows(long)
    if short.is_cuda:
        if reduce == "count":
            return _k.intersect_members_count_cuda(short, long)
        masked = _k.intersect_members_cuda(short, long)
    else:
        hit = intersect_members_ref(short, long)
        if reduce == "count":
            return hit.sum(dim=1).to(torch.int32)
        masked = torch.where(hit, short, int(PAD))
    return torch.sort(masked, dim=1).values if reduce == "docs" else masked


def segment_fold(
    post_docs: torch.Tensor,
    cells: torch.Tensor,
    stage_seg: torch.Tensor,
    group_width: int,
    stage_iters: Sequence[int],
    n_queries_pad: int,
    return_members: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Every chain stage of a lowered plan against the resident postings:
    ``(counts, entering, members)`` — see
    :func:`repro_torch.kernels.intersect.ref.segment_fold_ref`."""
    fold = _k.segment_fold_cuda if post_docs.is_cuda else segment_fold_ref
    return fold(
        post_docs,
        cells,
        stage_seg,
        group_width,
        tuple(int(i) for i in stage_iters),
        n_queries_pad,
        return_members,
    )
