"""Launchers of the search path's CUDA kernels: the fold
(``csrc/fold.cu``) and the intersect trio (``csrc/intersect.cu``).

The libraries are built, loaded and counted by
:mod:`repro_torch.kernels.build`.  Every launcher checks device, dtype,
contiguity and shape, allocates its outputs with
``torch.empty``/``torch.zeros``, launches on
``torch.cuda.current_stream()``, raises when the launch reports a CUDA
error, and adds one to its entry of
:data:`repro_torch.kernels.build.LAUNCHES`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.build import LAUNCHES, check, lib, stream_of

__all__ = [
    "segment_fold_cuda",
    "intersect_members_cuda",
    "intersect_members_count_cuda",
    "intersect_count_cuda",
]


def _check_int32_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    device = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name}: every input must be on one CUDA device")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: inputs must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return device


# Stages the fold kernel takes in one launch: their search depths travel
# by value in the kernel's arguments (FOLD_MAX_STAGES of csrc/fold.cu).
FOLD_MAX_STAGES = 64


def segment_fold_cuda(
    post_docs: torch.Tensor,
    cells: torch.Tensor,
    stage_seg: torch.Tensor,
    group_width: int,
    stage_iters: Sequence[int],
    n_queries_pad: int,
    return_members: bool,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The fold kernel (``csrc/fold.cu``): same contract as
    :func:`repro_torch.kernels.intersect.ref.segment_fold_ref`.

    The search depths go to the kernel by value, so a call copies nothing
    from the host and synchronises nothing: it can be captured in a CUDA
    graph.  ``counts`` and ``entering`` are two views of one zeroed
    buffer."""
    device = _check_int32_cuda("segment_fold", post_docs, cells, stage_seg)
    n_stages = len(stage_iters)
    if post_docs.dim() != 1 or cells.dim() != 2 or cells.shape[0] != 4:
        raise ValueError("segment_fold: post_docs (n,) and cells (4, N) expected")
    if stage_seg.dim() != 2 or stage_seg.shape[0] != 2:
        raise ValueError("segment_fold: stage_seg (2, n_stages * group_width) expected")
    if stage_seg.shape[1] != n_stages * group_width:
        raise ValueError("segment_fold: stage_seg width != n_stages * group_width")
    if n_stages > FOLD_MAX_STAGES:
        raise ValueError(f"segment_fold: at most {FOLD_MAX_STAGES} stages, got {n_stages}")
    n_cells = cells.shape[1]
    zeroed = torch.zeros(n_queries_pad + n_stages, dtype=torch.int32, device=device)
    counts, entering = zeroed[:n_queries_pad], zeroed[n_queries_pad:]
    members = (
        torch.empty(n_cells, dtype=torch.int32, device=device)
        if return_members
        else None
    )
    status = lib("fold").segment_fold_launch(
        post_docs.data_ptr(),
        post_docs.shape[0],
        cells.data_ptr(),
        n_cells,
        stage_seg.data_ptr(),
        stage_seg.shape[1],
        group_width,
        (ctypes.c_int * max(n_stages, 1))(*stage_iters),
        n_stages,
        n_queries_pad,
        counts.data_ptr(),
        entering.data_ptr(),
        members.data_ptr() if members is not None else None,
        stream_of(device),
    )
    check(status, "segment_fold")
    LAUNCHES["segment_fold"] += 1
    return counts, entering, members


def _rows_call(fn_name: str, counter: str, short, long, out):
    device = _check_int32_cuda(counter, short, long)
    if short.dim() != 2 or long.dim() != 2 or short.shape[0] != long.shape[0]:
        raise ValueError(f"{counter}: short (B, Ls) and long (B, Ll) expected")
    status = getattr(lib("intersect"), fn_name)(
        short.data_ptr(),
        long.data_ptr(),
        short.shape[0],
        short.shape[1],
        long.shape[1],
        out.data_ptr(),
        stream_of(device),
    )
    check(status, counter)
    LAUNCHES[counter] += 1
    return out


def intersect_members_cuda(short: torch.Tensor, long: torch.Tensor) -> torch.Tensor:
    """(B, Ls) ``short`` with misses replaced by PAD."""
    out = torch.empty(short.shape, dtype=torch.int32, device=short.device)
    return _rows_call("intersect_members_launch", "intersect_members_kernel", short, long, out)


def intersect_members_count_cuda(short: torch.Tensor, long: torch.Tensor) -> torch.Tensor:
    """(B,) int32 hit count of the members probe."""
    out = torch.empty(short.shape[0], dtype=torch.int32, device=short.device)
    return _rows_call(
        "intersect_members_count_launch", "intersect_members_count_kernel", short, long, out
    )


def intersect_count_cuda(short: torch.Tensor, long: torch.Tensor) -> torch.Tensor:
    """(B,) int32 |short ∩ long| per row."""
    out = torch.empty(short.shape[0], dtype=torch.int32, device=short.device)
    return _rows_call("intersect_count_launch", "intersect_count_kernel", short, long, out)
