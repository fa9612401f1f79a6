"""Launchers of the search path's CUDA kernels: the fold
(``csrc/fold.cu``) and the intersect trio (``csrc/intersect.cu``), whose
two count launchers take the row or the split form by
:func:`count_route`.

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
    "count_route",
    "device_sms",
    "split_chunk",
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
# by value in the kernel's arguments (FOLD_MAX_STAGES of csrc/fold.cu).  A
# deeper plan runs as a chain of launches of at most this many stages.
FOLD_MAX_STAGES = 64


def fold_launches(n_stages: int) -> int:
    """Kernel launches the fold of ``n_stages`` stages takes."""
    return max(1, -(-n_stages // FOLD_MAX_STAGES))


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
    buffer.  A plan of more than :data:`FOLD_MAX_STAGES` stages runs as
    :func:`fold_launches` chained launches that carry the cells in the
    members buffer (allocated then even without ``return_members``)."""
    device = _check_int32_cuda("segment_fold", post_docs, cells, stage_seg)
    n_stages = len(stage_iters)
    if post_docs.dim() != 1 or cells.dim() != 2 or cells.shape[0] != 4:
        raise ValueError("segment_fold: post_docs (n,) and cells (4, N) expected")
    if stage_seg.dim() != 2 or stage_seg.shape[0] != 2:
        raise ValueError("segment_fold: stage_seg (2, n_stages * group_width) expected")
    if stage_seg.shape[1] != n_stages * group_width:
        raise ValueError("segment_fold: stage_seg width != n_stages * group_width")
    n_cells = cells.shape[1]
    n_launches = fold_launches(n_stages)
    zeroed = torch.zeros(n_queries_pad + n_stages, dtype=torch.int32, device=device)
    counts, entering = zeroed[:n_queries_pad], zeroed[n_queries_pad:]
    members = (
        torch.empty(n_cells, dtype=torch.int32, device=device)
        if return_members or n_launches > 1
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
    LAUNCHES["segment_fold"] += n_launches
    return counts, entering, members if return_members else None


def _check_rows(name: str, short, long) -> torch.device:
    device = _check_int32_cuda(name, short, long)
    if short.dim() != 2 or long.dim() != 2 or short.shape[0] != long.shape[0]:
        raise ValueError(f"{name}: short (B, Ls) and long (B, Ll) expected")
    return device


def _rows_call(fn_name: str, counter: str, short, long, out):
    device = _check_rows(counter, short, long)
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


# The count kernels' two forms (csrc/intersect.cu).  The row form runs one
# block of 128 threads a row; the split form one block of SPLIT_THREADS a
# (row, chunk of short elements), each block probing only the window of the
# long row its chunk's values span (windows of up to 4,096 elements staged
# in shared memory), its count added to the row's output by an atomic.
# The cuts are tools/count_ab.py's on an H100 (PERF.md), at the
# non-clustered baseline's bins, the block path's packs and random rows:
# at <= ROW_FORM_LS short elements a row the row form's one launch wins by
# ~1 us (the split form also zeroes its output); past that the split form
# wins at few rows (2-3x at 1,024 short elements, 60-100x at 131,072) and
# the row form from 4-8 rows a streaming multiprocessor (ROW_FORM_ROWS_PER_SM
# between), where its grid fills the card, except at more than WIDE_LS
# short elements, where the split form wins at every row count; chunks of
# 512 are fastest up to WIDE_LS short elements, chunks of 2,048 beyond.
SPLIT_THREADS = 256
SPLIT_CHUNKS = (SPLIT_THREADS * 2, SPLIT_THREADS * 8)
ROW_FORM_ROWS_PER_SM = 6
ROW_FORM_LS = 256
WIDE_LS = 16384


_SMS: dict = {}


def device_sms(device: torch.device) -> int:
    """Streaming multiprocessors of the CUDA ``device`` (asked once)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def count_route(n_rows: int, ls: int, ll: int, sms: int) -> str:
    """The count form a (n_rows, ls) x (n_rows, ll) call launches on a
    card of ``sms`` streaming multiprocessors: ``"split"`` when a short row
    holds more than :data:`ROW_FORM_LS` elements and either more than
    :data:`WIDE_LS` or there are fewer than :data:`ROW_FORM_ROWS_PER_SM`
    rows a multiprocessor, else ``"row"``."""
    if ll > 0 and ls > ROW_FORM_LS and (ls > WIDE_LS or n_rows < ROW_FORM_ROWS_PER_SM * sms):
        return "split"
    return "row"


def split_chunk(ls: int) -> int:
    """Short elements a block of the split form takes at short rows of
    ``ls``."""
    return SPLIT_CHUNKS[0] if ls <= WIDE_LS else SPLIT_CHUNKS[1]


def _count_call(members: bool, short, long, form: Optional[str] = None) -> torch.Tensor:
    """One launch of the count (``members``: the members count) in
    ``form`` (None: the one :func:`count_route` picks), counted as the call
    (``intersect_count_kernel`` or ``intersect_members_count_kernel``) and
    as the form (``intersect_count_row`` or ``intersect_count_split``)."""
    counter = "intersect_members_count_kernel" if members else "intersect_count_kernel"
    device = _check_rows(counter, short, long)
    n_rows, ls, ll = short.shape[0], short.shape[1], long.shape[1]
    if form is None:
        form = count_route(n_rows, ls, ll, device_sms(device))
    if form == "row":
        fn_name = "intersect_members_count_launch" if members else "intersect_count_launch"
        out = _rows_call(fn_name, counter,
                         short, long, torch.empty(n_rows, dtype=torch.int32, device=device))
    else:
        out = torch.zeros(n_rows, dtype=torch.int32, device=device)
        status = lib("intersect").intersect_count_split_launch(
            short.data_ptr(), long.data_ptr(), n_rows, ls, ll, split_chunk(ls),
            out.data_ptr(), stream_of(device))
        check(status, counter)
        LAUNCHES[counter] += 1
    LAUNCHES[f"intersect_count_{form}"] += 1
    return out


def intersect_members_count_cuda(short: torch.Tensor, long: torch.Tensor) -> torch.Tensor:
    """(B,) int32 hit count of the members probe, in the form
    :func:`count_route` picks."""
    return _count_call(True, short, long)


def intersect_count_cuda(short: torch.Tensor, long: torch.Tensor) -> torch.Tensor:
    """(B,) int32 |short ∩ long| per row, in the form :func:`count_route`
    picks."""
    return _count_call(False, short, long)


def _row_form_forced(short: torch.Tensor, long: torch.Tensor,
                     members: bool = False) -> torch.Tensor:
    """The count (``members``: the members count) in the row form on any
    shape: the design the split form replaced at few, long rows."""
    return _count_call(members, short, long, "row")


def _split_form_forced(short: torch.Tensor, long: torch.Tensor,
                       members: bool = False) -> torch.Tensor:
    """The count in the split form (chunks of :func:`split_chunk`) on any
    shape."""
    return _count_call(members, short, long, "split")
