"""Launchers of PNA's aggregation kernels (``csrc/segment_aggregate.cu``).

The library is built, loaded and counted by
:mod:`repro_torch.kernels.build`.  Each launcher checks device, dtype,
contiguity and shape, allocates its outputs and its run records with
``torch.empty`` (the backward's gradients with ``torch.zeros``: ``d hs``
takes atomics), launches on ``torch.cuda.current_stream()``, raises when
the launch reports a CUDA error, and adds one to
``LAUNCHES["segment_aggregate_fwd"]`` or ``["segment_aggregate_bwd"]``
per call.  The edges come as an :class:`~repro_torch.kernels.
segment_aggregate.ref.EdgeCSR` (sorted by destination); ``run_edges`` is
the edges a warp takes (the split by edges, not by nodes).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.build import LAUNCHES, check, lib, stream_of
from repro_torch.kernels.segment_aggregate.ref import EdgeCSR

__all__ = ["FwdSaved", "RUN_EDGES", "n_runs", "segment_aggregate_bwd_cuda",
           "segment_aggregate_fwd_cuda"]

# Edges a warp walks: at ogb_products 59,791 runs; node 0's 11.5 M edges
# merge from 11,228 records.  On the card at ogb_products the forward ran
# fastest at 1024 of 512, 1024, 2048 and 4096 edges, the backward within
# 4 % of its fastest (512).
RUN_EDGES = 1024
MAX_INDEX = 2**31 - 1


class FwdSaved(NamedTuple):
    """The forward's outputs: ``mean, max, min, std`` (N, d) float32,
    ``deg`` (N,) float32, and what the backward reads besides: the tie
    counts of the max and the min (N, d) int32 and q's sign (N, d) int8
    (2, 1, 0 as ``Σv²/denom − mean²`` is above, at or below 0)."""

    mean: torch.Tensor
    mx: torch.Tensor
    mn: torch.Tensor
    std: torch.Tensor
    deg: torch.Tensor
    n_max: torch.Tensor
    n_min: torch.Tensor
    vcode: torch.Tensor


def n_runs(n_edges: int, run_edges: int = RUN_EDGES) -> int:
    return -(-n_edges // run_edges) if n_edges > 0 else 0


def _check(name: str, hs: torch.Tensor, hd: torch.Tensor, csr: EdgeCSR, run_edges: int) -> None:
    device = hs.device
    if not 32 <= run_edges <= MAX_INDEX // 2:
        raise ValueError(f"{name}: run_edges {run_edges} outside [32, 2^30)")
    if hs.dim() != 2 or hd.shape != hs.shape:
        raise ValueError(f"{name}: hs and hd (N, d) of one shape expected, got "
                         f"{tuple(hs.shape)} and {tuple(hd.shape)}")
    n, d = hs.shape
    e = csr.src.shape[0]
    if csr.indptr.shape != (n + 1,) or csr.dst.shape != (e,) or csr.w.shape != (e,):
        raise ValueError(f"{name}: src, dst, w (E,) and indptr (N + 1,) expected for N={n}")
    for t, dtype in ((hs, torch.float32), (hd, torch.float32), (csr.src, torch.int32),
                     (csr.dst, torch.int32), (csr.w, torch.float32), (csr.indptr, torch.int32)):
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name}: every input must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if d < 1 or e > MAX_INDEX or n * d > 2**62:
        raise ValueError(f"{name}: d >= 1 and E < 2^31 required, got d={d} E={e}")


def segment_aggregate_fwd_cuda(hs: torch.Tensor, hd: torch.Tensor, csr: EdgeCSR,
                               run_edges: int = RUN_EDGES) -> FwdSaved:
    """The forward; same contract as
    :func:`repro_torch.kernels.segment_aggregate.ref.segment_aggregate_ref`
    on the sorted edges, plus the backward's tie counts and q's sign."""
    name = "segment_aggregate_fwd"
    _check(name, hs, hd, csr, run_edges)
    n, d = hs.shape
    e = csr.src.shape[0]
    dev = hs.device
    runs = n_runs(e, run_edges)
    out = FwdSaved(*(torch.empty((n, d), dtype=torch.float32, device=dev) for _ in range(4)),
                   torch.empty((n,), dtype=torch.float32, device=dev),
                   torch.empty((n, d), dtype=torch.int32, device=dev),
                   torch.empty((n, d), dtype=torch.int32, device=dev),
                   torch.empty((n, d), dtype=torch.int8, device=dev))
    slots = max(2 * runs, 1)
    records = (torch.empty((slots, 2 * d), dtype=torch.float64, device=dev),  # the sums
               torch.empty((slots, 2 * d + 1), dtype=torch.float32, device=dev),  # max, min, deg
               torch.empty((slots, 2 * d), dtype=torch.int32, device=dev))  # tie counts
    if n == 0:
        return out
    status = lib("segment_aggregate").segment_aggregate_fwd_launch(
        hs.data_ptr(), hd.data_ptr(), csr.src.data_ptr(), csr.dst.data_ptr(), csr.w.data_ptr(),
        csr.indptr.data_ptr(), n, e, d, run_edges, *(t.data_ptr() for t in records),
        *(t.data_ptr() for t in out), stream_of(dev))
    check(status, name)
    LAUNCHES[name] += 1
    return out


def segment_aggregate_bwd_cuda(hs: torch.Tensor, hd: torch.Tensor, csr: EdgeCSR,
                               saved: FwdSaved, g_mean: torch.Tensor, g_max: torch.Tensor,
                               g_min: torch.Tensor, g_std: torch.Tensor,
                               run_edges: int = RUN_EDGES):
    """``(d hs, d hd)`` (N, d) float32 from the gradients of ``mean, max,
    min, std`` and the forward's :class:`FwdSaved` (the same ``run_edges``
    or any other: the backward recomputes each edge's message)."""
    name = "segment_aggregate_bwd"
    _check(name, hs, hd, csr, run_edges)
    n, d = hs.shape
    e = csr.src.shape[0]
    dev = hs.device
    for t in (*saved, g_mean, g_max, g_min, g_std):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: saved tensors and gradients must be contiguous on {dev}")
    for t in (g_mean, g_max, g_min, g_std):
        if t.shape != (n, d) or t.dtype != torch.float32:
            raise ValueError(f"{name}: gradients (N, d) float32 expected")
    d_hs = torch.zeros((n, d), dtype=torch.float32, device=dev)
    d_hd = torch.zeros((n, d), dtype=torch.float32, device=dev)
    rec = torch.empty((max(2 * n_runs(e, run_edges), 1), d), dtype=torch.float64, device=dev)
    if n == 0:
        return d_hs, d_hd
    status = lib("segment_aggregate").segment_aggregate_bwd_launch(
        hs.data_ptr(), hd.data_ptr(), csr.src.data_ptr(), csr.dst.data_ptr(), csr.w.data_ptr(),
        csr.indptr.data_ptr(), n, e, d, run_edges, *(t.data_ptr() for t in saved),
        g_mean.data_ptr(), g_max.data_ptr(), g_min.data_ptr(), g_std.data_ptr(),
        rec.data_ptr(), d_hs.data_ptr(), d_hd.data_ptr(), stream_of(dev))
    check(status, name)
    LAUNCHES[name] += 1
    return d_hs, d_hd
