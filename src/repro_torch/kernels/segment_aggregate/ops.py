"""Public wrapper: PNA's aggregation over destination-sorted edges.

A tensor that lies on the CPU takes the plain PyTorch version of
:mod:`repro_torch.kernels.segment_aggregate.ref` (autograd through it); a
CUDA tensor goes through one ``torch.autograd.Function`` whose forward
and backward are the hand-written kernels of
:mod:`repro_torch.kernels.segment_aggregate.kernel`, or raises.  Nothing
falls back from the card to the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.segment_aggregate import kernel as K
from repro_torch.kernels.segment_aggregate.ref import EdgeCSR, edge_csr, segment_aggregate_ref

__all__ = ["EdgeCSR", "edge_csr", "segment_aggregate"]


class _SegmentAggregate(torch.autograd.Function):
    """The kernel pair as one differentiable function of ``hs`` and ``hd``;
    ``deg`` is not differentiable.  The forward saves its outputs, the
    tie counts and q's sign for the backward (~6 (N, d) tensors)."""

    @staticmethod
    def forward(ctx, hs, hd, src, dst, w, indptr, run_edges):
        csr = EdgeCSR(src, dst, w, indptr)
        saved = K.segment_aggregate_fwd_cuda(hs, hd, csr, run_edges)
        ctx.save_for_backward(hs, hd, src, dst, w, indptr, *saved)
        ctx.run_edges = run_edges
        ctx.mark_non_differentiable(saved.deg)
        return saved.mean, saved.mx, saved.mn, saved.std, saved.deg

    @staticmethod
    def backward(ctx, g_mean, g_max, g_min, g_std, _g_deg):
        hs, hd, src, dst, w, indptr, *rest = ctx.saved_tensors
        saved = K.FwdSaved(*rest)
        grads = [torch.zeros_like(hs) if g is None else g.contiguous()
                 for g in (g_mean, g_max, g_min, g_std)]
        d_hs, d_hd = K.segment_aggregate_bwd_cuda(hs, hd, EdgeCSR(src, dst, w, indptr), saved,
                                                  *grads, run_edges=ctx.run_edges)
        return d_hs, d_hd, None, None, None, None, None


def segment_aggregate(hs: torch.Tensor, hd: torch.Tensor, csr: EdgeCSR,
                      run_edges: int = K.RUN_EDGES) -> Tuple[torch.Tensor, ...]:
    """``(mean, max, min, std, deg)`` of the messages
    ``relu(hs[src] + hd[dst]) * w`` over each node's incoming edges
    (``csr``: :func:`edge_csr`), as ``repro.models.pna._aggregate``."""
    if hs.is_cuda:
        return _SegmentAggregate.apply(hs.contiguous(), hd.contiguous(), csr.src, csr.dst, csr.w,
                                       csr.indptr, run_edges)
    return segment_aggregate_ref(hs, hd, csr.src, csr.dst, csr.w, csr.n_nodes)
