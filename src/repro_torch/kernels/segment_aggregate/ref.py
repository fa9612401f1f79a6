"""Plain PyTorch version of PNA's aggregation (``_aggregate`` of
``repro.models.pna``, with the layer's message ``relu(hs[src] + hd[dst])``
folded in), and the destination-sorted edge layout the kernels read.

Contract: ``hs = h @ W_src`` and ``hd = h @ W_dst`` are (N, d) float32;
the edges are ``src``, ``dst`` (E,) int32 and their weights ``w`` (E,)
float32 (the edge mask: 0 or 1; no gradient is taken through it).  With
``v = relu(hs[src] + hd[dst]) * w`` (E, d) the result is, per node ``n``
and feature:

    deg   = Σ w                   over the edges into n   (N,)
    denom = max(deg, 1)
    mean  = Σ v / denom
    var   = maximum(Σ v² / denom − mean², 0),  std = sqrt(var + 1e-5)
    max   = max v over the edges with w > 0,   0 where deg == 0
    min   = min v over the edges with w > 0,   0 where deg == 0

Gradients follow the reference's: a max's or min's gradient is spread
evenly over its tied edges (``scatter_reduce``'s ``amax``/``amin`` with
``include_self=False``, as JAX's ``segment_max``), ``torch.maximum``
gives half the gradient to each side at ``Σv²/denom − mean² == 0`` (as
``jnp.maximum``), and relu's gradient at 0 is 0.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

__all__ = ["EPS", "EdgeCSR", "edge_csr", "messages_ref", "segment_aggregate_ref",
           "tie_counts_ref"]

EPS = 1e-5
BIG = 1e30  # the reference's fill for masked edges in the max and the min


class EdgeCSR(NamedTuple):
    """Edges sorted by destination (stable: a destination's edges keep
    their order), with ``indptr`` (N + 1,) int32: the edges into node n
    are positions ``indptr[n]`` to ``indptr[n + 1]``."""

    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    indptr: torch.Tensor

    @property
    def n_nodes(self) -> int:
        return self.indptr.shape[0] - 1


def edge_csr(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, n_nodes: int) -> EdgeCSR:
    """Sort the edges stably by destination (on their own device) and
    build the CSR offsets."""
    src = torch.as_tensor(src).to(torch.int32)
    dst = torch.as_tensor(dst).to(torch.int32)
    w = torch.as_tensor(w, device=dst.device).to(torch.float32)
    order = torch.sort(dst, stable=True).indices
    dst_s = dst[order].contiguous()
    nodes = torch.arange(n_nodes + 1, dtype=torch.int32, device=dst.device)
    indptr = torch.searchsorted(dst_s, nodes, out_int32=True)
    return EdgeCSR(src[order].contiguous(), dst_s, w[order].contiguous(), indptr)


def messages_ref(hs: torch.Tensor, hd: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """``v = relu(hs[src] + hd[dst]) * w`` (E, d)."""
    return torch.relu(hs[src.long()] + hd[dst.long()]) * w[:, None]


def segment_aggregate_ref(hs: torch.Tensor, hd: torch.Tensor, src: torch.Tensor,
                          dst: torch.Tensor, w: torch.Tensor, n_nodes: int
                          ) -> Tuple[torch.Tensor, ...]:
    """``(mean, max, min, std)`` (N, d) and ``deg`` (N,), as the module
    docstring states; differentiable in ``hs`` and ``hd``."""
    d = hs.shape[1]
    w = w.to(hs.dtype)
    v = messages_ref(hs, hd, src, dst, w)
    idx = dst.long()
    zeros = hs.new_zeros((n_nodes, d))
    deg = hs.new_zeros((n_nodes,)).index_add(0, idx, w)
    denom = torch.clamp_min(deg, 1.0)[:, None]
    mean = zeros.index_add(0, idx, v) / denom
    sq = zeros.index_add(0, idx, v * v)
    var = torch.maximum(sq / denom - mean * mean, zeros)
    std = torch.sqrt(var + EPS)
    pos = (w > 0)[:, None]
    rows = idx[:, None].expand(-1, d)
    mx = zeros.scatter_reduce(0, rows, torch.where(pos, v, -BIG), "amax", include_self=False)
    mn = zeros.scatter_reduce(0, rows, torch.where(pos, v, BIG), "amin", include_self=False)
    has = (deg > 0)[:, None]
    return (mean, torch.where(has, mx, 0.0), torch.where(has, mn, 0.0), std, deg)


def tie_counts_ref(v: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, mx: torch.Tensor,
                   mn: torch.Tensor, deg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tie counts the kernels keep for the backward, (N, d) int32: the
    edges with ``w > 0`` whose message equals the node's max (min), 0
    where ``deg == 0``."""
    idx = dst.long()
    pos = (w > 0)[:, None]
    has = (deg > 0)[:, None]
    zeros = torch.zeros(mx.shape, dtype=torch.int32, device=mx.device)
    n_max = zeros.index_add(0, idx, ((v == mx[idx]) & pos).to(torch.int32))
    n_min = zeros.index_add(0, idx, ((v == mn[idx]) & pos).to(torch.int32))
    return torch.where(has, n_max, 0), torch.where(has, n_min, 0)
