"""Embedding substrate for recsys on PyTorch: big tables, bags, MLP towers.
The port of ``repro.models.recsys.embedding``.

A table is a (vocab, dim) float32 tensor (a frozen parameter of its
model).  ``lookup`` is a gather (``index_select``), what ``jnp.take``
computes for ids in range; callers hand it in-range ids, as the JAX
launcher does (``jnp.take`` clamps an id out of range, ``index_select``
raises on it).  ``bag_lookup`` is EmbeddingBag(sum) as the JAX package
builds it: the gather, a mask, a sum.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Dense

__all__ = ["MLPTower", "bag_lookup", "bce_with_logits", "embedding_init", "lookup", "mlp_tower",
           "mlp_tower_init"]


def embedding_init(generator: torch.Generator, vocab: int, dim: int, device) -> torch.Tensor:
    """A (vocab, dim) float32 table ~ N(0, 1) · 0.05, drawn on ``device``
    from ``generator`` (which lives there)."""
    return torch.randn((vocab, dim), generator=generator, device=device) * 0.05


def lookup(table: torch.Tensor, ids: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Rows ``ids`` (any shape) of ``table``: (*ids.shape, dim)."""
    out = table.index_select(0, ids.reshape(-1).long()).reshape(*ids.shape, table.shape[1])
    return out if dtype is None else out.to(dtype)


def bag_lookup(table: torch.Tensor, ids: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """EmbeddingBag(sum): ids (..., L) -> (..., dim)."""
    e = lookup(table, ids)
    if mask is not None:
        e = e * mask[..., None].to(e.dtype)
    return e.sum(dim=-2)


class MLPTower(nn.Module):
    """``mlp_tower_init`` / ``mlp_tower``: dense layers ``dims[i] →
    dims[i + 1]`` with ReLU between them (and after the last with
    ``final_act``)."""

    def __init__(self, dims: Sequence[int], device, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(Dense(dims[i], dims[i + 1], bias, dtype, device)
                                    for i in range(len(dims) - 1))

    def forward(self, x: torch.Tensor, final_act: bool = False) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1 or final_act:
                x = F.relu(x)
        return x


def mlp_tower_init(generator: torch.Generator, dims: Sequence[int], device,
                   bias: bool = True) -> MLPTower:
    """An :class:`MLPTower` with ``dense_init`` weights (kernels ~ N(0, 1)
    · d_in^-1/2, biases 0)."""
    tower = MLPTower(dims, device, bias)
    for layer in tower.layers:
        layer.reset(generator)
    return tower


def mlp_tower(tower: MLPTower, x: torch.Tensor, final_act: bool = False) -> torch.Tensor:
    return tower(x, final_act)


def bce_with_logits(logit: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The stable binary cross-entropy of the reference's CTR losses,
    averaged: ``max(z, 0) - z·y + log1p(exp(-|z|))``."""
    return torch.mean(torch.clamp(logit, min=0) - logit * y + torch.log1p(torch.exp(-logit.abs())))
