"""DCN-v2 — Deep & Cross Network v2 (Wang et al., arXiv:2008.13535), the
port of ``repro.models.recsys.dcnv2`` (serving, and training by
:func:`loss_fn`).

Explicit feature crosses  x_{l+1} = x₀ ⊙ (W_l x_l + b_l) + x_l  (full-rank
W) in parallel with a deep MLP tower, concatenated into the CTR logit.
Config: 13 dense + 26 sparse fields, embed_dim=16, 3 cross layers, MLP
1024-1024-512.  The per-field tables are one stacked (F, V, e) tensor and
the cross layers one stacked (n, d, d) kernel with (n, d) biases, as the
JAX package keeps them; the cross layers run as a loop over the stack.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from repro_torch.core.device_engine import resolve_device
from repro_torch.models.layers import Dense, frozen_param
from repro_torch.models.recsys.embedding import (MLPTower, bce_with_logits, embedding_init,
                                                 lookup)

__all__ = ["DCNv2", "DCNv2Config", "init", "loss_fn"]


@dataclasses.dataclass(frozen=True)
class DCNv2Config:
    name: str = "dcn-v2"
    n_dense: int = 13
    n_sparse: int = 26
    vocab_per_field: int = 100_000
    embed_dim: int = 16
    n_cross_layers: int = 3
    mlp: tuple = (1024, 1024, 512)
    dtype: str = "float32"

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def d_input(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim

    def n_params(self) -> int:
        d = self.d_input
        emb = self.n_sparse * self.vocab_per_field * self.embed_dim
        cross = self.n_cross_layers * (d * d + d)
        dims = (d,) + self.mlp
        deep = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
        head = (d + self.mlp[-1]) + 1
        return emb + cross + deep + head


class DCNv2(nn.Module):
    """The model: stacked tables (F, V, e), stacked cross kernels
    (n, d, d) and biases (n, d), the deep tower (d, *mlp) and the head
    (d + mlp[-1] → 1).  Zeros until :func:`init` or
    ``convert.recsys_from_numpy`` fills it."""

    def __init__(self, cfg: DCNv2Config, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_input
        self.tables = frozen_param((cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim),
                                   torch.float32, device)
        self.cross_kernel = frozen_param((cfg.n_cross_layers, d, d), torch.float32, device)
        self.cross_bias = frozen_param((cfg.n_cross_layers, d), torch.float32, device)
        self.deep = MLPTower((d,) + cfg.mlp, device)
        self.head = Dense(d + cfg.mlp[-1], 1, True, torch.float32, device)

    def embed_input(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """x₀ (B, d): the dense features, then each field's embedding."""
        cfg = self.cfg
        # Tensor ``%`` is the floor modulo of ``jnp`` (``torch.fmod`` is not).
        ids = batch["sparse_ids"].long() % cfg.vocab_per_field  # (B, F)
        flat = ids + torch.arange(cfg.n_sparse, device=ids.device) * cfg.vocab_per_field
        emb = lookup(self.tables.reshape(-1, cfg.embed_dim), flat)  # (B, F, e)
        b = ids.shape[0]
        return torch.cat([batch["dense"].to(cfg.adtype), emb.reshape(b, -1).to(cfg.adtype)],
                         dim=-1)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """CTR logit (B,)."""
        x0 = self.embed_input(batch)
        x = x0
        for kernel, bias in zip(self.cross_kernel, self.cross_bias):
            x = x0 * (x @ kernel.to(x.dtype) + bias.to(x.dtype)) + x
        xd = self.deep(x0, final_act=True)
        return self.head(torch.cat([x, xd], dim=-1))[:, 0]

    def score_candidates(self, batch: Dict[str, torch.Tensor],
                         cand_ids: torch.Tensor) -> torch.Tensor:
        """retrieval_cand adaptation of the JAX package: DCN-v2 ranks and
        has no two towers, so the deep tower's user representation (its
        first embed_dim units) scores candidate embeddings from field 0's
        table."""
        cfg = self.cfg
        user = self.deep(self.embed_input(batch), final_act=True)  # (B, mlp[-1])
        cands = lookup(self.tables[0], cand_ids.long() % cfg.vocab_per_field, cfg.adtype)
        return user[:, :cfg.embed_dim] @ cands.T


def init(cfg: DCNv2Config, generator: torch.Generator, device=None) -> DCNv2:
    """Random weights as the JAX ``init`` draws them (from ``generator``,
    which lives on the device; not the same numbers): tables ~ N(0, 1) ·
    0.05 one field at a time, cross kernels ~ N(0, 1) · d^-1/2, biases 0.
    ``device`` defaults to ``cuda`` and raises without a GPU."""
    dev = resolve_device(device)
    model = DCNv2(cfg, dev)
    for f in range(cfg.n_sparse):
        model.tables[f].copy_(embedding_init(generator, cfg.vocab_per_field, cfg.embed_dim, dev))
    d = cfg.d_input
    for layer in range(cfg.n_cross_layers):
        model.cross_kernel[layer].copy_(
            torch.randn((d, d), generator=generator, device=dev) * d**-0.5)
    model.cross_bias.zero_()
    for module in model.modules():
        if isinstance(module, Dense):
            module.reset(generator)
    return model


def loss_fn(model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The CTR loss: the stable binary cross-entropy of the logit
    (float32) against ``label``."""
    return bce_with_logits(model(batch).float(), batch["label"].float())
