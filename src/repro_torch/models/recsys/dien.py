"""DIEN — Deep Interest Evolution Network (Zhou et al., arXiv:1809.03672),
the port of ``repro.models.recsys.dien`` (serving, and training by
:func:`loss_fn`).

Two-stage sequential CTR model:
  1. *Interest extraction*: a GRU over the user-behaviour sequence.
  2. *Interest evolution*: an AUGRU (GRU whose update gate is scaled by
     the attention of each hidden state to the target item).

Both recurrences are Python loops over the T time steps (the JAX
``lax.scan``); a step whose mask is 0 keeps its state.  Config:
embed_dim=18, seq_len=100, gru_dim=108, mlp=200-80.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.core.device_engine import resolve_device
from repro_torch.models.layers import Dense, frozen_param
from repro_torch.models.recsys.embedding import (MLPTower, bce_with_logits, embedding_init,
                                                 lookup)

__all__ = ["DIEN", "DIENConfig", "init", "loss_fn"]

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class DIENConfig:
    name: str = "dien"
    vocab: int = 1_000_000
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp: tuple = (200, 80)
    dtype: str = "float32"
    scan_unroll: int = 1  # the JAX time-scan's unroll (dry-run probes); unused here

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def n_params(self) -> int:
        e, g = self.embed_dim, self.gru_dim
        gru1 = 3 * (e * g + g * g + g)
        att = g * e
        augru = 3 * (g * g + g * g + g)
        d_in = g + e
        dims = (d_in,) + self.mlp + (1,)
        mlp = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
        return self.vocab * e + gru1 + att + augru + mlp


class GRUGate(nn.Module):
    """One gate of ``_gru_init``: ``wx`` (d_in, d_h), ``wh`` (d_h, d_h),
    ``b`` (d_h,)."""

    def __init__(self, d_in: int, d_h: int, device):
        super().__init__()
        self.wx = frozen_param((d_in, d_h), torch.float32, device)
        self.wh = frozen_param((d_h, d_h), torch.float32, device)
        self.b = frozen_param((d_h,), torch.float32, device)

    def reset(self, generator: torch.Generator) -> None:
        d_in, d_h = self.wx.shape
        self.wx.copy_(torch.randn(self.wx.shape, generator=generator, device=self.wx.device)
                      * d_in**-0.5)
        self.wh.copy_(torch.randn(self.wh.shape, generator=generator, device=self.wh.device)
                      * d_h**-0.5)
        self.b.zero_()


class GRU(nn.Module):
    """``_gru_init`` / ``_gru_cell``: update gate z, reset gate r and
    candidate h; with ``gate_scale`` (B,) the AUGRU's attention-scaled
    update gate."""

    def __init__(self, d_in: int, d_h: int, device):
        super().__init__()
        self.z = GRUGate(d_in, d_h, device)
        self.r = GRUGate(d_in, d_h, device)
        self.h = GRUGate(d_in, d_h, device)

    def forward(self, h: torch.Tensor, x: torch.Tensor,
                gate_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        z = torch.sigmoid(x @ self.z.wx + h @ self.z.wh + self.z.b)
        r = torch.sigmoid(x @ self.r.wx + h @ self.r.wh + self.r.b)
        hh = torch.tanh(x @ self.h.wx + (r * h) @ self.h.wh + self.h.b)
        if gate_scale is not None:
            z = z * gate_scale[:, None]
        return (1.0 - z) * h + z * hh


class DIEN(nn.Module):
    """The model: item table, the extraction GRU, the attention kernel
    (g, e) (a :class:`Dense` without bias, ``att``), the AUGRU and the
    MLP head (g + e, *mlp, 1).  Zeros until :func:`init` or
    ``convert.recsys_from_numpy`` fills it."""

    def __init__(self, cfg: DIENConfig, device):
        super().__init__()
        self.cfg = cfg
        self.item_embed = frozen_param((cfg.vocab, cfg.embed_dim), torch.float32, device)
        self.gru = GRU(cfg.embed_dim, cfg.gru_dim, device)
        self.att = Dense(cfg.gru_dim, cfg.embed_dim, False, torch.float32, device)
        self.augru = GRU(cfg.gru_dim, cfg.gru_dim, device)
        self.mlp = MLPTower((cfg.gru_dim + cfg.embed_dim,) + cfg.mlp + (1,), device)

    def user_state(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Final AUGRU state (B, gru_dim) — the evolved interest."""
        dt = self.cfg.adtype
        hist = lookup(self.item_embed, batch["hist_ids"], dt)  # (B, T, e)
        mask = batch["hist_mask"].to(dt)  # (B, T)
        tgt = lookup(self.item_embed, batch["target_id"], dt)  # (B, e)
        b, t, _ = hist.shape
        live = mask.T[..., None] > 0  # (T, B, 1)

        # Stage 1: interest extraction GRU over the sequence.
        h = torch.zeros((b, self.cfg.gru_dim), dtype=dt, device=hist.device)
        states = []
        for i in range(t):
            h = torch.where(live[i], self.gru(h, hist[:, i]), h)
            states.append(h)
        states = torch.stack(states)  # (T, B, g)

        # Attention of each interest state to the target item.
        scores = torch.einsum("tbg,ge,be->tb", states, self.att.kernel.to(dt), tgt)
        scores = torch.where(live[..., 0], scores, NEG_INF)
        att = torch.softmax(scores.float(), dim=0).to(dt)

        # Stage 2: AUGRU interest evolution.
        h = torch.zeros((b, self.cfg.gru_dim), dtype=dt, device=hist.device)
        for i in range(t):
            h = torch.where(live[i], self.augru(h, states[i], gate_scale=att[i]), h)
        return h

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """CTR logit (B,)."""
        h2 = self.user_state(batch)
        tgt = lookup(self.item_embed, batch["target_id"], self.cfg.adtype)
        return self.mlp(torch.cat([h2, tgt], dim=-1))[:, 0]

    def score_candidates(self, batch: Dict[str, torch.Tensor],
                         cand_ids: torch.Tensor) -> torch.Tensor:
        """retrieval_cand head (B, N): the user state through the
        attention kernel · candidate embeddings, one product (the JAX
        package's target-free adaptation)."""
        dt = self.cfg.adtype
        user = self.user_state(batch)  # (B, g)
        cands = lookup(self.item_embed, cand_ids, dt)  # (N, e)
        return (user @ self.att.kernel.to(dt)) @ cands.T


def init(cfg: DIENConfig, generator: torch.Generator, device=None) -> DIEN:
    """Random weights as the JAX ``init`` draws them (from ``generator``,
    which lives on the device; not the same numbers).  ``device``
    defaults to ``cuda`` and raises without a GPU."""
    dev = resolve_device(device)
    model = DIEN(cfg, dev)
    model.item_embed.copy_(embedding_init(generator, cfg.vocab, cfg.embed_dim, dev))
    for module in model.modules():
        if isinstance(module, (GRUGate, Dense)):
            module.reset(generator)
    return model


def loss_fn(model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The CTR loss: the stable binary cross-entropy of the logit
    (float32) against ``label``."""
    return bce_with_logits(model(batch).float(), batch["label"].float())
