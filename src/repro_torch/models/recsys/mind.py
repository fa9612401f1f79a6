"""MIND — Multi-Interest Network with Dynamic routing (Li et al.,
arXiv:1904.08030), the port of ``repro.models.recsys.mind`` (serving, and
training by :func:`loss_fn`).

Behaviour-to-Interest (B2I) capsule routing: the user's history item
embeddings are routed into ``n_interests`` interest capsules over
``capsule_iters`` iterations (softmax over the interests of each
behaviour, masked with -1e30 in float32; squash nonlinearity; routing
logits updated by agreement).  ``forward`` is the label-aware attention
(the target attends the interests with a softmax powered by
``label_pow``); ``score_candidates`` scores every candidate against all
interests and takes the max.

Config: embed_dim=64, n_interests=4, capsule_iters=3.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from repro_torch.core.device_engine import resolve_device
from repro_torch.models.layers import frozen_param
from repro_torch.models.recsys.embedding import MLPTower, embedding_init, lookup

__all__ = ["MIND", "MINDConfig", "init", "loss_fn"]

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    vocab: int = 1_000_000
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    label_pow: float = 2.0  # label-aware attention power
    n_negatives: int = 512  # sampled-softmax negatives (training)
    dtype: str = "float32"

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def n_params(self) -> int:
        e = self.embed_dim
        return self.vocab * e + e * e + 2 * (e * e + e)


def squash(v: torch.Tensor) -> torch.Tensor:
    n2 = v.square().sum(dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * v / torch.sqrt(n2 + 1e-9)


class MIND(nn.Module):
    """The model: item table, the bilinear map (e, e) and the (e, e, e)
    MLP applied to the interests.  Zeros until :func:`init` or
    ``convert.recsys_from_numpy`` fills it."""

    def __init__(self, cfg: MINDConfig, device):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        self.item_embed = frozen_param((cfg.vocab, e), torch.float32, device)
        self.bilinear = frozen_param((e, e), torch.float32, device)
        self.mlp = MLPTower((e, e, e), device)

    def user_interests(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, K, e) interest capsules via B2I dynamic routing."""
        dt = self.cfg.adtype
        hist = lookup(self.item_embed, batch["hist_ids"], dt)  # (B, T, e)
        mask = batch["hist_mask"].to(dt)  # (B, T)
        u = hist @ self.bilinear.to(dt)  # behaviour capsules (B, T, e)
        b, t, _ = u.shape
        logits = torch.zeros((b, self.cfg.n_interests, t), dtype=dt, device=u.device)
        live = mask[:, None, :] > 0
        for _ in range(self.cfg.capsule_iters):
            # softmax over the interests of each behaviour
            route = torch.softmax(torch.where(live, logits.float(), NEG_INF), dim=1).to(dt)
            caps = squash(torch.einsum("bkt,bte->bke", route * mask[:, None, :], u))
            logits = logits + torch.einsum("bke,bte->bkt", caps, u)
        return self.mlp(caps)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Label-aware-attended user vector · target (B,)."""
        dt = self.cfg.adtype
        caps = self.user_interests(batch)
        tgt = lookup(self.item_embed, batch["target_id"], dt)  # (B, e)
        att = torch.softmax(
            self.cfg.label_pow * torch.einsum("bke,be->bk", caps, tgt).float(), dim=-1).to(dt)
        user = torch.einsum("bk,bke->be", att, caps)
        return torch.einsum("be,be->b", user, tgt)

    def score_candidates(self, batch: Dict[str, torch.Tensor],
                         cand_ids: torch.Tensor) -> torch.Tensor:
        """(B, N): the max over interests of interest · candidate."""
        caps = self.user_interests(batch)  # (B, K, e)
        cands = lookup(self.item_embed, cand_ids, self.cfg.adtype)  # (N, e)
        return torch.einsum("bke,ne->bkn", caps, cands).amax(dim=1)


def init(cfg: MINDConfig, generator: torch.Generator, device=None) -> MIND:
    """Random weights as the JAX ``init`` draws them (from ``generator``,
    which lives on the device; not the same numbers).  ``device``
    defaults to ``cuda`` and raises without a GPU."""
    dev = resolve_device(device)
    model = MIND(cfg, dev)
    e = cfg.embed_dim
    model.item_embed.copy_(embedding_init(generator, cfg.vocab, e, dev))
    model.bilinear.copy_(torch.randn((e, e), generator=generator, device=dev) * e**-0.5)
    for layer in model.mlp.layers:
        layer.reset(generator)
    return model


def loss_fn(model: MIND, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The reference's training loss: the label-aware user vector of each
    row against every row's target, an in-batch softmax (B, B) in float32
    with the positives on the diagonal, averaged."""
    dt = model.cfg.adtype
    caps = model.user_interests(batch)
    tgt = lookup(model.item_embed, batch["target_id"], dt)
    att = torch.softmax(
        model.cfg.label_pow * torch.einsum("bke,be->bk", caps, tgt).float(), dim=-1).to(dt)
    user = torch.einsum("bk,bke->be", att, caps)  # (B, e)
    logits = (user @ tgt.T).float()  # (B, B)
    lse = torch.logsumexp(logits, dim=-1)
    return torch.mean(lse - torch.diagonal(logits))
