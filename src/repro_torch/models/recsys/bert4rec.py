"""BERT4Rec — bidirectional transformer for sequential recommendation
(Sun et al., arXiv:1904.06690), the port of
``repro.models.recsys.bert4rec`` (serving and training).

Encoder-only.  Each block: RMS-norm, non-causal multi-head attention (2
heads of 32, RoPE θ = 10⁴) through
:func:`repro_torch.models.layers.attention` — on the card the CUDA
``flash_attention`` kernel (its ``resident`` variant at float32, D = 32)
— then an ungated GELU MLP (tanh GELU, as ``jax.nn.gelu``).  Padding is
masked by zeroing values, not scores, as in the JAX package: the inputs
and each residual update are multiplied by the mask.  The JAX package
stacks the blocks for ``lax.scan``; here each block is a module.  The
user is the last position's hidden state.

Training (:func:`loss_fn`): the reference's Cloze masking derived from
the ids, a sampled softmax over 512 shared negatives, the attention's
gradient through the hand-written backward on the card.

Config: embed_dim=64, 2 blocks, 2 heads, seq_len=200.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from repro_torch.core.device_engine import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.recsys.embedding import embedding_init, lookup

__all__ = ["BERT4Rec", "BERT4RecConfig", "EncoderBlock", "init", "loss_fn"]

ROPE_THETA = 10_000.0
# Shared negatives of the sampled softmax (the reference's ``n_neg``).
N_NEGATIVES = 512


@dataclasses.dataclass(frozen=True)
class BERT4RecConfig:
    name: str = "bert4rec"
    vocab: int = 1_000_000  # items; id 0 reserved as [PAD], 1 as [MASK]
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    d_ff: int = 256
    mask_prob: float = 0.2
    dtype: str = "float32"

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.n_heads

    def n_params(self) -> int:
        e = self.embed_dim
        per = 4 * e * e + 2 * e * self.d_ff + 2 * e
        return self.vocab * e + self.seq_len * e + self.n_blocks * per + e


class EncoderBlock(nn.Module):
    """One block of ``encode``'s scan: pre-norm bidirectional attention
    and a pre-norm ungated GELU MLP, each update masked."""

    def __init__(self, cfg: BERT4RecConfig, device):
        super().__init__()
        dt, e = cfg.adtype, cfg.embed_dim
        self.attn_norm = L.frozen_param((e,), torch.float32, device)
        self.attn = L.GQAAttention(e, cfg.n_heads, cfg.n_heads, cfg.head_dim, ROPE_THETA,
                                   False, False, dt, device)
        self.ffn_norm = L.frozen_param((e,), torch.float32, device)
        self.mlp = L.MLP(e, cfg.d_ff, "gelu", dt, device, gated=False)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        h = self.attn(L.rms_norm(x, self.attn_norm), positions, None, causal=False)
        x = x + h * mask
        return x + self.mlp(L.rms_norm(x, self.ffn_norm)) * mask


class BERT4Rec(nn.Module):
    """The model: item table, positional table (seq_len, e), the blocks
    and the final norm.  Zeros until :func:`init` or
    ``convert.recsys_from_numpy`` fills it."""

    def __init__(self, cfg: BERT4RecConfig, device):
        super().__init__()
        self.cfg = cfg
        self.item_embed = L.frozen_param((cfg.vocab, cfg.embed_dim), torch.float32, device)
        self.pos_embed = L.frozen_param((cfg.seq_len, cfg.embed_dim), torch.float32, device)
        self.blocks = nn.ModuleList(EncoderBlock(cfg, device) for _ in range(cfg.n_blocks))
        self.final_norm = L.frozen_param((cfg.embed_dim,), torch.float32, device)

    def encode(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """ids (B, T) -> hidden (B, T, e), bidirectional over the valid
        positions."""
        dt = self.cfg.adtype
        t = ids.shape[1]
        m = mask[..., None].to(dt)
        x = (lookup(self.item_embed, ids, dt) + self.pos_embed[:t].to(dt)[None]) * m
        # One row of positions, broadcast over the batch by ``rope``.
        positions = torch.arange(t, device=ids.device)[None]
        for blk in self.blocks:
            x = blk(x, positions, m)
        return L.rms_norm(x, self.final_norm)

    def user(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, e): the last position's hidden state."""
        return self.encode(batch["hist_ids"], batch["hist_mask"])[:, -1]

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Serve scoring (B,): the user · the target's embedding."""
        tgt = lookup(self.item_embed, batch["target_id"], self.cfg.adtype)
        return torch.einsum("be,be->b", self.user(batch), tgt)

    def score_candidates(self, batch: Dict[str, torch.Tensor],
                         cand_ids: torch.Tensor) -> torch.Tensor:
        """(B, N): the user · candidate embeddings."""
        return self.user(batch) @ lookup(self.item_embed, cand_ids, self.cfg.adtype).T


def _int32_wrapped(x: torch.Tensor) -> torch.Tensor:
    """int64 values as the int32 arithmetic of the reference computes them:
    reduced mod 2**32 into [-2**31, 2**31) (two's complement wrap)."""
    x = torch.remainder(x, 2**32)
    return torch.where(x >= 2**31, x - 2**32, x)


def loss_fn(model: BERT4Rec, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Cloze training with deterministic in-batch masking derived from the
    ids (stateless, as the reference: ``(id · 48271 + 97) mod 1000 <
    mask_prob · 1000`` on valid positions, the masked ids replaced by
    [MASK] = 1), then a sampled softmax of each masked position's hidden
    state over its own item and ``N_NEGATIVES`` shared negatives
    ``(id · 40503 + 7) mod vocab`` of the first flattened ids; the mean
    over masked positions.  The id arithmetic wraps as the reference's
    int32 does."""
    cfg = model.cfg
    ids, mask = batch["hist_ids"].long(), batch["hist_mask"]
    b, t = ids.shape
    h = torch.remainder(_int32_wrapped(ids * 48271 + 97), 1000)
    cloze = (h < int(cfg.mask_prob * 1000)) & (mask > 0)
    masked_ids = torch.where(cloze, torch.ones_like(ids), ids)  # [MASK] = 1
    hidden = model.encode(masked_ids, mask)  # (B, T, e)
    flat_h = hidden.reshape(b * t, -1)
    flat_ids = ids.reshape(b * t)
    flat_cloze = cloze.reshape(b * t)
    neg_ids = torch.remainder(_int32_wrapped(flat_ids[:N_NEGATIVES] * 40503 + 7), cfg.vocab)
    neg = lookup(model.item_embed, neg_ids, cfg.adtype)  # (n_neg, e)
    pos = lookup(model.item_embed, flat_ids, cfg.adtype)  # (BT, e)
    gold = torch.einsum("ne,ne->n", flat_h, pos).float()  # (BT,)
    neg_logits = (flat_h @ neg.T).float()  # (BT, n_neg)
    lse = torch.logsumexp(torch.cat([gold[:, None], neg_logits], dim=-1), dim=-1)
    per_tok = (lse - gold) * flat_cloze.float()
    return per_tok.sum() / torch.clamp(flat_cloze.float().sum(), min=1.0)


def init(cfg: BERT4RecConfig, generator: torch.Generator, device=None) -> BERT4Rec:
    """Random weights as the JAX ``init`` draws them (from ``generator``,
    which lives on the device; not the same numbers): the item table ~
    N(0, 1) · 0.05, positions ~ N(0, 1) · 0.02, dense kernels ~ N(0, 1)
    · d_in^-1/2, norm scales 0.  ``device`` defaults to ``cuda`` and
    raises without a GPU."""
    dev = resolve_device(device)
    model = BERT4Rec(cfg, dev)
    model.item_embed.copy_(embedding_init(generator, cfg.vocab, cfg.embed_dim, dev))
    model.pos_embed.copy_(
        torch.randn((cfg.seq_len, cfg.embed_dim), generator=generator, device=dev) * 0.02)
    for module in model.modules():
        if isinstance(module, L.Dense):
            module.reset(generator)
    return model
