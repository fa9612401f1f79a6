"""The LM family on PyTorch: the port of ``repro.models.transformer`` for
dense GQA transformers (Qwen1.5), the hybrid local:global ones (gemma3)
and MoE (Qwen3-MoE; Arctic's dense FFN beside its MoE), serving path
only.

The JAX package stacks the layers and runs them with ``lax.scan``; here
the model is an ``nn.Module`` tree (:class:`LM` holding one
:class:`Block` per layer) and the layers run in a Python loop, each with
its window from :meth:`LMConfig.layer_windows` (0, a global layer, runs
with window ``2**30`` as in the JAX ``_block``).  :func:`init` draws from
the same distributions as the JAX ``init``, from an explicit
``torch.Generator``, but not the same numbers;
:func:`repro_torch.models.convert.params_from_numpy` carries a JAX
parameter tree across.

Training: ``model.requires_grad_(True)`` makes the weights trainable
(they are frozen for serving), and :func:`loss_fn` is the reference's
next-token cross-entropy over sequence chunks of ``loss_chunk`` positions
(the (B, S, V) logits never exist: each chunk's logits are recomputed in
the backward, ``torch.utils.checkpoint``), plus the MoE aux loss.  With
``remat`` other than ``"none"`` each block is checkpointed whole
(``"dots"`` too: the reference saves its dot products there); the
reference's nested per-query-chunk remat of the attention is not needed,
since the attention kernel keeps no score tensor.  Attention's gradient
is the backward of :func:`repro_torch.kernels.flash_attention.ops.
flash_attention` (hand-written kernels on the card).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device_engine import resolve_device
from repro_torch.models import layers as L

__all__ = ["LM", "Block", "LMConfig", "MoESpec", "decode_step", "forward", "init",
           "init_cache", "loss_fn", "prefill"]

# The window a global layer runs with (the JAX ``_block``).
GLOBAL_WINDOW = 2**30


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_expert: int
    capacity_factor: float = 1.25
    dense_residual: bool = False  # Arctic: dense FFN in parallel with MoE
    aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: Optional[int] = None  # sliding window for local layers
    global_every: Optional[int] = None  # every Nth layer is global (gemma3: 6)
    moe: Optional[MoESpec] = None
    act: str = "silu"
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "none"  # none | full | dots
    kv_quant: bool = False  # int8 KV cache for long-context serving
    loss_chunk: int = 512  # sequence chunk for the fused CE
    attn_q_chunk: int | None = None  # flash-style query tiling (memory)
    scan_unroll: int = 1  # layer-scan unroll (dry-run probes set = n_layers)

    @property
    def adtype(self) -> torch.dtype:
        """The activation dtype, which dense kernels and the embedding are
        stored in."""
        return getattr(torch, self.dtype)

    def layer_windows(self) -> List[int]:
        """Per-layer attention window; 0 = global (no window)."""
        if self.window is None:
            return [0] * self.n_layers
        every = self.global_every
        return [0 if every and (i + 1) % every == 0 else self.window
                for i in range(self.n_layers)]

    def n_params(self) -> int:
        """Total parameter count (for 6·N·D model FLOPs)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
        attn += self.n_heads * self.head_dim * d
        if self.moe is not None:
            ff = self.moe.n_experts * 3 * d * self.moe.d_expert + d * self.moe.n_experts
            if self.moe.dense_residual:
                ff += 3 * d * f
        else:
            ff = 3 * d * f
        per_layer = attn + ff + 2 * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if self.moe is None:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
        attn += self.n_heads * self.head_dim * d
        ff = self.moe.top_k * 3 * d * self.moe.d_expert + d * self.moe.n_experts
        if self.moe.dense_residual:
            ff += 3 * d * f
        per_layer = attn + ff + 2 * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d


class Block(nn.Module):
    """One transformer block (the JAX ``_block``): pre-norm attention and
    a pre-norm feed-forward, each with a residual.  The feed-forward is
    the MLP, or with ``cfg.moe`` the MoE, plus the MLP beside it when
    ``dense_residual`` is set (Arctic)."""

    def __init__(self, cfg: LMConfig, window: int, device):
        super().__init__()
        dtype = cfg.adtype
        self.window = window if window > 0 else GLOBAL_WINDOW
        self.attn_norm = L.frozen_param((cfg.d_model,), torch.float32, device)
        self.attn = L.GQAAttention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                   cfg.rope_theta, cfg.qkv_bias, cfg.qk_norm, dtype, device)
        self.ffn_norm = L.frozen_param((cfg.d_model,), torch.float32, device)
        moe = cfg.moe
        self.moe = None if moe is None else L.MoE(
            cfg.d_model, moe.d_expert, moe.n_experts, moe.top_k, moe.capacity_factor, cfg.act,
            dtype, device)
        self.mlp = (L.MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype, device)
                    if moe is None or moe.dense_residual else None)

    def forward(self, x, positions, cache: Optional[L.KVCache] = None):
        """(x after the block, the MoE aux loss or None)."""
        x = x + self.attn(L.rms_norm(x, self.attn_norm), positions, self.window, cache)
        xin = L.rms_norm(x, self.ffn_norm)
        if self.moe is None:
            return x + self.mlp(xin), None
        b, s, d = xin.shape
        y, aux = self.moe(xin.reshape(b * s, d))
        y = y.reshape(b, s, d)
        if self.mlp is not None:
            y = y + self.mlp(xin)
        return x + y, aux


class LM(nn.Module):
    """The whole model: embedding, one :class:`Block` per layer, final
    norm, and a head tied to the embedding unless ``lm_head`` is set.
    Its weights are zeros until :func:`init` or ``params_from_numpy``
    fills them."""

    def __init__(self, cfg: LMConfig, device):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.adtype
        self.embed = L.frozen_param((cfg.vocab, cfg.d_model), dtype, device)
        self.blocks = nn.ModuleList(Block(cfg, w, device) for w in cfg.layer_windows())
        self.final_norm = L.frozen_param((cfg.d_model,), torch.float32, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else L.frozen_param((cfg.d_model, cfg.vocab), dtype, device))

    def head(self) -> torch.Tensor:
        """(d_model, vocab) output projection."""
        return self.embed.T if self.lm_head is None else self.lm_head

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens.long()] * (self.cfg.d_model**0.5)


def init(cfg: LMConfig, generator: torch.Generator, device=None) -> LM:
    """Random weights as the JAX ``init`` draws them: embedding and head
    ~ N(0, 1) · d_model^-1/2, dense kernels (the routers too) ~ N(0, 1) ·
    d_in^-1/2, experts as ``moe_init`` draws them (:meth:`MoE.reset`),
    biases and norm scales 0.  ``device`` defaults to ``cuda`` and raises
    without a GPU; ``generator`` must live on that device."""
    dev = resolve_device(device)
    model = LM(cfg, dev)
    scale = cfg.d_model**-0.5
    for w in (model.embed, model.lm_head):
        if w is not None:
            w.copy_(torch.randn(w.shape, generator=generator, device=dev) * scale)
    for module in model.modules():
        if isinstance(module, (L.Dense, L.MoE)):
            module.reset(generator)
    return model


def forward(model: LM, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None):
    """(hidden states (B, S, d) after the final norm, the MoE aux loss
    summed over the layers: a float32 0-dim tensor, 0 without MoE)."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = model.embed_tokens(tokens)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    remat = model.cfg.remat != "none" and torch.is_grad_enabled()
    for blk in model.blocks:
        if remat:
            x, a = checkpoint(blk, x, positions, use_reentrant=False)
        else:
            x, a = blk(x, positions)
        if a is not None:
            aux = aux + a
    return L.rms_norm(x, model.final_norm), aux


def _chunk_loss(hc: torch.Tensor, head: torch.Tensor, tc: torch.Tensor) -> torch.Tensor:
    """Σ (logsumexp − gold logit) over one chunk: hc (B, chunk, d), tc
    (B, chunk); the logits (B, chunk, V) in float32."""
    logits = (hc @ head).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tc.long()[..., None])[..., 0]
    return (lse - gold).sum()


def loss_fn(model: LM, batch) -> torch.Tensor:
    """Next-token CE with sequence-chunked logits (never materializes
    (B, S, V)), MoE aux loss folded in: a float32 0-dim tensor.  ``batch``
    holds ``tokens`` and ``targets`` (B, S).  Positions past the last
    whole chunk are left out, as in the reference."""
    cfg = model.cfg
    tokens, targets = batch["tokens"], batch["targets"]
    h, aux = forward(model, tokens)
    head = model.head()  # (d, V)
    b, s, _ = h.shape
    chunk = min(cfg.loss_chunk, s)
    n_chunks = s // chunk
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        hc, tc = h[:, c * chunk:(c + 1) * chunk], targets[:, c * chunk:(c + 1) * chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_loss, hc, head, tc, use_reentrant=False)
        else:
            total = total + _chunk_loss(hc, head, tc)
    loss = total / (b * n_chunks * chunk)
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_weight * aux / cfg.n_layers
    return loss


def init_cache(cfg: LMConfig, batch: int, max_len: int, device=None) -> L.KVCache:
    """Stacked over layers: every field has a leading (n_layers,) axis.
    With ``kv_quant`` the keys and values are int8 codes with float32
    scales (B, max_len, Hkv) initialised to ones, as in the JAX
    package.  ``device`` defaults to ``cuda`` and raises without a GPU."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    store = torch.int8 if cfg.kv_quant else cfg.adtype
    cache = L.KVCache(k=torch.zeros(shape, dtype=store, device=dev),
                      v=torch.zeros(shape, dtype=store, device=dev))
    if cfg.kv_quant:
        cache.k_scale = torch.ones(shape[:-1], dtype=torch.float32, device=dev)
        cache.v_scale = torch.ones(shape[:-1], dtype=torch.float32, device=dev)
    return cache


def _run_cached(model: LM, tokens: torch.Tensor, cache: L.KVCache) -> torch.Tensor:
    """Tokens (B, S) at positions ``cache.length`` … through every layer,
    each writing its keys and values into its slice of the cache in place;
    advances ``cache.length`` and returns the last position's logits
    (B, V) in float32."""
    b, s = tokens.shape
    pos0 = cache.length
    positions = (torch.arange(s, device=tokens.device) + pos0).expand(b, s)
    x = model.embed_tokens(tokens)
    quantized = cache.k_scale is not None
    for i, blk in enumerate(model.blocks):
        layer = L.KVCache(cache.k[i], cache.v[i], cache.k_scale[i] if quantized else None,
                          cache.v_scale[i] if quantized else None, pos0)
        x, _aux = blk(x, positions, layer)
    cache.length = pos0 + s
    x = L.rms_norm(x, model.final_norm)
    return (x[:, -1] @ model.head()).float()


def prefill(model: LM, tokens: torch.Tensor, cache: L.KVCache):
    """Run the prompt through the model, filling the cache.
    Returns (last-position logits (B, V), cache)."""
    return _run_cached(model, tokens, cache), cache


def decode_step(model: LM, tokens: torch.Tensor, cache: L.KVCache):
    """One-token decode: tokens (B, 1) appended at ``cache.length``.
    Returns (logits (B, V), cache)."""
    if tokens.shape[1] != 1:
        raise ValueError(f"decode_step takes (B, 1) tokens, got {tuple(tokens.shape)}")
    return _run_cached(model, tokens, cache), cache
