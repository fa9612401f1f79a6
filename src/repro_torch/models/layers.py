"""Building blocks of the LM family on PyTorch: the port of
``repro.models.layers`` for dense GQA transformers.

Conventions, as in the JAX package:

  * dense kernels are (d_in, d_out) and applied as ``x @ kernel``;
  * attention is GQA-general: n_q heads grouped over n_kv heads, optional
    QKV bias (Qwen), optional sliding window (gemma3 local layers),
    optional per-head QK-norm (gemma3);
  * decode uses an explicit KV cache.

How the port differs:

  * weights are stored in the dtype in which the JAX code uses them
    (dense kernels, biases and the embedding in the activation dtype, norm
    scales in float32): the JAX code casts float32 parameters on every
    call, which computes the same and takes twice the memory;
  * attention, cached or not, computes through
    :func:`repro_torch.kernels.flash_attention.ops.flash_attention` (the
    CUDA kernel on the card).  The (B, L, H, D) tensors go in as
    (B, H, L, D) views, so nothing is transposed in memory;
  * the KV cache is updated in place, and its ``length`` is a Python int,
    so slicing the valid prefix needs no device sync;
  * the int8 KV cache (``kv_quant``), the mesh split-K decode and MoE are
    not ported yet: asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention

__all__ = [
    "MLP",
    "Dense",
    "GQAAttention",
    "KVCache",
    "attention",
    "cache_read",
    "cache_update",
    "frozen_param",
    "rms_norm",
    "rope",
]

def frozen_param(shape, dtype, device) -> nn.Parameter:
    """A serving weight: no gradient is taken through it."""
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device), requires_grad=False)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


class Dense(nn.Module):
    """``x @ kernel (+ bias)``, kernel (d_in, d_out) as in the JAX package."""

    def __init__(self, d_in: int, d_out: int, bias: bool, dtype, device):
        super().__init__()
        self.kernel = frozen_param((d_in, d_out), dtype, device)
        self.bias = frozen_param((d_out,), dtype, device) if bias else None

    def reset(self, generator: torch.Generator) -> None:
        """``dense_init``: kernel ~ N(0, 1) · d_in^-1/2 (drawn in float32),
        bias 0."""
        d_in = self.kernel.shape[0]
        w = torch.randn(self.kernel.shape, generator=generator, device=self.kernel.device)
        self.kernel.copy_(w * d_in**-0.5)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """x (..., L, H, D) rotated by per-position angle; positions (..., L)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq  # (..., L, half)
    cos = torch.cos(ang)[..., None, :]  # (..., L, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention(
    q: torch.Tensor,  # (B, Lq, Hq, D)
    k: torch.Tensor,  # (B, Lk, Hkv, D)
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """GQA attention with queries aligned to the end of the keys; returns
    (B, Lq, Hq, D).  The JAX package's ``q_chunk`` query tiling is the
    kernel's own tiling here, so there is no such argument."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=causal, window=window)
    return out.transpose(1, 2)


@dataclasses.dataclass
class KVCache:
    """Decode cache: ``k``/``v`` (B, L_max, Hkv, D) (a leading layer axis
    when stacked), ``length`` the valid prefix, a Python int."""

    k: torch.Tensor
    v: torch.Tensor
    length: int = 0


def cache_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """Write (B, Ln, Hkv, D) at ``cache.length`` in place and advance it."""
    pos, ln = cache.length, k_new.shape[1]
    if pos + ln > cache.k.shape[1]:
        raise ValueError(f"KV cache of {cache.k.shape[1]} positions is full at {pos} + {ln}")
    cache.k[:, pos:pos + ln] = k_new
    cache.v[:, pos:pos + ln] = v_new
    cache.length = pos + ln


def cache_read(cache: KVCache) -> Tuple[torch.Tensor, torch.Tensor]:
    """Views of the cache's valid prefix.  (The cache holds the activation
    dtype; the JAX ``cache_read`` casts because of the int8 cache.)"""
    n = cache.length
    return cache.k[:, :n], cache.v[:, :n]


class GQAAttention(nn.Module):
    """``gqa_attention_init`` / ``gqa_attention_apply``: q, k, v, o dense
    layers, optional QK-norm, RoPE, causal attention with a window."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
                 rope_theta: float, qkv_bias: bool, qk_norm: bool, dtype, device):
        super().__init__()
        self.n_heads, self.n_kv_heads, self.head_dim = n_heads, n_kv_heads, head_dim
        self.rope_theta = rope_theta
        self.q = Dense(d_model, n_heads * head_dim, qkv_bias, dtype, device)
        self.k = Dense(d_model, n_kv_heads * head_dim, qkv_bias, dtype, device)
        self.v = Dense(d_model, n_kv_heads * head_dim, qkv_bias, dtype, device)
        self.o = Dense(n_heads * head_dim, d_model, False, dtype, device)
        self.q_norm = frozen_param((head_dim,), torch.float32, device) if qk_norm else None
        self.k_norm = frozen_param((head_dim,), torch.float32, device) if qk_norm else None

    def forward(self, x: torch.Tensor, positions: torch.Tensor, window: int,
                cache: Optional[KVCache] = None) -> torch.Tensor:
        """(B, L, d_model) output; with ``cache``, this layer's keys and
        values are written into it first."""
        b, l, _ = x.shape
        q = self.q(x).reshape(b, l, self.n_heads, self.head_dim)
        k = self.k(x).reshape(b, l, self.n_kv_heads, self.head_dim)
        v = self.v(x).reshape(b, l, self.n_kv_heads, self.head_dim)
        if self.q_norm is not None:
            q = rms_norm(q, self.q_norm)
            k = rms_norm(k, self.k_norm)
        q = rope(q, positions, self.rope_theta)
        k = rope(k, positions, self.rope_theta)
        if cache is not None:
            # The JAX package's ``_cached_attention`` masks the whole cache
            # buffer by absolute position (key j visible to the query at p
            # iff j <= p and j > p - window).  The queries sit at the last
            # l positions of the valid prefix, so over that prefix this is
            # causal attention with queries aligned to the end of the keys.
            cache_update(cache, k, v)
            k, v = cache_read(cache)
        out = attention(q, k, v, causal=True, window=window)
        return self.o(out.reshape(b, l, self.n_heads * self.head_dim))


class MLP(nn.Module):
    """``mlp_init`` / ``mlp_apply``: a gated MLP, SwiGLU (``act="silu"``)
    or GeGLU (``act="gelu"``, the tanh approximation that ``jax.nn.gelu``
    computes by default)."""

    def __init__(self, d_model: int, d_ff: int, act: str, dtype, device):
        super().__init__()
        if act not in ("silu", "gelu"):
            raise ValueError(f"unknown activation {act!r}")
        self.act = act
        self.up = Dense(d_model, d_ff, False, dtype, device)
        self.down = Dense(d_ff, d_model, False, dtype, device)
        self.gate = Dense(d_model, d_ff, False, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.gate(x)
        g = F.silu(g) if self.act == "silu" else F.gelu(g, approximate="tanh")
        return self.down(g * self.up(x))
