"""Building blocks of the LM family on PyTorch: the port of
``repro.models.layers`` for dense GQA transformers and MoE (BERT4Rec's
encoder takes its attention, non-causal, and its ungated MLP).

Conventions, as in the JAX package:

  * dense kernels are (d_in, d_out) and applied as ``x @ kernel``;
  * attention is GQA-general: n_q heads grouped over n_kv heads, optional
    QKV bias (Qwen), optional sliding window (gemma3 local layers),
    optional per-head QK-norm (gemma3);
  * decode uses an explicit KV cache, optionally int8 with per
    (position, head) scales (``kv_quant``);
  * MoE is top-k routing with a capacity-bounded, sort-based dispatch.

How the port differs:

  * weights are stored in the dtype in which the JAX code uses them
    (dense kernels, biases and the embedding in the activation dtype, norm
    scales in float32): the JAX code casts float32 parameters on every
    call, which computes the same and takes twice the memory;
  * attention, cached or not, computes through
    :func:`repro_torch.kernels.flash_attention.ops.flash_attention` (the
    CUDA kernel on the card; in training, its hand-written backward).  The (B, L, H, D) tensors go in as
    (B, H, L, D) views, so nothing is transposed in memory;
  * the KV cache is updated in place, and its ``length`` is a Python int,
    so slicing the valid prefix needs no device sync;
  * an int8 cache is dequantized only over the keys some query of the
    call can see (the valid prefix, or a local layer's last
    ``window + Lq - 1`` positions), the same function as the JAX
    package's masked read of the whole buffer;
  * under an ambient mesh with a ``model`` axis of 2 or more
    (:func:`repro_torch.dist.sharding.set_mesh`, a ``SlotMesh``), a
    one-token decode splits the cache's sequence over the slots
    (:func:`_flash_decode`: per shard a launch of the decode variant's
    split kernel over the keys the query sees, then one combine over
    every shard's partials) and MoE runs expert-parallel
    (:func:`_moe_apply_sharded`: each slot its own experts, its outputs
    summed).  The reference's ``shard_map`` collectives become a
    concatenation and a sum on the first slot's device.  The cache stays
    one tensor, each shard a view of it, so the slots of a mesh decode
    share the cache's device (a mesh over several cards would hold each
    shard on its slot's device; not done yet).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.sharding import CacheShard, axes_size, batch_axes, get_active_mesh
from repro_torch.kernels.flash_attention.ops import (flash_attention, flash_decode_combine,
                                                     flash_decode_partials)

__all__ = [
    "MLP",
    "MoE",
    "Routing",
    "Dense",
    "ExpertShard",
    "GQAAttention",
    "KVCache",
    "attention",
    "cache_read",
    "cache_update",
    "frozen_param",
    "moe_apply",
    "rms_norm",
    "rope",
    "top_k_routing",
]

def frozen_param(shape, dtype, device) -> nn.Parameter:
    """A weight, frozen for serving (no gradient is taken through it);
    ``model.requires_grad_(True)`` makes a model's weights trainable."""
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
    when stacked), in the activation dtype or int8; an int8 cache keeps
    float32 scales ``k_scale``/``v_scale`` (B, L_max, Hkv), else None.
    ``length`` is the valid prefix, a Python int."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    length: int = 0


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, L, H) symmetric int8 of x (B, L, H, D): codes and float32
    scales, ``scale = max(amax / 127, 1e-8)``, codes rounded half to
    even and clipped to +-127."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def cache_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """Write (B, Ln, Hkv, D) at ``cache.length`` in place (int8 codes and
    their scales for an int8 cache) and advance it."""
    pos, ln = cache.length, k_new.shape[1]
    if pos + ln > cache.k.shape[1]:
        raise ValueError(f"KV cache of {cache.k.shape[1]} positions is full at {pos} + {ln}")
    if cache.k_scale is not None:
        (k_new, ks), (v_new, vs) = _quantize(k_new), _quantize(v_new)
        cache.k_scale[:, pos:pos + ln] = ks
        cache.v_scale[:, pos:pos + ln] = vs
    cache.k[:, pos:pos + ln] = k_new
    cache.v[:, pos:pos + ln] = v_new
    cache.length = pos + ln


def cache_read(cache: KVCache, dtype: torch.dtype,
               start: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keys and values of positions ``start`` … ``length - 1`` in
    ``dtype``: views of an activation-dtype cache, dequantized copies of
    an int8 one."""
    n = cache.length
    if cache.k_scale is not None:
        return (_dequantize(cache.k[:, start:n], cache.k_scale[:, start:n], dtype),
                _dequantize(cache.v[:, start:n], cache.v_scale[:, start:n], dtype))
    return cache.k[:, start:n].to(dtype), cache.v[:, start:n].to(dtype)


class GQAAttention(nn.Module):
    """``gqa_attention_init`` / ``gqa_attention_apply``: q, k, v, o dense
    layers, optional QK-norm, RoPE, attention with an optional window,
    causal (the LM path) or not (BERT4Rec's bidirectional encoder)."""

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

    def forward(self, x: torch.Tensor, positions: torch.Tensor, window: Optional[int],
                cache: Optional[KVCache] = None, causal: bool = True) -> torch.Tensor:
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
        if cache is not None and l == 1 and _flash_decode_applicable(cache, b):
            out = _flash_decode(q, k, v, cache, window)
            return self.o(out.reshape(b, l, self.n_heads * self.head_dim))
        if cache is not None:
            # The JAX package's ``_cached_attention`` masks the whole cache
            # buffer by absolute position (key j visible to the query at p
            # iff j <= p and j > p - window).  The queries sit at the last
            # l positions of the valid prefix, so over that prefix this is
            # causal attention with queries aligned to the end of the keys.
            # As in the JAX package the new keys and values are written
            # first, so an int8 cache's queries attend to the dequantized
            # codes, the prompt's own at prefill too.  An int8 cache is
            # dequantized from the first key a query sees (at a local
            # layer the last ``window + l - 1`` positions); the bf16 cache
            # hands the kernel a view of the whole prefix, whose keys out
            # of the window the kernel skips itself.
            cache_update(cache, k, v)
            start = 0
            if cache.k_scale is not None:
                start = max(0, cache.length - l - window + 1)
            k, v = cache_read(cache, x.dtype, start)
        out = attention(q, k, v, causal=causal, window=window)
        return self.o(out.reshape(b, l, self.n_heads * self.head_dim))


def _flash_decode_applicable(cache: KVCache, batch: int) -> bool:
    """The split-K mesh decode applies under an ambient mesh whose
    ``model`` axis has 2 slots or more and divides the cache's sequence
    (and the data axes divide the batch, or the batch is 1 and every axis
    together divides the sequence): the reference's rule."""
    mesh = get_active_mesh()
    if mesh is None or "model" not in mesh.axis_names or mesh.shape["model"] < 2:
        return False
    s_len = cache.k.shape[1]
    dp_size = axes_size(mesh, batch_axes(mesh))
    if batch % dp_size == 0:
        return s_len % mesh.shape["model"] == 0
    if batch == 1:
        return s_len % (mesh.shape["model"] * dp_size) == 0
    return False


def decode_shards(mesh, batch: int, seq_len: int) -> list:
    """The mesh decode's sequence shards, one :class:`CacheShard` a slot
    in slot order: with the batch divisible by the data axes, slot (d, m)
    holds data block d's rows and the m-th of ``model`` position ranges;
    with batch 1, the slots split the positions over every axis,
    row-major (the reference's ``axis_index`` sum)."""
    dp_size, model = axes_size(mesh, batch_axes(mesh)), int(mesh.shape["model"])
    out = []
    for flat, slot in enumerate(mesh):  # row-major: model is the fastest axis
        if batch % dp_size == 0:
            (d, m), rows, span = divmod(flat, model), batch // dp_size, seq_len // model
            out.append(CacheShard(slot, d * rows, (d + 1) * rows, m * span, (m + 1) * span))
        else:
            span = seq_len // (model * dp_size)
            out.append(CacheShard(slot, 0, 1, flat * span, (flat + 1) * span))
    return out


def _flash_decode(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor, cache: KVCache,
                  window: Optional[int]) -> torch.Tensor:
    """Split-K single-token decode over the ambient mesh's sequence
    shards (:func:`decode_shards`): q (B, 1, H, D), k_new and v_new
    (B, 1, Hkv, D) → (B, 1, H, D); the cache is written in place and its
    ``length`` advanced.

    Per shard, in the reference's order: (a) the new keys and values are
    written iff ``length`` falls in the shard (an int8 cache's codes and
    scales by :func:`_quantize`); (b) the decode variant's split kernel
    (``flash_decode_partials``) runs over the shard's keys that the query
    sees, ``max(start, length - window + 1)`` … ``min(end, length + 1)``
    (an int8 shard dequantized over just those), and a shard with none
    launches nothing; (c) the shards' fp32 partials (max, sum,
    accumulator) are concatenated on the first slot's device in shard
    order and merged by one combine (:func:`_merge_partials`):
    ``m = max m_i``, ``l = Σ l_i e^{m_i − m}``,
    ``out = Σ acc_i e^{m_i − m} / l``, the reference's ``pmax``/``psum``."""
    mesh = get_active_mesh()
    b, _, h, d = q.shape
    s_len, hkv = cache.k.shape[1], cache.k.shape[2]
    length = cache.length
    if length >= s_len:
        raise ValueError(f"KV cache of {s_len} positions is full at {length} + 1")
    quantized = cache.k_scale is not None
    if quantized:
        (k_new, k_sc), (v_new, v_sc) = _quantize(k_new), _quantize(v_new)
    parts = []
    for shard in decode_shards(mesh, b, s_len):
        if shard.slot.device != cache.k.device:
            raise ValueError(f"the mesh decode keeps the cache on one device: slot "
                             f"{shard.slot.id} is on {shard.slot.device}, the cache on "
                             f"{cache.k.device}")
        rows = slice(shard.row0, shard.row1)
        if shard.pos0 <= length < shard.pos1:  # (a)
            cache.k[rows, length] = k_new[rows, 0]
            cache.v[rows, length] = v_new[rows, 0]
            if quantized:
                cache.k_scale[rows, length] = k_sc[rows, 0]
                cache.v_scale[rows, length] = v_sc[rows, 0]
        lo = max(shard.pos0, length - window + 1) if window is not None else shard.pos0
        hi = min(shard.pos1, length + 1)
        if hi <= lo:  # (b): no key of this shard is visible
            continue
        if quantized:
            k = _dequantize(cache.k[rows, lo:hi], cache.k_scale[rows, lo:hi], q.dtype)
            v = _dequantize(cache.v[rows, lo:hi], cache.v_scale[rows, lo:hi], q.dtype)
        else:
            k, v = cache.k[rows, lo:hi].to(q.dtype), cache.v[rows, lo:hi].to(q.dtype)
        ml, acc = flash_decode_partials(q[rows].transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2))
        parts.append((shard.row0, ml, acc))
    cache.length = length + 1
    out = _merge_partials(parts, (b, h, hkv, d), q.dtype, mesh[0].device)
    return out.transpose(1, 2)


def _merge_partials(parts, dims, dtype: torch.dtype, device) -> torch.Tensor:
    """(c) of :func:`_flash_decode`: ``parts`` (first row, ml, acc) in
    shard order; each row block's shards concatenated along the split
    axis, the row blocks along the (batch, KV head) axis, on ``device``,
    and merged by one combine into (B, H, 1, D)."""
    b, h, hkv, d = dims
    blocks = {}
    for row0, ml, acc in parts:
        blocks.setdefault(row0, []).append((ml.to(device), acc.to(device)))
    ml = torch.cat([torch.cat([m for m, _ in blocks[r]], dim=1) for r in sorted(blocks)])
    acc = torch.cat([torch.cat([a for _, a in blocks[r]], dim=1) for r in sorted(blocks)])
    return flash_decode_combine(ml, acc, (b, h, hkv, 1, d), dtype)


def _activate(g: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU's ``silu`` or GeGLU's ``gelu`` (the tanh approximation that
    ``jax.nn.gelu`` computes by default)."""
    return F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")


class MLP(nn.Module):
    """``mlp_init`` / ``mlp_apply``: a gated MLP, SwiGLU (``act="silu"``)
    or GeGLU (``act="gelu"``), or with ``gated=False`` the plain
    ``down(act(up(x)))`` (BERT4Rec's feed-forward)."""

    def __init__(self, d_model: int, d_ff: int, act: str, dtype, device, gated: bool = True):
        super().__init__()
        if act not in ("silu", "gelu"):
            raise ValueError(f"unknown activation {act!r}")
        self.act = act
        self.up = Dense(d_model, d_ff, False, dtype, device)
        self.down = Dense(d_ff, d_model, False, dtype, device)
        self.gate = Dense(d_model, d_ff, False, dtype, device) if gated else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gate is None:
            return self.down(_activate(self.up(x), self.act))
        return self.down(_activate(self.gate(x), self.act) * self.up(x))


class MoE(nn.Module):
    """``moe_init`` / ``moe_apply``: a router (a :class:`Dense` d_model →
    n_experts) and gated experts, ``up`` and ``gate`` (E, d_model,
    d_expert) and ``down`` (E, d_expert, d_model), in the activation
    dtype.  ``routing`` holds the last call's :class:`Routing` (device
    tensors: the serving launcher counts the dropped slots from it).
    Under a mesh, :meth:`slot_experts` places each model slot's experts
    on its slot's device."""

    def __init__(self, d_model: int, d_expert: int, n_experts: int, top_k: int,
                 capacity_factor: float, act: str, dtype, device):
        super().__init__()
        if act not in ("silu", "gelu"):
            raise ValueError(f"unknown activation {act!r}")
        if not 1 <= top_k <= n_experts:
            raise ValueError(f"top_k={top_k} outside [1, n_experts={n_experts}]")
        self.top_k, self.capacity_factor, self.act = top_k, capacity_factor, act
        self.router = Dense(d_model, n_experts, False, dtype, device)
        self.up = frozen_param((n_experts, d_model, d_expert), dtype, device)
        self.gate = frozen_param((n_experts, d_model, d_expert), dtype, device)
        self.down = frozen_param((n_experts, d_expert, d_model), dtype, device)
        self.routing: Optional[Routing] = None
        self._placed = {}

    def reset(self, generator: torch.Generator) -> None:
        """``moe_init``'s experts: ``up`` and ``gate`` ~ N(0, 1) ·
        d_model^-1/2, ``down`` ~ N(0, 1) · d_expert^-1/2, drawn in float32
        one expert at a time (an arctic-480b expert stack in float32 would
        take 17.8 GB).  The router is a :class:`Dense`, reset as one."""
        for w in (self.up, self.gate, self.down):
            scale = w.shape[1] ** -0.5
            for e in range(w.shape[0]):
                w[e].copy_(torch.randn(w.shape[1:], generator=generator, device=w.device) * scale)

    def slot_experts(self, m: int, n_model: int, device: torch.device) -> "ExpertShard":
        """The experts of model slot ``m`` of ``n_model``, ``[m·E/M,
        (m+1)·E/M)``, on ``device``: views of the weights where they lie
        there (one card: nothing moves), else copies placed there at the
        first call and kept."""
        e_loc = self.up.shape[0] // n_model
        sl = slice(m * e_loc, (m + 1) * e_loc)
        if torch.device(device) == self.up.device:
            return ExpertShard(self.up[sl], self.gate[sl], self.down[sl])
        key = (m, n_model, torch.device(device))
        if key not in self._placed:
            self._placed[key] = ExpertShard(*(w[sl].to(device)
                                              for w in (self.up, self.gate, self.down)))
        return self._placed[key]

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (T, d_model) flattened tokens → (out (T, d_model), aux loss)."""
        out, aux, self.routing = moe_apply(self, x, self.top_k, self.capacity_factor, self.act)
        return out, aux


class ExpertShard(NamedTuple):
    """One model slot's experts: ``up``, ``gate`` (E/M, d_model, d_expert)
    and ``down`` (E/M, d_expert, d_model)."""

    up: torch.Tensor
    gate: torch.Tensor
    down: torch.Tensor


class Routing(NamedTuple):
    """Where a call sent its tokens: ``experts`` (T, k) int64, each
    token's experts in descending probability, and ``keep`` (T, k) bool,
    False where that slot was dropped over capacity."""

    experts: torch.Tensor
    keep: torch.Tensor


def top_k_routing(probs: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates, experts), each (T, k): the k largest router probabilities
    in descending order, equal ones in ascending expert order as
    ``jax.lax.top_k`` breaks ties (``torch.topk`` promises no order, a
    stable sort does), and the gates renormalised to sum 1 (the sum held
    at 1e-9 or above)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    return vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9), idx


def _expert_ffn(experts, xe: torch.Tensor, act: str) -> torch.Tensor:
    """The gated MLPs of ``experts`` (a :class:`MoE` or an
    :class:`ExpertShard`) as batched products: xe (E, C, d) → (E, C, d)."""
    h = (_activate(torch.bmm(xe, experts.gate.to(xe.dtype)), act)
         * torch.bmm(xe, experts.up.to(xe.dtype)))
    return torch.bmm(h, experts.down.to(xe.dtype))


def moe_apply(moe: MoE, x: torch.Tensor, top_k: int, capacity_factor: float = 1.25,
              act: str = "silu") -> Tuple[torch.Tensor, torch.Tensor, Routing]:
    """MoE FFN: x (T, d) → (out (T, d), the Switch aux loss (0-dim
    float32), the :class:`Routing`).  Under an ambient mesh whose
    ``model`` axis has 2 slots or more and divides the experts, with the
    data axes dividing the tokens, the expert-parallel
    :func:`_moe_apply_sharded` (the reference's condition); otherwise the
    single-device :func:`_moe_apply_dense`."""
    mesh = get_active_mesh()
    if (mesh is not None and "model" in mesh.axis_names and mesh.shape["model"] > 1
            and moe.up.shape[0] % mesh.shape["model"] == 0
            and x.shape[0] % axes_size(mesh, batch_axes(mesh)) == 0):
        return _moe_apply_sharded(moe, x, top_k, capacity_factor, act, mesh)
    return _moe_apply_dense(moe, x, top_k, capacity_factor, act)


def _combine_slots(ye_flat: torch.Tensor, keep: torch.Tensor, slot: torch.Tensor,
                   order: torch.Tensor, sg: torch.Tensor, t: int, top_k: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """The gated expert outputs added back to their tokens: the JAX
    scatter-add, taken as a sum over each token's k slots in token order
    (``index_add_`` on the card takes atomics, this a fixed order)."""
    n = ye_flat.shape[0]
    contrib = torch.where(keep[:, None], ye_flat[torch.clamp(slot, max=n - 1)] * sg[:, None], 0.0)
    by_token = torch.empty_like(contrib, dtype=dtype)
    by_token[order] = contrib.to(dtype)
    return by_token.view(t, top_k, -1).sum(dim=1)


def _moe_apply_sharded(moe: MoE, x: torch.Tensor, top_k: int, capacity_factor: float,
                       act: str, mesh) -> Tuple[torch.Tensor, torch.Tensor, Routing]:
    """The JAX ``_moe_apply_sharded``: expert parallelism over the mesh's
    ``model`` axis, tokens split over its data axes.

    Per data shard of ``t_loc = T / dp`` tokens the router runs as
    ``x_loc @ router`` (float32 logits, softmax, top-k, renormalised
    gates), once for all of its model slots (the reference computes the
    same on each).  Model slot m owns experts ``[m·E/M, (m+1)·E/M)``
    (:meth:`MoE.slot_experts`): its (token, k) pairs routed elsewhere go to
    the drop group E/M, the pairs are stably sorted by local expert and
    ranked by ``searchsorted``, each expert keeps at most ``capacity =
    max(8, ⌈int(cf·t_loc·k/E) / 8⌉·8)`` of them, the slot's products run on
    its own device and its gated outputs are added back to their tokens.
    The slots' outputs are summed on the data shard's first slot's device
    (:func:`_sum_slots`: the reference's ``psum`` over ``model``).  The aux
    loss is each data shard's, averaged over the data shards."""
    t, d = x.shape
    e = moe.router.kernel.shape[1]
    n_model = int(mesh.shape["model"])
    e_loc = e // n_model
    dp_size = axes_size(mesh, batch_axes(mesh))
    t_loc = t // dp_size
    capacity = max(8, -(-int(capacity_factor * t_loc * top_k / e) // 8) * 8)
    outs, auxes, experts_all, kept_all = [], [], [], []
    for di in range(dp_size):
        x_loc = x[di * t_loc:(di + 1) * t_loc]
        probs = torch.softmax((x_loc @ moe.router.kernel.to(x.dtype)).float(), dim=-1)
        gates, experts = top_k_routing(probs, top_k)
        flat_e = experts.reshape(-1)  # (t_loc * k,), token-major
        ce = torch.zeros(e, device=x.device).index_add_(
            0, flat_e, torch.ones_like(flat_e, dtype=torch.float32)) / (t_loc * top_k)
        auxes.append(e * torch.sum(probs.mean(dim=0) * ce))
        flat_g = gates.reshape(-1)
        kept = torch.zeros_like(flat_e, dtype=torch.bool)
        slot_outs = []
        for m in range(n_model):
            dev = mesh[di * n_model + m].device  # slots row-major, model last
            fe, fg, xs = flat_e.to(dev), flat_g.to(dev), x_loc.to(dev)
            lo = m * e_loc
            local = (fe >= lo) & (fe < lo + e_loc)
            le = torch.where(local, fe - lo, e_loc)  # e_loc: the drop group
            order = torch.sort(le, stable=True).indices
            se, st, sg = le[order], order // top_k, fg[order]
            start = torch.searchsorted(se, torch.arange(e_loc, device=dev), side="left")
            rank = torch.arange(t_loc * top_k, device=dev) - start[torch.clamp(se, max=e_loc - 1)]
            keep = (se < e_loc) & (rank < capacity)
            slot = torch.where(keep, se * capacity + rank, e_loc * capacity)
            buf = xs.new_zeros((e_loc * capacity + 1, d))
            buf[slot] = xs[st]
            ye = _expert_ffn(moe.slot_experts(m, n_model, dev),
                             buf[:e_loc * capacity].view(e_loc, capacity, d), act)
            slot_outs.append(_combine_slots(ye.reshape(e_loc * capacity, d), keep, slot, order,
                                            sg, t_loc, top_k, x.dtype))
            kept_m = torch.empty_like(keep)
            kept_m[order] = keep
            kept |= kept_m.to(x.device)
        outs.append(_sum_slots(slot_outs, mesh[di * n_model].device).to(x.device))
        experts_all.append(experts)
        kept_all.append(kept.view(t_loc, top_k))
    return (torch.cat(outs), sum(auxes) / dp_size,
            Routing(torch.cat(experts_all), torch.cat(kept_all)))


def _sum_slots(outs, device) -> torch.Tensor:
    """The model slots' outputs summed on ``device``, in slot order."""
    total = outs[0].to(device)
    for o in outs[1:]:
        total = total + o.to(device)
    return total


def _moe_apply_dense(moe: MoE, x: torch.Tensor, top_k: int, capacity_factor: float = 1.25,
                     act: str = "silu") -> Tuple[torch.Tensor, torch.Tensor, Routing]:
    """The JAX ``_moe_apply_dense`` (GShard dispatch): x (T, d) →
    (out (T, d), the Switch aux loss (0-dim float32), the
    :class:`Routing`).

    The router runs in the activation dtype and its logits are cast to
    float32; softmax, top-k, renormalised gates.  Each expert takes at
    most ``capacity = int(max(1, cf·T·k/E))`` slots: the (token, k)
    pairs are stably sorted by expert (token-major order within one),
    ranked from ``searchsorted``, and those past capacity go to a scratch
    row and are dropped.  The experts run as batched products over
    (E, C, d), and the gated outputs are added back to their tokens: the
    JAX scatter-add, taken here as a sum over each token's k slots in
    token order, so the card adds in a fixed order (``index_add_`` there
    takes atomics)."""
    t, d = x.shape
    e = moe.router.kernel.shape[1]
    probs = torch.softmax(moe.router(x).float(), dim=-1)  # (T, E)
    gates, experts = top_k_routing(probs, top_k)

    # Load-balancing aux loss (Switch): e * Σ_e fraction_tokens * mean_prob.
    flat_expert = experts.reshape(-1)  # (T*k,), token-major
    ce = torch.zeros(e, device=x.device).index_add_(
        0, flat_expert, torch.ones_like(flat_expert, dtype=torch.float32)) / (t * top_k)
    aux = e * torch.sum(probs.mean(dim=0) * ce)

    capacity = int(max(1, capacity_factor * t * top_k / e))
    order = torch.sort(flat_expert, stable=True).indices  # group by expert
    se, st, sg = flat_expert[order], order // top_k, gates.reshape(-1)[order]
    start = torch.searchsorted(se, torch.arange(e, device=x.device), side="left")
    rank = torch.arange(t * top_k, device=x.device) - start[se]
    keep = rank < capacity
    slot = torch.where(keep, se * capacity + rank, e * capacity)  # drop → scratch

    buf = x.new_zeros((e * capacity + 1, d))
    buf[slot] = x[st]
    ye = _expert_ffn(moe, buf[:e * capacity].view(e, capacity, d), act)
    out = _combine_slots(ye.reshape(e * capacity, d), keep, slot, order, sg, t, top_k, x.dtype)
    kept = torch.empty_like(keep)
    kept[order] = keep
    return out, aux, Routing(experts, kept.view(t, top_k))
