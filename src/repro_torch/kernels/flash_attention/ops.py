"""Public flash-attention wrapper: the (B, H, L, D) API of
``repro.kernels.flash_attention.ops``, GQA-aware, with its gradient.

A tensor that lies on the CPU takes the plain PyTorch version of
:mod:`repro_torch.kernels.flash_attention.ref`; a CUDA tensor launches the
hand-written kernel of :mod:`repro_torch.kernels.flash_attention.kernel`
or raises.  Nothing falls back from the card to the plain version.

When grad mode is on and q, k or v requires a gradient,
:func:`flash_attention` runs as a ``torch.autograd.Function``: its forward
is the call above (the variant ``kernel.flash_route`` picks on the card),
and it saves q, k, v, the output and, where the forward computed it (the
sm90 and resident variants on the card, ``ref.attention_lse_ref`` on the
CPU), each row's log-sum-exp; its backward is :func:`flash_attention_bwd`:
the kernels ``kernel.bwd_route`` picks on the card (the fp32 resident
backward of ``csrc/flash_attention_bwd_resident.cu`` in one kernel, the
bf16 tensor-core pair of ``csrc/flash_attention_bwd_sm90.cu``, dQ
computing delta then dK/dV, or prep and the general pair of
``csrc/flash_attention_bwd.cu``),
``ref.attention_bwd_ref`` on the CPU.  The JAX package differentiates its jnp attention with XLA;
its Pallas kernel has no backward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.kernel import (_bwd_route_of, _misaligned, combine_cuda,
                                                        decode_partials_cuda, decode_plan,
                                                        flash_attention_bwd_cuda,
                                                        flash_attention_cuda,
                                                        flash_attention_lse_cuda, sm_count)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref, attention_lse_ref,
                                                     attention_ref, combine_ref,
                                                     decode_partials_ref)

__all__ = ["flash_attention", "flash_attention_bwd", "flash_decode_combine",
           "flash_decode_partials"]


def flash_attention(
    q: torch.Tensor,  # (B, H, Lq, D)
    k: torch.Tensor,  # (B, Hkv, Lk, D)
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    tile_q: int = 128,
    tile_k: int = 128,
) -> torch.Tensor:
    """``tile_q`` and ``tile_k`` keep the JAX signature; neither version
    reads them (the CUDA kernel picks its own tiles and masks ragged
    edges, so no length needs to be a tile multiple).  Differentiable
    (the module's docstring)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window)


def _forward(q, k, v, causal, window):
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return attention_ref(q, k, v, causal=causal, window=window)


def flash_attention_bwd(q, k, v, out, dout, causal: bool = True,
                        window: Optional[int] = None, lse: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of :func:`flash_attention` at output ``out`` for the
    output gradient ``dout``, given the forward's log-sum-exp ``lse``
    where it saved one: the backward kernels on the card, the plain
    recompute on the CPU.  On the card ``out`` and ``dout`` are made
    contiguous when their last dimension is not dense, or when the bf16
    tensor-core route or the resident route would get a base or stride
    its TMA, cp.async or 16-byte loads cannot take."""
    if q.is_cuda:
        route = _bwd_route_of(q, k, causal, window)
        itemsize = {"sm90": 2, "resident": 4}.get(route)

        def dense(t):
            if (t.stride(3) != 1 and t.shape[3] > 1) or itemsize and (
                    0 in t.stride()[:3]
                    or _misaligned(route, t.shape, t.stride(), itemsize, t.data_ptr())):
                return t.contiguous()
            return t

        return flash_attention_bwd_cuda(q, k, v, dense(out), dense(dout), causal=causal,
                                        window=window, lse=lse)
    return attention_bwd_ref(q, k, v, out, dout, causal=causal, window=window, lse=lse)


class _FlashAttention(torch.autograd.Function):
    """The attention with its hand-written backward: the forward saves q,
    k, v, its output and each row's log-sum-exp where it computed one, the
    backward recomputes P from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if q.is_cuda:
            out, lse = flash_attention_lse_cuda(q, k, v, causal=causal, window=window)
        else:
            out, lse = attention_lse_ref(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, ctx.causal, ctx.window, lse)
        return dq, dk, dv, None, None


def flash_decode_partials(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode variant's split kernel over keys that the one query of
    each row sees whole (q (B, H, 1, D), k and v (B, Hkv, Lk, D), Lk >= 1):
    the fp32 ``ml`` (B·Hkv, n_splits, H/Hkv, 2) and ``acc``
    (B·Hkv, n_splits, H/Hkv, D) of ``kernel.decode_partials_cuda``, split
    by ``kernel.decode_plan`` for the card's SM count (one SM on the CPU,
    where the plain version takes any plan)."""
    b, hkv, lk = k.shape[0], k.shape[1], k.shape[2]
    if q.is_cuda:
        plan = decode_plan(1, lk, None, b * hkv, sm_count(q.device.index))
        return decode_partials_cuda(q, k, v, True, None, plan)
    return decode_partials_ref(q, k, v, True, None, decode_plan(1, lk, None, b * hkv, 1))


def flash_decode_combine(ml: torch.Tensor, acc: torch.Tensor, dims, dtype) -> torch.Tensor:
    """The decode variant's combine of the splits in ``ml``/``acc``
    (split order) into a new (B, H, Lq, D) tensor in ``dtype``; ``dims``
    is (B, H, Hkv, Lq, D)."""
    b, h, hkv, lq, d = dims
    if ml.is_cuda:
        out = torch.empty((b, h, lq, d), dtype=dtype, device=ml.device)
        combine_cuda(ml, acc, out, hkv)
        return out
    return combine_ref(ml, acc, b, h, hkv, lq, dtype)
