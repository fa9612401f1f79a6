"""Public flash-attention wrapper: the (B, H, L, D) API of
``repro.kernels.flash_attention.ops``, GQA-aware.

A tensor that lies on the CPU takes the plain PyTorch version of
:mod:`repro_torch.kernels.flash_attention.ref`; a CUDA tensor launches the
hand-written kernel of :mod:`repro_torch.kernels.flash_attention.kernel`
or raises.  Nothing falls back from the card to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention"]


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
    edges, so no length needs to be a tile multiple)."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return attention_ref(q, k, v, causal=causal, window=window)
