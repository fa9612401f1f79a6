"""Launcher of the attention kernel (``csrc/flash_attention.cu``).

The library is built, loaded and counted by
:mod:`repro_torch.kernels.build`.  The launcher checks device, dtype,
shapes and strides, allocates the output with ``torch.empty_like(q)``
(so it keeps q's layout: a (B, H, L, D) view of a (B, L, H, D) buffer
gets a (B, L, H, D) buffer back), launches on
``torch.cuda.current_stream()``, raises when the launch reports a CUDA
error, and adds one to ``LAUNCHES["flash_attention_kernel"]`` per launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import LAUNCHES, check, lib, stream_of

__all__ = ["MAX_HEAD_DIM", "flash_attention_cuda"]

MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """(B, H, Lq, D) attention in q's dtype; the contract of
    :func:`repro_torch.kernels.flash_attention.ref.attention_ref` for
    inputs in which every query row sees at least one key (Lk >= Lq when
    causal, window >= 1)."""
    name = "flash_attention_kernel"
    device = q.device
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: expected float32 or bfloat16, got {q.dtype}")
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name}: every input must be on one CUDA device")
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: q, k and v must share one dtype")
        if t.dim() != 4:
            raise ValueError(f"{name}: q (B, H, Lq, D) and k, v (B, Hkv, Lk, D) expected")
        if t.stride(3) != 1 and t.shape[3] > 1:
            raise ValueError(f"{name}: the last dimension must be dense (stride 1)")
    b, h, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: k and v must be (B, Hkv, Lk, D) with q's B and D")
    if hkv < 1 or h % hkv:
        raise ValueError(f"{name}: Hkv={hkv} must divide H={h}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if b * h > 65535 or max(lq, lk) > _INT32_MAX:
        raise ValueError(f"{name}: B·H <= 65535 and lengths below 2**31 required")
    if window is not None and not 1 <= window <= _INT32_MAX:
        raise ValueError(f"{name}: window {window} outside [1, 2**31)")
    if lk < 1 or (causal and lk < lq):
        raise ValueError(f"{name}: every query row must see a key (Lk={lk}, Lq={lq})")
    out = torch.empty_like(q)
    if lq == 0 or b * h == 0:
        return out
    strides = (ctypes.c_int64 * 12)(*(t.stride(i) for t in (q, k, v, out) for i in range(3)))
    status = lib("flash_attention").flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv, lq, lk, d,
        strides, int(causal), int(window is not None), int(window or 0),
        1.0 / d**0.5, _DTYPE_CODES[q.dtype], stream_of(device),
    )
    check(status, name)
    LAUNCHES[name] += 1
    return out
