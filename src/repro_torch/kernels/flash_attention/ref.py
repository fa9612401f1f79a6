"""Plain PyTorch attention oracle (causal / sliding-window / full), the
port of ``repro.kernels.flash_attention.ref``.

Contract: q (B, H, Lq, D), k and v (B, Hkv, Lk, D) with Hkv dividing H;
query head h reads key/value head ``h // (H // Hkv)`` (with Hkv = H it is
the JAX contract).  ``causal`` masks j > i + off where off = Lk - Lq
(decode alignment: the last query attends to all keys); ``window``
additionally masks j <= i + off - window (a sliding window of ``window``
keys, self included).  Scores are taken in q's dtype, the softmax in
float32, the output in q's dtype.  A row that sees no key averages all of
v, as the JAX oracle does.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["NEG_INF", "attention_ref"]

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    h, lq, d = q.shape[1], q.shape[2], q.shape[3]
    lk = k.shape[2]
    groups = h // k.shape[1]
    if groups != 1:
        k = k.repeat_interleave(groups, dim=1)
        v = v.repeat_interleave(groups, dim=1)
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=q.dtype))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale.to(q.device)
    off = lk - lq
    i = torch.arange(lq, device=q.device)[:, None]
    j = torch.arange(lk, device=q.device)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i + off
    if window is not None:
        mask &= j > i + off - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s.float(), dim=3).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)
