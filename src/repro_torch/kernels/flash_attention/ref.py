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

``decode_partials_ref`` and ``combine_ref`` are the plain versions of the
two kernels of the decode variant (split-K over the keys, then the merge
of the splits), which ``chip_smoke.py`` times and checks one by one.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["NEG_INF", "attention_ref", "combine_ref", "decode_partials_ref"]

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


def decode_partials_ref(q, k, v, causal, window, plan):
    """Plain version of the decode variant's first kernel
    (``kernel.decode_partials_cuda``): for each (batch, KV head) the rows
    r = g·Lq + i of its query heads g, and for each split of
    ``plan = (j_begin, j_end, chunk, n_splits)`` the fp32 max m of the
    masked scores over the split's keys, l = Σ exp(s - m) and
    acc = Σ exp(s - m)·v; ``ml`` (B·Hkv, n_splits, rows, 2), ``acc``
    (B·Hkv, n_splits, rows, D)."""
    b, h, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    g = h // hkv
    rows = g * lq
    j_begin, j_end, chunk, n_splits = plan
    qf = q.float().reshape(b, hkv, rows, d)
    s = torch.einsum("bkrd,bkjd->bkrj", qf, k.float()) * (1.0 / d**0.5)
    pos = (torch.arange(lq, device=q.device) + (lk - lq)).repeat(g)[:, None]
    j = torch.arange(lk, device=q.device)[None, :]
    mask = torch.ones((rows, lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= pos
    if window is not None:
        mask &= j > pos - window
    s = torch.where(mask, s, NEG_INF)
    ml = torch.empty((b * hkv, n_splits, rows, 2), dtype=torch.float32, device=q.device)
    acc = torch.empty((b * hkv, n_splits, rows, d), dtype=torch.float32, device=q.device)
    for sp in range(n_splits):
        lo = j_begin + sp * chunk
        hi = min(lo + chunk, j_end)
        part = s[..., lo:hi]
        m = part.max(dim=3).values
        p = torch.exp(part - m[..., None])
        ml[:, sp, :, 0] = m.reshape(b * hkv, rows)
        ml[:, sp, :, 1] = p.sum(dim=3).reshape(b * hkv, rows)
        acc[:, sp] = torch.einsum("bkrj,bkjd->bkrd", p, v[:, :, lo:hi].float()).reshape(
            b * hkv, rows, d)
    return ml, acc


def combine_ref(ml, acc, b, h, hkv, lq, dtype):
    """Plain version of the decode variant's combine
    (``kernel.combine_cuda``): the splits of ``decode_partials_ref``
    merged with the usual rescale, (B, H, Lq, D) in ``dtype``."""
    d = acc.shape[3]
    top = ml[..., 0].max(dim=1, keepdim=True).values
    w = torch.exp(ml[..., 0] - top)
    total = (w * ml[..., 1]).sum(dim=1)
    out = (w[..., None] * acc).sum(dim=1) / total.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, lq, d).to(dtype)
