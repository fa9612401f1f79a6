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

``attention_bwd_ref`` is the plain version of the backward
(``csrc/flash_attention_bwd.cu``): the gradient of ``attention_ref`` with
respect to q, k and v by FlashAttention-2's recompute, in float32, built
from the plain versions of its three kernels (``bwd_prep_ref``,
``bwd_dkdv_ref``, ``bwd_dq_ref``).  ``attention_lse_ref`` is the plain
version of the forward that also hands the backward each row's
log-sum-exp (the sm90 forward's ``lse``); given it, the backward skips
its recompute.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["NEG_INF", "attention_bwd_ref", "attention_lse_ref", "attention_ref", "bwd_dkdv_ref",
           "bwd_dq_ref", "bwd_prep_ref", "combine_ref", "decode_partials_ref"]

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


def _visible(lq: int, lk: int, causal: bool, window: Optional[int], device) -> torch.Tensor:
    """(Lq, Lk) bool: key j visible to query row i (the forward's masks)."""
    off = lk - lq
    i = torch.arange(lq, device=device)[:, None]
    j = torch.arange(lk, device=device)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool, device=device)
    if causal:
        mask &= j <= i + off
    if window is not None:
        mask &= j > i + off - window
    return mask


def _grouped(x: torch.Tensor) -> torch.Tensor:
    """k or v (B, Hkv, Lk, D) as float32 (B, Hkv, 1, Lk, D), broadcast over
    the group's query heads."""
    return x.float()[:, :, None]


def _scores(q, k, causal, window):
    """float32 scores (B, Hkv, G, Lq, Lk) times 1/sqrt(D) and the mask."""
    b, h, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.float().reshape(b, hkv, g, lq, d)
    s = torch.einsum("bkgqd,bkgjd->bkgqj", qg, _grouped(k)) * (1.0 / d**0.5)
    return s, _visible(lq, lk, causal, window, q.device)


def _lse(q, k, causal, window):
    """float32 (B·H, Lq): each row's log-sum-exp of its visible scaled
    scores."""
    b, h, lq, _ = q.shape
    s, mask = _scores(q, k, causal, window)
    return torch.logsumexp(torch.where(mask, s, NEG_INF), dim=-1).reshape(b * h, lq)


def _delta(out, dout):
    """float32 (B·H, Lq): rowsum(dO ∘ O)."""
    b, h, lq, _ = out.shape
    return (dout.float() * out.float()).sum(dim=-1).reshape(b * h, lq)


def attention_lse_ref(q, k, v, causal=True, window=None):
    """(out, lse): ``attention_ref``'s output and ``bwd_prep_ref``'s
    log-sum-exp (float32 (B·H, Lq)), the plain version of the sm90 forward
    asked for its log-sum-exp (``kernel.flash_attention_lse_cuda``)."""
    return attention_ref(q, k, v, causal=causal, window=window), _lse(q, k, causal, window)


def bwd_prep_ref(q, k, out, dout, causal=True, window=None):
    """Plain version of ``flash_bwd_prep_kernel``: per (batch·head, row)
    the log-sum-exp of the row's visible scaled scores and
    ``delta = rowsum(dO ∘ O)``, both float32 (B·H, Lq)."""
    return _lse(q, k, causal, window), _delta(out, dout)


def _p_ds(q, k, v, dout, lse, delta, causal, window):
    """P (masked to 0) and dS = P ∘ (dO·Vᵀ − delta), (B, Hkv, G, Lq, Lk)."""
    b, h, lq, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    s, mask = _scores(q, k, causal, window)
    p = torch.where(mask, torch.exp(s - lse.reshape(b, hkv, g, lq, 1)), 0.0)
    dp = torch.einsum("bkgqd,bkgjd->bkgqj", dout.float().reshape(b, hkv, g, lq, d),
                      _grouped(v))
    return p, p * (dp - delta.reshape(b, hkv, g, lq, 1))


def bwd_dkdv_ref(q, k, v, dout, lse, delta, causal=True, window=None):
    """Plain version of ``flash_bwd_dkdv_kernel``: dK = Σ_group dSᵀ·Q / √D
    and dV = Σ_group Pᵀ·dO, in k's and v's dtypes."""
    b, h, lq, d = q.shape
    hkv = k.shape[1]
    p, ds = _p_ds(q, k, v, dout, lse, delta, causal, window)
    qg = q.float().reshape(b, hkv, h // hkv, lq, d)
    dog = dout.float().reshape(b, hkv, h // hkv, lq, d)
    dk = torch.einsum("bkgqj,bkgqd->bkjd", ds, qg) * (1.0 / d**0.5)
    dv = torch.einsum("bkgqj,bkgqd->bkjd", p, dog)
    return dk.to(k.dtype), dv.to(v.dtype)


def bwd_dq_ref(q, k, v, dout, lse, delta, causal=True, window=None):
    """Plain version of ``flash_bwd_dq_kernel``: dQ = dS·K / √D, in q's
    dtype."""
    b, h, lq, d = q.shape
    _, ds = _p_ds(q, k, v, dout, lse, delta, causal, window)
    dq = torch.einsum("bkgqj,bkjd->bkgqd", ds, k.float()) * (1.0 / d**0.5)
    return dq.reshape(b, h, lq, d).to(q.dtype)


def attention_bwd_ref(q, k, v, out, dout, causal=True, window=None, lse=None):
    """(dq, dk, dv): the gradient of ``attention_ref(q, k, v, causal,
    window)`` whose output was ``out``, for the output gradient ``dout``,
    recomputed in float32 (FlashAttention-2: the log-sum-exp of each row,
    ``delta = rowsum(dO ∘ O)``, then P and dS), in the inputs' dtypes;
    with the forward's ``lse`` (``attention_lse_ref``) it computes delta
    alone.  The group's query heads are summed into each KV head's dK and
    dV.  Every row must see a key, as the kernels require (a row that sees
    none gets zero gradients here, not those of the forward's uniform
    average)."""
    if lse is None:
        lse, delta = bwd_prep_ref(q, k, out, dout, causal, window)
    else:
        delta = _delta(out, dout)
    dk, dv = bwd_dkdv_ref(q, k, v, dout, lse, delta, causal, window)
    return bwd_dq_ref(q, k, v, dout, lse, delta, causal, window), dk, dv
