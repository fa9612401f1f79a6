"""The port's attention against the JAX package's.

The port's ``flash_attention`` on CPU tensors (its plain version) is held
against the reference's ``attention_ref`` and against the Pallas kernel in
interpret mode (``force_kernel=True``), within ``rtol=atol=2e-4`` for
float32 and ``3e-2`` for bfloat16: the tolerances of
``tests/test_kernels_flash_attention.py``.  GQA inputs (Hkv < H) are held
against the reference fed K/V repeated over each head group.  Every case
stays at 256 keys or fewer: the Pallas kernel runs interpreted.
"""

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels import build as B
from repro_torch.kernels.flash_attention import attention_ref, flash_attention

TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
# (B, H, Hkv, Lq, Lk, D, causal, window)
REF_CASES = [
    (1, 2, 2, 64, 64, 32, True, None),  # Lq = Lk
    (2, 2, 2, 1, 200, 64, True, None),  # decode: Lq = 1
    (1, 4, 4, 40, 100, 16, True, 8),  # ragged Lk > Lq, window
    (1, 2, 2, 50, 50, 16, False, None),  # not causal
    (1, 4, 2, 30, 90, 16, True, 16),  # GQA 2
    (2, 4, 1, 1, 77, 32, True, 4),  # GQA 4, decode
    (1, 2, 2, 20, 60, 16, False, 5),  # window without causality
    (1, 2, 2, 64, 64, 16, True, 1),  # window of one key
    (1, 2, 2, 64, 64, 16, True, 2**30),  # a global layer's window
]
# The Pallas kernel needs Lq and Lk to be multiples of min(128, L).
PALLAS_CASES = [
    (1, 2, 2, 128, 256, 32, True, None),
    (1, 2, 2, 128, 128, 64, True, 64),
    (2, 2, 2, 1, 256, 32, True, None),
    (1, 4, 2, 128, 128, 32, True, 32),
    (1, 1, 1, 64, 64, 16, False, None),
]


def _qkv(seed, b, h, hkv, lq, lk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, lk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, lk, d)).astype(np.float32)
    return q, k, v


def _repeat(x, groups):
    return np.repeat(x, groups, axis=1)


@pytest.mark.parametrize("b,h,hkv,lq,lk,d,causal,window", REF_CASES)
def test_plain_matches_jax_attention_ref(b, h, hkv, lq, lk, d, causal, window):
    q, k, v = _qkv(lq + lk + d, b, h, hkv, lq, lk, d)
    before = dict(B.LAUNCHES)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=causal, window=window)
    assert B.LAUNCHES == before  # the CPU path launches nothing
    assert got.shape == q.shape and got.dtype == torch.float32
    g = h // hkv
    want = np.asarray(jax_attention_ref(q, _repeat(k, g), _repeat(v, g), causal=causal,
                                        window=window))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("b,h,hkv,lq,lk,d,causal,window", PALLAS_CASES)
def test_plain_matches_pallas_kernel(b, h, hkv, lq, lk, d, causal, window):
    q, k, v = _qkv(7 + lq + lk + d, b, h, hkv, lq, lk, d)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=causal, window=window)
    g = h // hkv
    want = np.asarray(jax_flash_attention(q, _repeat(k, g), _repeat(v, g), causal=causal,
                                          window=window, force_kernel=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bf16_matches_reference_and_pallas_kernel():
    import jax.numpy as jnp

    q, k, v = _qkv(2, 1, 2, 2, 128, 128, 64)
    got = flash_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    for want in (jax_attention_ref(qb, kb, vb, causal=True),
                 jax_flash_attention(qb, kb, vb, causal=True, force_kernel=True)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32),
                                   **BF16_TOL)


def test_gqa_reads_the_head_group_of_each_query_head():
    q, k, v = _qkv(5, 2, 8, 2, 24, 40, 16)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    got = attention_ref(q, k, v, causal=True, window=8)
    want = attention_ref(q, k.repeat_interleave(4, dim=1), v.repeat_interleave(4, dim=1),
                         causal=True, window=8)
    assert torch.equal(got, want)
    # query head 5 reads KV head 5 // 4 = 1 only
    alone = attention_ref(q[:, 5:6], k[:, 1:2], v[:, 1:2], causal=True, window=8)
    assert torch.equal(got[:, 5:6], alone)
