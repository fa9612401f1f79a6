"""The attention's backward on the port: ``ref.attention_bwd_ref`` (the
plain version of the three kernels of ``csrc/flash_attention_bwd.cu``, the
FlashAttention-2 recompute in float32) against ``jax.vjp`` of
``repro.models.layers.attention`` — the jnp function the JAX package
trains through — and against PyTorch's autograd through
``ref.attention_ref``, on the same numpy inputs from a seed: causal, with
a window, GQA (the group's heads summed into each KV head's dK and dV),
not causal with and without a window, Lk > Lq.  Its three parts
(``bwd_prep_ref``, ``bwd_dkdv_ref``, ``bwd_dq_ref``) compose it, and
``ops.flash_attention`` runs as an autograd function only when an input
needs a gradient.  The kernels themselves run on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).

Tolerance: float32 sums in other orders on both sides (XLA's einsums,
the recompute's log-sum-exp): every element within ``BWD_RTOL`` of the
largest magnitude of its gradient, that magnitude taken as at least 1
(the inputs are standard normal; at window 1 each row's softmax has one
key, so dQ and dK vanish identically and both sides hold float noise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import attention as jax_attention
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref, attention_ref, bwd_dkdv_ref,
                                                     bwd_dq_ref, bwd_prep_ref)

BWD_RTOL = 2e-5

# (B, H, Hkv, Lq, Lk, D, causal, window)
CASES = [
    (2, 2, 2, 9, 9, 8, True, None),
    (1, 4, 2, 7, 13, 16, True, 4),
    (2, 6, 2, 11, 11, 8, True, 1),
    (1, 8, 1, 5, 12, 16, True, None),
    (2, 4, 4, 10, 10, 8, False, None),
    (1, 4, 2, 6, 15, 8, False, 5),
    (3, 2, 1, 1, 20, 32, True, 7),
]


def _inputs(seed, b, h, hkv, lq, lk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, lk, hkv, d)).astype(np.float32)
    g = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    return q, k, v, g


def _bhld(x):
    return torch.from_numpy(x).transpose(1, 2)


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=BWD_RTOL * scale)


@pytest.mark.parametrize("b,h,hkv,lq,lk,d,causal,window", CASES)
def test_plain_backward_equals_jax_vjp_of_the_reference_attention(b, h, hkv, lq, lk, d, causal,
                                                                   window):
    q, k, v, g = _inputs(lq * lk + d, b, h, hkv, lq, lk, d)
    out, vjp = jax.vjp(lambda q_, k_, v_: jax_attention(q_, k_, v_, causal=causal, window=window),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    qt, kt, vt, gt = (_bhld(x) for x in (q, k, v, g))
    ot = attention_ref(qt, kt, vt, causal=causal, window=window)
    _close(ot.transpose(1, 2).numpy(), out)
    got = attention_bwd_ref(qt, kt, vt, ot, gt, causal, window)
    for gr, w in zip(got, want, strict=True):
        _close(gr.transpose(1, 2).numpy(), w)


@pytest.mark.parametrize("b,h,hkv,lq,lk,d,causal,window", CASES)
def test_plain_backward_equals_autograd_and_its_parts_compose(b, h, hkv, lq, lk, d, causal,
                                                              window):
    q, k, v, g = (_bhld(x) for x in _inputs(7 + lq, b, h, hkv, lq, lk, d))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = attention_ref(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(out, leaves, g)
    got = attention_bwd_ref(q, k, v, out.detach(), g, causal, window)
    for gr, w in zip(got, want, strict=True):
        _close(gr.numpy(), w.numpy())
    lse, delta = bwd_prep_ref(q, k, out.detach(), g, causal, window)
    assert lse.shape == delta.shape == (b * h, lq)
    dk, dv = bwd_dkdv_ref(q, k, v, g, lse, delta, causal, window)
    assert torch.equal(dk, got[1]) and torch.equal(dv, got[2])
    assert torch.equal(bwd_dq_ref(q, k, v, g, lse, delta, causal, window), got[0])


def test_flash_attention_is_an_autograd_function_only_when_a_gradient_is_needed():
    q, k, v, g = (_bhld(x) for x in _inputs(1, 2, 4, 2, 6, 9, 8))
    assert ops.flash_attention(q, k, v).grad_fn is None
    qq = q.clone().requires_grad_()
    out = ops.flash_attention(qq, k, v, causal=True, window=3)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    (dq,) = torch.autograd.grad(out, (qq,), g)
    want = attention_bwd_ref(q, k, v, out.detach(), g, True, 3)[0]
    assert torch.equal(dq, want)
    with torch.no_grad():
        assert ops.flash_attention(qq, k, v).grad_fn is None


def test_the_model_layout_views_get_gradients_of_their_shape():
    """The model hands (B, H, L, D) views of (B, L, H, D) buffers."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(2, 1, 4, 2, 5, 5, 8))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*(t.transpose(1, 2) for t in leaves))
    out.transpose(1, 2).backward(g)
    for t in leaves:
        assert t.grad.shape == t.shape


def test_backward_launcher_refuses_what_its_kernels_do_not_take():
    q, k, v, g = (_bhld(x).contiguous() for x in _inputs(3, 1, 2, 1, 4, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        FK.flash_attention_bwd_cuda(q, k, v, q, g)
