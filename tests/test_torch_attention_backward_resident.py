"""The fp32 resident backward's route, refusals and arithmetic on the CPU
(its kernel, ``csrc/flash_attention_bwd_resident.cu``, runs on the card:
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``).

- ``kernel.bwd_route`` sends exactly fp32, not causal, no window, D a
  multiple of 4 up to 64, with K, V, Q and dO of a (batch, KV head)
  within shared memory (``resident_bwd_smem_bytes``), to the resident
  kernel, and its launcher refuses what that kernel does not take
  (CPU tensors, bf16, causal, a window, D off 4, a base or stride off 16
  bytes, an lse of the wrong shape) before launching anything.
- A plain emulation of the kernel's arithmetic (every product in the
  3xTF32 split with ``fr_tf32``'s rounding, fp32 sums, P from the
  forward's lse in base 2, delta computed from O and dO, phase 2's K and
  phase 3's Q pre-multiplied by scale·log2 e) lands within the unchanged
  ``FLASH_BWD_TOL["float32"]`` of ``attention_bwd_ref`` on every case of
  ``RESIDENT_BWD_CASES``; its faulty controls (delta dropped, the group's
  sum dropped, one TF32 product in place of the split) land beyond it.
- ``ops.flash_attention`` on the CPU at BERT4Rec's call (fewer rows)
  saves its lse and gives ``jax.vjp`` of the JAX package's jnp attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import FLASH_BWD_CASES, RESIDENT_BWD_CASES, flash_bwd_error, tf32_product
from repro.models.layers import attention as jax_attention
from repro_torch.kernels import build as B
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention import ref as R

BWD_RTOL = 2e-5  # as tests/test_torch_attention_backward.py
LOG2E = 1.4426950408889634  # FR_LOG2E

# (bwd_route's arguments, the route): BERT4Rec's call; D from 4 to 68;
# causal, windowed and bf16 calls; Lk at the last that fits shared memory
# (688 keys over 200 rows at D = 32) and the first that does not; a group
# of 8 whose Q and dO do not fit.
ROUTE_CASES = [
    ((torch.float32, 2, 2, 200, 200, 32, False, None), "resident"),
    *[((torch.float32, 2, 2, 200, 200, d, False, None), "resident") for d in (4, 20, 60, 64)],
    ((torch.float32, 2, 2, 200, 200, 68, False, None), "general"),
    ((torch.float32, 2, 2, 200, 200, 30, False, None), "general"),
    ((torch.float32, 2, 2, 200, 200, 32, True, None), "general"),
    ((torch.float32, 2, 2, 200, 200, 32, False, 8), "general"),
    ((torch.bfloat16, 2, 2, 200, 200, 32, False, None), "general"),
    ((torch.bfloat16, 2, 2, 200, 200, 64, False, None), "sm90"),
    ((torch.float32, 2, 2, 200, 688, 32, False, None), "resident"),
    ((torch.float32, 2, 2, 200, 689, 32, False, None), "general"),
    ((torch.float32, 8, 1, 20, 70, 64, False, None), "resident"),
    ((torch.float32, 8, 1, 200, 200, 64, False, None), "general"),
]


@pytest.mark.parametrize("args,want", ROUTE_CASES, ids=str)
def test_bwd_route_takes_the_resident_kernel_exactly_where_it_fits(args, want):
    dtype, h, hkv, lq, lk, d, causal, window = args
    assert FK.bwd_route(*args) == want
    if dtype == torch.float32 and not causal and window is None and d % 4 == 0 and d <= 64:
        fits = FK.resident_bwd_smem_bytes(lq, lk, d, h // hkv) <= FK.RESIDENT_SMEM_BYTES
        assert (want == "resident") == fits


def test_resident_bwd_smem_bytes_counts_the_padded_operands():
    # K, V: 208 rows of 32 floats; Q, dO: 208 rows; lse and delta: 208 each.
    assert FK.resident_bwd_smem_bytes(200, 200, 32, 1) == 4 * (4 * 208 * 32 + 2 * 208)
    assert FK.resident_bwd_smem_bytes(20, 70, 64, 8) == 4 * (2 * 80 * 64 + 16 * 32 * 64 + 16 * 32)
    assert FK.resident_bwd_smem_bytes(1, 1, 4, 1) == 4 * (4 * 16 * 32 + 2 * 16)


def _inputs(seed, b, h, hkv, lq, lk, d, dtype=torch.float32):
    """q, k, v, dout (B, H, L, D) from numpy standard normals."""
    rng = np.random.default_rng(seed)
    shapes = ((b, h, lq, d), (b, hkv, lk, d), (b, hkv, lk, d), (b, h, lq, d))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
            for s in shapes]


def test_resident_backward_launcher_refuses_what_its_kernel_does_not_take():
    b, h, hkv, lq, lk, d = 2, 2, 2, 40, 40, 32
    q, k, v, dout = _inputs(0, b, h, hkv, lq, lk, d)
    out, lse = R.attention_lse_ref(q, k, v, False, None)
    before = dict(B.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):  # CPU tensors
        FK.bwd_resident_cuda(q, k, v, out, dout, lse)
    with pytest.raises(ValueError, match="CUDA"):
        FK.flash_attention_bwd_cuda(q, k, v, out, dout, False, None, lse=lse)
    route = "float32, not causal, no window"
    with pytest.raises(ValueError, match=route):  # bf16
        FK.bwd_resident_cuda(*(t.to(torch.bfloat16) for t in (q, k, v, out, dout)), lse)
    with pytest.raises(ValueError, match=route):
        FK.bwd_resident_cuda(q, k, v, out, dout, lse, causal=True)
    with pytest.raises(ValueError, match=route):
        FK.bwd_resident_cuda(q, k, v, out, dout, lse, window=8)
    narrow = [t[..., :30] for t in (q, k, v, out, dout)]  # D = 30, off 4
    with pytest.raises(ValueError, match=route):
        FK.bwd_resident_cuda(*narrow, lse)
    shifted = torch.zeros(q.numel() + 1)[1:].view(q.shape)  # base 4 bytes past 16
    with pytest.raises(ValueError, match="16-byte"):
        FK.bwd_resident_cuda(shifted, k, v, out, dout, lse)
    wide = torch.zeros((b, h, lq, d + 1))[..., :d]  # position stride of 132 bytes
    with pytest.raises(ValueError, match="16-byte"):
        FK.bwd_resident_cuda(q, k, v, out, wide, lse)
    with pytest.raises(ValueError, match="lse"):
        FK.bwd_resident_cuda(q, k, v, out, dout, lse[:, :lq - 1])
    with pytest.raises(ValueError, match="lse"):
        FK.bwd_resident_cuda(q, k, v, out, dout, lse.t().contiguous().t())
    with pytest.raises(ValueError, match="log-sum-exp"):
        FK.bwd_resident_cuda(q, k, v, out, dout, None)
    assert B.LAUNCHES == before  # refused before any launch


def _resident_emulation(q, k, v, out, dout, lse, fault=None):
    """The resident kernel's arithmetic in float32: delta = rowsum(dO ∘ O);
    phase 2 (dK, dV): Sᵀ = (K·scale·log2 e)·Qᵀ and dPᵀ = V·dOᵀ, Pᵀ =
    exp2(Sᵀ − lse·log2 e), dSᵀ = Pᵀ ∘ (dPᵀ − delta), dV = Σ_group Pᵀ·dO,
    dK = scale · Σ_group dSᵀ·Q; phase 3 (dQ): S = (Q·scale·log2 e)·Kᵀ,
    P, dP = dO·Vᵀ, dS again, dQ = scale · dS·K; every product in the
    3xTF32 split (``tf32_product``).  ``fault``: ``"delta dropped"`` (delta
    taken as 0), ``"group sum dropped"`` (dK and dV from the first query
    head of each group), ``"single_tf32"`` (one TF32 product each)."""
    b, h, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    g = h // hkv
    scale = torch.tensor(1.0 / d**0.5, dtype=torch.float32)
    sl = scale * torch.tensor(LOG2E, dtype=torch.float32)
    single = fault == "single_tf32"
    delta = (dout * out).sum(dim=-1).reshape(b, hkv, g, lq)
    if fault == "delta dropped":
        delta = torch.zeros_like(delta)
    lse2 = lse.reshape(b, hkv, g, lq) * torch.tensor(LOG2E, dtype=torch.float32)
    qg, gg = q.reshape(b, hkv, g, lq, d), dout.reshape(b, hkv, g, lq, d)

    st = tf32_product(k * sl, qg, "bkjd,bkgqd->bkgjq", single)
    pt = torch.exp2(st - lse2[:, :, :, None, :])
    dst = pt * (tf32_product(v, gg, "bkjd,bkgqd->bkgjq", single) - delta[:, :, :, None, :])
    dk = torch.zeros(k.shape)
    dv = torch.zeros(v.shape)
    for gi in range(1 if fault == "group sum dropped" else g):
        dv = dv + tf32_product(pt[:, :, gi], gg[:, :, gi], "bkjq,bkqd->bkjd", single)
        dk = dk + tf32_product(dst[:, :, gi], qg[:, :, gi], "bkjq,bkqd->bkjd", single)

    s = tf32_product(qg * sl, k, "bkgqd,bkjd->bkgqj", single)
    p = torch.exp2(s - lse2[..., None])
    ds = p * (tf32_product(gg, v, "bkgqd,bkjd->bkgqj", single) - delta[..., None])
    dq = tf32_product(ds, k, "bkgqj,bkjd->bkgqd", single).reshape(b, h, lq, d)
    return dq * scale, dk * scale, dv


def _case(n, b, h, hkv, lq, lk, d):
    q, k, v, dout = _inputs(300 + n, b, h, hkv, lq, lk, d)
    out, lse = R.attention_lse_ref(q, k, v, False, None)
    want = R.attention_bwd_ref(q, k, v, out, dout, False, None)
    return q, k, v, out, dout, lse, want


def _share(got, want):
    return max(flash_bwd_error(g, w)[1] for g, w in zip(got, want, strict=True))


def test_resident_cases_take_the_resident_route():
    for b, h, hkv, lq, lk, d in RESIDENT_BWD_CASES:
        assert FK.bwd_route(torch.float32, h, hkv, lq, lk, d, False, None) == "resident"
    assert (3, 2, 2, 200, 200, 32) in RESIDENT_BWD_CASES  # BERT4Rec's call
    assert sum(c[:6] in RESIDENT_BWD_CASES for c in FLASH_BWD_CASES) == 2


@pytest.mark.parametrize("n,case", list(enumerate(RESIDENT_BWD_CASES)), ids=str)
def test_the_resident_arithmetic_lands_within_the_fp32_limit(n, case):
    q, k, v, out, dout, lse, want = _case(n, *case)
    got = _resident_emulation(q, k, v, out, dout, lse)
    for g, w in zip(got, want, strict=True):
        err, share = flash_bwd_error(g, w)
        assert share <= 1.0, (err, share)


@pytest.mark.parametrize("n,case", list(enumerate(RESIDENT_BWD_CASES)), ids=str)
def test_the_single_tf32_control_lands_beyond_the_fp32_limit(n, case):
    """One TF32 product in place of the 3xTF32 split: the limit holds the
    kernel to the split (3.5 to 5.6 times the limit on these cases)."""
    q, k, v, out, dout, lse, want = _case(n, *case)
    assert _share(_resident_emulation(q, k, v, out, dout, lse, "single_tf32"), want) > 1.0


@pytest.mark.parametrize("n,case", list(enumerate(RESIDENT_BWD_CASES)), ids=str)
def test_the_delta_dropped_control_lands_beyond_the_fp32_limit(n, case):
    q, k, v, out, dout, lse, want = _case(n, *case)
    assert _share(_resident_emulation(q, k, v, out, dout, lse, "delta dropped"), want) > 1.0


@pytest.mark.parametrize("n,case", [(n, c) for n, c in enumerate(RESIDENT_BWD_CASES)
                                    if c[1] > c[2]], ids=str)
def test_the_group_sum_dropped_control_lands_beyond_the_fp32_limit(n, case):
    q, k, v, out, dout, lse, want = _case(n, *case)
    bad = _resident_emulation(q, k, v, out, dout, lse, "group sum dropped")
    assert _share(bad[1:], want[1:]) > 1.0


def test_cpu_flash_attention_at_bert4recs_call_gives_the_jax_vjp():
    """BERT4Rec's encoder call (2 heads of 32 over 200 positions, not
    causal) at 2 rows, in the model's (B, L, H, D) layout."""
    b, lq, h, d = 2, 200, 2, 32
    rng = np.random.default_rng(4)
    q, k, v, g = (rng.standard_normal((b, lq, h, d)).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_attention(q_, k_, v_, causal=False),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*(t.transpose(1, 2) for t in leaves), causal=False)
    assert out.grad_fn.saved_tensors[4] is not None  # the forward's lse
    got = torch.autograd.grad(out.transpose(1, 2), leaves, torch.from_numpy(g))
    for gr, w in zip(got, want, strict=True):
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(gr.numpy(), w, rtol=0, atol=BWD_RTOL * scale)
