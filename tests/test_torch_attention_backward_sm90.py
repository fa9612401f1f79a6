"""The bf16 tensor-core backward's route, limit and saved log-sum-exp on
the CPU (its kernels, ``csrc/flash_attention_bwd_sm90.cu``, run on the
card: ``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``).

- ``kernel.bwd_route`` sends exactly bf16 with D in {64, 128, 256} to the
  sm90 kernels (the fp32 resident route is
  ``tests/test_torch_attention_backward_resident.py``'s), and their
  launchers refuse what those kernels do not take (another dtype or head
  dim, a base or stride off 16 bytes, CPU tensors, statistics of the wrong
  shape) before launching anything.
- The sm90 route rounds P and dS to bf16 for its three products
  (``_torch_parity.BWD_ROUNDING``): a plain emulation that does the same
  lands within ``FLASH_BWD_TOL`` plus ``bwd_rounding_terms`` of the plain
  backward on every case of ``FLASH_BWD_CASES``, and the faulty controls
  (the window dropped, the group's sum dropped) land beyond it.
- ``ref.attention_lse_ref``'s log-sum-exp is ``bwd_prep_ref``'s, and
  ``ops.flash_attention`` on the CPU saves it in its forward and hands it
  to the backward, whose gradients equal ``jax.vjp`` of the JAX package's
  jnp attention (``repro.models.layers.attention``) within the float32
  tolerance of ``tests/test_torch_attention_backward.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import FLASH_BWD_CASES, bwd_rounding_terms, flash_bwd_error
from repro.models.layers import attention as jax_attention
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention import ref as R

BWD_RTOL = 2e-5  # as tests/test_torch_attention_backward.py


def _bf16_inputs(seed, b, h, hkv, lq, lk, d):
    """q, k, v, dout as bf16 (B, H, L, D) from numpy standard normals."""
    rng = np.random.default_rng(seed)
    shapes = ((b, h, lq, d), (b, hkv, lk, d), (b, hkv, lk, d), (b, h, lq, d))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
            for s in shapes]


def _sm90_emulation(q, k, v, out, dout, causal, window, lse, delta):
    """The sm90 route's arithmetic in float32: P and dS from ``lse`` and
    ``delta``, rounded to bf16 before dV += Pᵀ·dO, dK += dSᵀ·Q and
    dQ += dS·K; each gradient rounded to bf16 once."""
    b, h, lq, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    qf, kf, vf, gf = (t.float() for t in (q, k, v, dout))
    p, ds = R._p_ds(qf, kf, vf, gf, lse, delta, causal, window)
    p, ds = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    scale = 1.0 / d**0.5
    dv = torch.einsum("bkgqj,bkgqd->bkjd", p, gf.reshape(b, hkv, g, lq, d))
    dk = torch.einsum("bkgqj,bkgqd->bkjd", ds, qf.reshape(b, hkv, g, lq, d)) * scale
    dq = torch.einsum("bkgqj,bkjd->bkgqd", ds, kf).reshape(b, h, lq, d) * scale
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def _case(n, b, h, hkv, lq, lk, d, causal, window):
    q, k, v, dout = _bf16_inputs(100 + n, b, h, hkv, lq, lk, d)
    out = R.attention_ref(q.float(), k.float(), v.float(), causal, window).to(torch.bfloat16)
    lse, delta = R.bwd_prep_ref(q.float(), k.float(), out.float(), dout.float(), causal, window)
    want = R.attention_bwd_ref(q.float(), k.float(), v.float(), out.float(), dout.float(),
                               causal, window)
    terms = bwd_rounding_terms(q, k, v, dout, lse, delta, causal, window)
    return q, k, v, out, dout, lse, delta, want, terms


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [20, 32, 64, 96, 128, 192, 256])
def test_bwd_route_takes_the_sm90_kernels_exactly_for_bf16_at_their_head_dims(dtype, d):
    """A causal call (the LM's), so no input takes the resident route."""
    want = "sm90" if dtype == torch.bfloat16 and d in (64, 128, 256) else "general"
    assert FK.bwd_route(dtype, 4, 2, 64, 64, d, True, None) == want


def test_sm90_backward_launchers_refuse_what_their_kernels_do_not_take():
    b, h, hkv, lq, lk, d = 1, 4, 2, 8, 8, 64
    q, k, v, dout = _bf16_inputs(0, b, h, hkv, lq, lk, d)
    lse = torch.zeros((b * h, lq))
    delta = torch.zeros((b * h, lq))
    launchers = (FK.bwd_dkdv_sm90_cuda, FK.bwd_dq_sm90_cuda)
    for fn in launchers:
        with pytest.raises(ValueError, match="CUDA"):  # CPU tensors
            fn(q, k, v, dout, lse, delta)
        with pytest.raises(ValueError, match="bf16"):  # another dtype
            fn(q.float(), k.float(), v.float(), dout.float(), lse, delta)
        wide = [torch.zeros(t.shape[:3] + (80,), dtype=torch.bfloat16) for t in (q, k, v, dout)]
        with pytest.raises(ValueError, match="head dim"):  # D = 80
            fn(*wide, lse, delta)
        # A position stride of 68 bf16 values (136 bytes) is off 16 bytes.
        qm = torch.zeros((b, h, lq, 68), dtype=torch.bfloat16)[..., :d]
        with pytest.raises(ValueError, match="16-byte"):
            fn(qm, k, v, dout, lse, delta)
    with pytest.raises(ValueError, match="CUDA"):
        FK.flash_attention_bwd_cuda(q, k, v, q, dout)
    with pytest.raises(ValueError, match="16-byte"):
        FK.flash_attention_bwd_cuda(q, k, v, q, torch.zeros((b, h, lq, 68),
                                                            dtype=torch.bfloat16)[..., :d])


@pytest.mark.parametrize("n,case", list(enumerate(FLASH_BWD_CASES)))
def test_the_sm90_arithmetic_lands_within_its_limit(n, case):
    """P and dS rounded to bf16 stay within FLASH_BWD_TOL plus the rounding
    term; the rounding-free bf16 gradients (the general backward's
    arithmetic) stay within it too."""
    b, h, hkv, lq, lk, d, causal, window = case
    q, k, v, out, dout, lse, delta, want, terms = _case(n, *case)
    got = _sm90_emulation(q, k, v, out, dout, causal, window, lse, delta)
    for g, w, t in zip(got, want, terms, strict=True):
        err, share = flash_bwd_error(g, w, t)
        assert share <= 1.0, (err, share)
        assert flash_bwd_error(w.to(torch.bfloat16), w, t)[1] <= 1.0


WINDOWED = [(n, c) for n, c in enumerate(FLASH_BWD_CASES) if c[7] is not None and c[7] < c[4]]
GROUPED = [(n, c) for n, c in enumerate(FLASH_BWD_CASES) if c[1] // c[2] > 1]


@pytest.mark.parametrize("n,case", WINDOWED)
def test_the_window_dropped_control_lands_beyond_the_sm90_limit(n, case):
    b, h, hkv, lq, lk, d, causal, window = case
    q, k, v, out, dout, lse, delta, want, terms = _case(n, *case)
    lse_g, delta_g = R.bwd_prep_ref(q.float(), k.float(), out.float(), dout.float(), causal, None)
    bad = _sm90_emulation(q, k, v, out, dout, causal, None, lse_g, delta_g)
    assert max(flash_bwd_error(g, w, t)[1] for g, w, t in zip(bad, want, terms)) > 1.0


@pytest.mark.parametrize("n,case", GROUPED)
def test_the_group_sum_dropped_control_lands_beyond_the_sm90_limit(n, case):
    b, h, hkv, lq, lk, d, causal, window = case
    q, k, v, out, dout, lse, delta, want, terms = _case(n, *case)
    g = h // hkv
    rows = lse.reshape(b, h, lq)[:, ::g].reshape(b * hkv, lq)
    drows = delta.reshape(b, h, lq)[:, ::g].reshape(b * hkv, lq)
    bad = _sm90_emulation(q[:, ::g], k, v, out[:, ::g], dout[:, ::g], causal, window, rows, drows)
    assert max(flash_bwd_error(gr, w, t)[1]
               for gr, w, t in zip(bad[1:], want[1:], terms[1:])) > 1.0


CASES = [
    (2, 2, 2, 9, 9, 8, True, None),
    (1, 4, 2, 7, 13, 16, True, 4),
    (1, 8, 1, 5, 12, 16, True, None),
    (1, 4, 2, 6, 15, 8, False, 5),
    (3, 2, 1, 1, 20, 32, True, 7),
]


@pytest.mark.parametrize("b,h,hkv,lq,lk,d,causal,window", CASES)
def test_attention_lse_ref_gives_the_output_and_the_preps_log_sum_exp(b, h, hkv, lq, lk, d,
                                                                     causal, window):
    rng = np.random.default_rng(lq * lk)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((b, h, lq, d), (b, hkv, lk, d), (b, hkv, lk, d), (b, h, lq, d)))
    out, lse = R.attention_lse_ref(q, k, v, causal, window)
    assert torch.equal(out, R.attention_ref(q, k, v, causal, window))
    want_lse, want_delta = R.bwd_prep_ref(q, k, out, g, causal, window)
    assert lse.dtype == torch.float32 and lse.shape == (b * h, lq)
    assert torch.equal(lse, want_lse)
    # Given that lse, the backward computes delta alone: the same gradients.
    for got, want in zip(R.attention_bwd_ref(q, k, v, out, g, causal, window, lse=lse),
                         R.attention_bwd_ref(q, k, v, out, g, causal, window), strict=True):
        assert torch.equal(got, want)


@pytest.mark.parametrize("b,h,hkv,lq,lk,d,causal,window", CASES)
def test_cpu_flash_attention_saves_its_lse_and_gives_the_jax_vjp(b, h, hkv, lq, lk, d, causal,
                                                                window):
    rng = np.random.default_rng(lq + lk + d)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, lq, h, d), (b, lk, hkv, d), (b, lk, hkv, d)))
    g = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_attention(q_, k_, v_, causal=causal, window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*(t.transpose(1, 2) for t in leaves), causal=causal, window=window)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and saved[4] is not None
    assert torch.equal(saved[4], R.bwd_prep_ref(*(t.detach().transpose(1, 2) for t in leaves[:2]),
                                                out.detach(), out.detach(), causal, window)[0])
    got = torch.autograd.grad(out.transpose(1, 2), leaves, torch.from_numpy(g))
    for gr, w in zip(got, want, strict=True):
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(gr.numpy(), w, rtol=0, atol=BWD_RTOL * scale)
