"""The one-launch decode and the two-launch sm90 backward, where the CPU
can check them.

On the card a decode call is one launch of the split kernel, whose last
block of each (batch, KV head) merges the splits with the combine kernel's
arithmetic (``combine_ref`` is the plain version of both), and the sm90
backward given the forward's log-sum-exp is dQ, which computes delta, then
dK/dV, which reads it.  Here: the launch designs the card tests and
``chip_smoke.py`` hold the kernels to, ``combine_ref`` over one split and
over many against the port's and the JAX package's attention, which
kernels the backward launches with the forward's log-sum-exp and without
it (the forwards that save one), the counter buffer's sizing, and the
checks the launchers make before any device work.
"""

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from _torch_parity import FLASH_VARIANTS, VARIANT_LAUNCHES
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention.ref import (attention_ref, combine_ref,
                                                     decode_partials_ref)

TOL = dict(rtol=2e-4, atol=2e-4)
SMS = 132  # an H100's SMs: the decode plan the card would choose

# (route, lse given, the kernels one backward call launches, in order)
BWD_LAUNCHES = [
    ("sm90", True, ("flash_bwd_dq_sm90", "flash_bwd_dkdv_sm90")),
    ("sm90", False, ("flash_bwd_prep", "flash_bwd_dkdv_sm90", "flash_bwd_dq_sm90")),
    ("resident", True, ("flash_bwd_resident",)),
    ("resident", False, ("flash_bwd_prep", "flash_bwd_resident")),
    ("general", True, ("flash_bwd_prep", "flash_bwd_dkdv", "flash_bwd_dq")),
    ("general", False, ("flash_bwd_prep", "flash_bwd_dkdv", "flash_bwd_dq")),
]


def test_a_decode_call_is_one_launch_of_the_split_kernel():
    assert VARIANT_LAUNCHES["decode"] == {"flash_attention_decode": 1}
    for want in VARIANT_LAUNCHES.values():  # the combine is the mesh decode's alone
        assert set(want) <= set(FLASH_VARIANTS) - {"flash_attention_combine"}
        assert sum(want.values()) == 1


@pytest.mark.parametrize("route,lse_given,want", BWD_LAUNCHES)
def test_backward_launches_given_the_lse_and_without(route, lse_given, want):
    assert FK.bwd_launches(route, lse_given) == want


def test_the_sm90_dq_writes_delta_before_the_dkdv_that_reads_it():
    order = FK.bwd_launches("sm90", True)
    assert "flash_bwd_prep" not in order
    assert order.index("flash_bwd_dq_sm90") < order.index("flash_bwd_dkdv_sm90")


# (dtype, H, Hkv, Lq, Lk, D, causal, window, the forward's route): the LM
# training layers (gemma3-4b, qwen3-moe-30b-a3b) and a one-row decode call
# at bf16, BERT4Rec's fp32 call.
FORWARDS = [
    (torch.bfloat16, 8, 4, 4096, 4096, 256, True, 1024, "sm90"),
    (torch.bfloat16, 32, 4, 4096, 4096, 128, True, None, "sm90"),
    (torch.bfloat16, 2, 2, 1, 50, 128, True, None, "decode"),
    (torch.float32, 2, 2, 200, 200, 32, False, None, "resident"),
]


@pytest.mark.parametrize("dtype,h,hkv,lq,lk,d,causal,window,forward", FORWARDS)
def test_the_backward_drops_prep_exactly_where_the_forward_saved_its_lse(dtype, h, hkv, lq, lk,
                                                                         d, causal, window,
                                                                         forward):
    """The sm90 and resident forwards save each row's log-sum-exp
    (``flash_attention_lse_cuda``); the decode forward does not, so its
    backward recomputes it in prep first."""
    assert FK.flash_route(dtype, h, hkv, lq, lk, d, causal, window) == forward
    route = FK.bwd_route(dtype, h, hkv, lq, lk, d, causal, window)
    launched = FK.bwd_launches(route, forward in ("sm90", "resident"))
    assert ("flash_bwd_prep" in launched) == (forward == "decode")


def _qkv(seed, b, h, hkv, lq, lk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, lq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, lk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, lk, d)).astype(np.float32))


# (B, H, Hkv, Lk, window, SMs of the plan): one split (one SM and enough
# (batch, KV head) pairs, or a single key) and many (an H100's SMs over few
# pairs: splits of 32 keys, a window that starts inside the keys, a group
# of 4 and of 8).
MERGE_CASES = [
    (4, 4, 4, 300, None, 1), (1, 2, 2, 1, None, SMS), (1, 8, 2, 300, None, SMS),
    (2, 4, 1, 257, 100, SMS), (1, 8, 1, 64, None, SMS),
]


@pytest.mark.parametrize("b,h,hkv,lk,window,sms", MERGE_CASES)
def test_combine_ref_merges_one_split_or_many_into_the_attention(b, h, hkv, lk, window, sms):
    d = 32
    q, k, v = _qkv(lk + h, b, h, hkv, 1, lk, d)
    plan = FK.decode_plan(1, lk, window, b * hkv, sms)
    assert (plan[3] == 1) == (sms == 1 or lk == 1)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    ml, acc = decode_partials_ref(qt, kt, vt, True, window, plan)
    got = combine_ref(ml, acc, b, h, hkv, 1, torch.float32)
    torch.testing.assert_close(got, attention_ref(qt, kt, vt, causal=True, window=window), **TOL)
    g = h // hkv
    want = np.asarray(jax_attention_ref(q, np.repeat(k, g, axis=1), np.repeat(v, g, axis=1),
                                        causal=True, window=window))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("need,have,want", [
    (1, 0, 1), (5, 8, 8), (8, 8, 8), (9, 8, 16), (100, 8, 100), (65537, 0, 65537),
    (65538, 65537, 131074)])
def test_the_counter_buffer_grows_only_when_outgrown(need, have, want):
    got = FK.decode_counter_numel(need, have)
    assert got == want and got >= need
    assert FK.decode_counter_numel(need, got) == got  # a second call keeps it


def test_the_card_only_entry_points_refuse_cpu_tensors_before_any_work():
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(0, 1, 4, 2, 1, 40, 64))
    assert FK.flash_route(q.dtype, 4, 2, 1, 40, 64, True, None) == "decode"
    with pytest.raises(ValueError, match="CUDA"):
        FK._decode_two_kernels_forced(q, k, v)
    assert FK.decode_counters(torch.device("cpu")) is None
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(1, 1, 4, 2, 8, 8, 64))
    lse = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        FK.bwd_dq_delta_sm90_cuda(q, k, v, q, q, lse)
    # O with a position stride of 68 bf16 values (136 bytes), off 16 bytes
    wide = torch.zeros((1, 4, 8, 68), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        FK.bwd_dq_delta_sm90_cuda(q, k, v, wide, q, lse)
    with pytest.raises(ValueError, match="16-byte"):
        FK.flash_attention_bwd_cuda(q, k, v, wide, q, lse=lse)
