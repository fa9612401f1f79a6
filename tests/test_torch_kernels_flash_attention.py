"""The port's attention against the JAX package's.

The port's ``flash_attention`` on CPU tensors (its plain version) is held
against the reference's ``attention_ref`` and against the Pallas kernel in
interpret mode (``force_kernel=True``), within ``rtol=atol=2e-4`` for
float32 and ``3e-2`` for bfloat16: the tolerances of
``tests/test_kernels_flash_attention.py``.  GQA inputs (Hkv < H) are held
against the reference fed K/V repeated over each head group.  Every case
stays at 256 keys or fewer: the Pallas kernel runs interpreted.

The CUDA launcher's variants are checked here where the CPU can: which
variant each input takes (``flash_route``), the decode variant's split
plan and its plain split and merge (``decode_partials_ref``,
``combine_ref``) against ``attention_ref``, the sm90 variant's bf16
limit (``FLASH_TOL`` plus ``P_ROUNDING`` times the plain attention of
|v|, ``tests/_torch_parity.py``) against an emulation of its arithmetic
over ``FLASH_CASES`` (the 2048-token cases on their last 64 query rows),
and the resident variant's arithmetic (TF32 tensor-core products in the
3xTF32 split, an online softmax in base 2 over chunks of 32 keys) against
``attention_ref`` within the fp32 ``FLASH_TOL``, with one TF32 product or
a missing rescale caught beyond it.  BERT4Rec's call (fp32, not causal,
Lq = Lk = 200, D = 32) is among the plain version's cases against the
reference and its Pallas kernel.
"""

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from _torch_parity import (FLASH_CASES, flash_close, flash_error, flash_inputs, p_rounding_term,
                           tf32_cut, tf32_product, tf32_round)
from repro_torch.kernels import build as B
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention.ref import NEG_INF, combine_ref, decode_partials_ref

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
    (2, 2, 2, 200, 200, 32, False, None),  # BERT4Rec's call: the resident variant
]
# The Pallas kernel needs Lq and Lk to be multiples of min(128, L).
PALLAS_CASES = [
    (1, 2, 2, 128, 256, 32, True, None),
    (1, 2, 2, 128, 128, 64, True, 64),
    (2, 2, 2, 1, 256, 32, True, None),
    (1, 4, 2, 128, 128, 32, True, 32),
    (1, 1, 1, 64, 64, 16, False, None),
    (2, 2, 2, 200, 200, 32, False, None),  # BERT4Rec's call, in one 200-row tile
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
    # tiles of min(128, L), or the whole length where 128 does not divide it
    tiles = {f"tile_{n}": 128 if length % min(128, length) == 0 else length
             for n, length in (("q", lq), ("k", lk))}
    want = np.asarray(jax_flash_attention(q, _repeat(k, g), _repeat(v, g), causal=causal,
                                          window=window, force_kernel=True, **tiles))
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


# ---- the variants of the CUDA launcher, on the CPU: their dispatch, the
# decode variant's split plan and plain split/merge, and the sm90 variant's
# bf16 limit ----

SMS = 132  # an H100's SMs: the decode plan the card would choose


def _cpu_case(b, h, hkv, lq, lk, d, dtype, seed, rows_kept=None):
    """``flash_inputs`` on the CPU; with ``rows_kept`` only the last query
    rows (the same rows of the full case: queries are aligned to the end of
    the keys), to bound the CPU's memory at the 2048-token cases."""
    q, k, v = flash_inputs(torch.device("cpu"), dtype, b, h, hkv, lq, lk, d, seed=seed)
    if rows_kept is not None and lq > rows_kept:
        q = q[:, :, lq - rows_kept:]
    return q, k, v


def _route(case, dtype):
    b, h, hkv, lq, lk, d, causal, window = case
    return FK.flash_route(dtype, h, hkv, lq, lk, d, causal, window)


def test_flash_route_picks_each_variant_by_dtype_and_shape():
    lm = [(8, 8, 4, 2048, 2048, 256), (8, 8, 4, 1, 2064, 256)]
    assert [FK.flash_route(torch.bfloat16, h, hkv, lq, lk, d, True, None)
            for _, h, hkv, lq, lk, d in lm] == ["sm90", "decode"]
    assert FK.flash_route(torch.float32, 8, 4, 2048, 2048, 256, True, None) == "general"
    assert FK.flash_route(torch.float32, 8, 4, 1, 2048, 256, True, None) == "decode"
    # D outside SM90_HEAD_DIMS
    assert FK.flash_route(torch.bfloat16, 2, 2, 40, 40, 80, True, None) == "general"
    assert FK.flash_route(torch.bfloat16, 8, 1, 1, 64, 64, True, None) == "decode"  # 8 rows
    assert FK.flash_route(torch.bfloat16, 3, 1, 3, 64, 64, True, None) == "sm90"  # 9 rows
    assert FK.flash_route(torch.float32, 3, 1, 3, 64, 64, True, None) == "general"
    # 8 bytes a row: no 16-byte loads
    assert FK.flash_route(torch.bfloat16, 2, 2, 1, 4, 4, True, None) == "general"
    routes = {_route(c, t) for c in FLASH_CASES for t in (torch.float32, torch.bfloat16)}
    assert routes == {"decode", "sm90", "resident", "general"}


# (dtype, H, Hkv, Lq, Lk, D, causal, window) -> the variant: BERT4Rec's
# call takes the resident variant; a causal, windowed, bf16, too long or
# too wide call, or a D that is no multiple of 4, keeps the general one.
ROUTE_CASES = [
    ((torch.float32, 2, 2, 200, 200, 32, False, None), "resident"),  # BERT4Rec's call
    ((torch.float32, 4, 2, 37, 300, 64, False, None), "resident"),  # GQA 2
    ((torch.float32, 2, 2, 100, 130, 64, False, None), "resident"),  # the widest D
    ((torch.float32, 2, 2, 20, 904, 32, False, None), "resident"),  # the most keys at D <= 32
    ((torch.float32, 2, 2, 20, 905, 32, False, None), "general"),  # K and V past 227 KB
    ((torch.float32, 2, 2, 200, 200, 32, True, None), "general"),  # causal
    ((torch.float32, 2, 2, 200, 200, 32, False, 64), "general"),  # a window
    ((torch.bfloat16, 2, 2, 200, 200, 32, False, None), "general"),  # bf16
    ((torch.float32, 2, 2, 200, 200, 30, False, None), "general"),  # D not a multiple of 4
    ((torch.float32, 2, 2, 200, 200, 80, False, None), "general"),  # D past 64
    ((torch.float32, 2, 2, 1, 200, 32, False, None), "decode"),  # two rows a group
]


@pytest.mark.parametrize("args,want", ROUTE_CASES, ids=[str(c[0][1:]) for c in ROUTE_CASES])
def test_flash_route_sends_bert4recs_call_to_the_resident_variant(args, want):
    assert FK.flash_route(*args) == want
    if want == "resident":
        assert FK.resident_smem_bytes(args[4], args[5]) <= FK.RESIDENT_SMEM_BYTES


@pytest.mark.parametrize("lq,bhkv,want", [(200, 65536, 208), (200, 264, 208), (200, 100, 80),
                                          (2048, 2, 64), (50, 1, 64), (1000, 8, 64),
                                          (1000, 66, 256)])
def test_resident_q_chunk_fills_the_card_in_whole_warp_tiles(lq, bhkv, want):
    chunk = FK.resident_q_chunk(lq, bhkv, SMS)
    assert chunk == want
    assert chunk % FK.RESIDENT_TILE_ROWS == 0 and chunk >= FK.RESIDENT_MIN_CHUNK
    blocks = bhkv * -(-lq // chunk)
    assert blocks >= FK.RESIDENT_BLOCKS_PER_SM * SMS or chunk == FK.RESIDENT_MIN_CHUNK \
        or chunk >= lq


@pytest.mark.parametrize("lq,lk,window,bhkv", [
    (1, 2064, None, 32), (1, 2064, 1024, 32), (1, 1, None, 4), (1, 20, None, 4),
    (2, 77, 16, 2), (1, 2064, 1, 16), (1, 2049, 2**30, 16), (8, 5000, None, 1)])
def test_decode_plan_covers_the_visible_keys_in_whole_splits(lq, lk, window, bhkv):
    j_begin, j_end, chunk, n = FK.decode_plan(lq, lk, window, bhkv, SMS)
    first_lo = lk - lq - window + 1 if window is not None else 0
    assert (j_begin, j_end) == (max(0, first_lo), lk)
    assert chunk % FK.DECODE_CHUNK_STEP == 0 and chunk >= FK.DECODE_CHUNK_STEP
    assert j_begin + (n - 1) * chunk < j_end <= j_begin + n * chunk  # no empty split
    if lk - j_begin >= FK.DECODE_BLOCKS_PER_SM * SMS * FK.DECODE_CHUNK_STEP // bhkv:
        assert n * bhkv >= FK.DECODE_BLOCKS_PER_SM * SMS * 0.9  # several blocks an SM


@pytest.mark.parametrize("case", [c for c in FLASH_CASES if _route(c, torch.float32) == "decode"],
                         ids=str)
def test_decode_split_and_combine_plain_equal_attention_ref(case):
    b, h, hkv, lq, lk, d, causal, window = case
    q, k, v = _cpu_case(b, h, hkv, lq, lk, d, torch.float32, seed=lk + d)
    plan = FK.decode_plan(lq, lk, window, b * hkv, SMS)
    ml, acc = decode_partials_ref(q, k, v, causal, window, plan)
    assert ml.shape == (b * hkv, plan[3], lq * h // hkv, 2) and acc.shape[-1] == d
    got = combine_ref(ml, acc, b, h, hkv, lq, torch.float32)
    torch.testing.assert_close(got, attention_ref(q, k, v, causal=causal, window=window), **TOL)


def _emulate_sm90(q, k, v, causal, window, drop_last_key=False):
    """The sm90 variant's arithmetic on the CPU: fp32 scores and softmax,
    P rounded to bf16 for P·V, l the sum of the fp32 p, the output rounded
    to bf16.  ``drop_last_key`` masks the newest key (a fault)."""
    h, lq, d = q.shape[1], q.shape[2], q.shape[3]
    lk, g = k.shape[2], h // k.shape[1]
    kf, vf = (x.float().repeat_interleave(g, dim=1) for x in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (1.0 / d**0.5)
    i = torch.arange(lq)[:, None] + (lk - lq)
    j = torch.arange(lk)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    if drop_last_key:
        mask &= j < lk - 1
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=3, keepdim=True))
    out = torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(), vf) / p.sum(dim=3, keepdim=True)
    return out.bfloat16()


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_sm90_bf16_limit_holds_the_emulation_and_catches_faults(case):
    """The sm90 variant's limit (FLASH_TOL plus P_ROUNDING times the plain
    attention of |v|) holds its CPU emulation at every case, and a dropped
    key or an ignored (binding) window lands beyond it."""
    b, h, hkv, lq, lk, d, causal, window = case
    q, k, v = _cpu_case(b, h, hkv, lq, lk, d, torch.bfloat16, seed=lq + lk + d, rows_kept=64)
    args = (q.float(), k.float(), v.float())
    want = attention_ref(*args, causal=causal, window=window)
    extra = p_rounding_term(q, k, v, causal, window)
    flash_close(_emulate_sm90(q, k, v, causal, window), want, extra)
    if lk > 1:  # a lone key, masked, is still averaged in (NEG_INF, not -inf)
        assert flash_error(_emulate_sm90(q, k, v, causal, window, drop_last_key=True), want,
                           extra)[1] > 1.0
    if window is not None and window < lk:
        assert flash_error(_emulate_sm90(q, k, v, causal, None), want, extra)[1] > 1.0


def _emulate_resident(q, k, v, fault=None):
    """The resident variant's arithmetic on the CPU: q pre-multiplied by
    scale·log2 e in float32, the scores and P·V in the 3xTF32 split
    (``_torch_parity.tf32_product``), an online softmax in float32 over chunks of
    ``FK_KEYS`` keys in base 2 (running max m, sum l, accumulator rescaled
    by exp2(m - m_new) at each chunk), the end divided by max(l, 1e-30).
    ``fault``: ``"single_tf32"`` takes one TF32 product instead of three,
    ``"no_rescale"`` leaves the accumulator and sum unscaled."""
    h, d = q.shape[1], q.shape[3]
    lk, g = k.shape[2], h // k.shape[1]
    kf, vf = (x.float().repeat_interleave(g, dim=1) for x in (k, v))
    scale_log2 = torch.tensor((1.0 / d**0.5) * 1.4426950408889634, dtype=torch.float32)
    single = fault == "single_tf32"
    s = tf32_product(q.float() * scale_log2, kf, "bhqd,bhkd->bhqk", single)
    m = torch.full(q.shape[:3] + (1,), NEG_INF)
    l = torch.zeros(q.shape[:3] + (1,))
    acc = torch.zeros(q.shape, dtype=torch.float32)
    for j0 in range(0, lk, FK_KEYS):
        part = s[..., j0:j0 + FK_KEYS]
        m_new = torch.maximum(m, part.amax(dim=3, keepdim=True))
        alpha = torch.exp2(m - m_new) if fault != "no_rescale" else torch.ones_like(m)
        p = torch.exp2(part - m_new)
        l = l * alpha + p.sum(dim=3, keepdim=True)
        acc = acc * alpha + tf32_product(p, vf[:, :, j0:j0 + FK_KEYS], "bhqk,bhkd->bhqd",
                                          single)
        m = m_new
    return acc / l.clamp_min(1e-30)


FK_KEYS = 32  # csrc/flash_attention.cu FR_KEYS: the resident variant's key chunk


def test_tf32_rounds_to_nearest_with_ties_away_from_zero():
    step = 2.0**-10  # TF32's unit in the last place at 1
    x = torch.tensor([1.0, 1.0 + step / 2, -(1.0 + step / 2), 1.0 + step / 2 - 2.0**-20,
                      1.0 + 3 * step / 2, 3.0e-5])
    want = torch.tensor([1.0, 1.0 + step, -(1.0 + step), 1.0, 1.0 + 2 * step,
                         float(np.float32(3.0e-5))])
    got = tf32_round(x)
    assert torch.equal(got[:5], want[:5])
    assert abs(float(got[5]) - 3.0e-5) <= 3.0e-5 * 2.0**-11
    hi = tf32_round(x)
    assert float(((x - hi).abs() / x.abs()).max()) <= 2.0**-11  # lo: at most half a TF32 unit
    residue = (x - hi - tf32_cut(x - hi)).abs() / x.abs()  # what the split leaves out
    assert float(residue.max()) < 2.0**-21


@pytest.mark.parametrize("case", [c for c in FLASH_CASES if _route(c, torch.float32) == "resident"],
                         ids=str)
def test_resident_3xtf32_split_is_within_flash_tol_and_one_tf32_product_is_not(case):
    """The split, not the kernel, meets the fp32 limit: the emulation of
    the resident variant's arithmetic lies within ``FLASH_TOL`` of the
    plain version, while one TF32 product (or a missing rescale) lands
    beyond it."""
    b, h, hkv, lq, lk, d, causal, window = case
    q, k, v = _cpu_case(b, h, hkv, lq, lk, d, torch.float32, seed=lq + lk + d)
    want = attention_ref(q, k, v, causal=False)
    flash_close(_emulate_resident(q, k, v), want)
    assert flash_error(_emulate_resident(q, k, v, fault="single_tf32"), want)[1] > 1.0
    if lk > FK_KEYS:  # more than one chunk: the rescale matters
        assert flash_error(_emulate_resident(q, k, v, fault="no_rescale"), want)[1] > 1.0
