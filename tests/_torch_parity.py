"""Helpers shared by the ``test_torch_*`` parity suites: carry a fitted
state of the JAX package across to the PyTorch port as numpy arrays; and
the flash-attention kernel's cases, inputs and tolerance, which
``chip_smoke.py`` uses too.  It imports no JAX."""

import numpy as np


def arrays_of(res) -> dict:
    """The fitted state of a ``repro.core.seclud.SecludResult`` as the
    numpy arrays ``repro_torch.core.seclud.result_from_arrays`` takes."""
    hier = res.hier_index
    levels = hier.levels
    return {
        "assign": np.asarray(res.assign),
        "perm": np.asarray(res.perm),
        "ranges": np.asarray(res.ranges),
        "post_ptr": np.asarray(hier.index.post_ptr),
        "post_docs": np.asarray(hier.index.post_docs),
        "level_ranges": [np.asarray(r) for r in res.level_ranges],
        "level_assigns": [np.asarray(a) for a in res.level_assigns],
        "level_cl_ptr": [lev.cl_ptr for lev in levels],
        "level_cl_ids": [lev.cl_ids for lev in levels],
        "level_seg_start": [lev.seg_start for lev in levels],
        "level_seg_end": [lev.seg_end for lev in levels],
        "psi": res.psi,
        "psi_single": res.psi_single,
        "psi_levels": res.psi_levels,
        "base_perm": np.asarray(res.base_perm),
        "bucket_size_clusters": hier.bucket_size_clusters,
        "bucket_size_postings": hier.bucket_size_postings,
    }


def port_result(res):
    """The port's ``SecludResult`` serving the same index as ``res``."""
    from repro_torch.core.seclud import result_from_arrays

    return result_from_arrays(arrays_of(res))


def ragged_queries(rng, n_q, n_terms, max_arity=5, dup_rate=0.25):
    """Random query lists of arity 1..max_arity, some with a duplicated
    term (∩ is idempotent)."""
    lists = []
    for _ in range(n_q):
        a = int(rng.integers(1, max_arity + 1))
        t = rng.integers(0, n_terms, a).tolist()
        if a >= 2 and rng.random() < dup_rate:
            t[1] = t[0]
        lists.append(t)
    return lists


def make_rows(rng, b, ls, ll, universe, holes=False):
    """(b, ls) short and (b, ll) long int32 rows of sorted distinct doc
    ids drawn from ``range(universe)``, PAD-padded; with ``holes`` about
    30 % of the short cells become PAD holes."""
    from repro_torch.kernels.intersect.ref import PAD

    short = np.full((b, ls), PAD, dtype=np.int32)
    long = np.full((b, ll), PAD, dtype=np.int32)
    for r in range(b):
        ns, nl = rng.integers(0, ls + 1), rng.integers(0, ll + 1)
        short[r, :ns] = np.sort(rng.choice(universe, size=ns, replace=False))
        long[r, :nl] = np.sort(rng.choice(universe, size=nl, replace=False))
    if holes:
        short[rng.random(short.shape) < 0.3] = PAD
    return short, long


# (B, H, Hkv, Lq, Lk, D, causal, window) of the flash-attention kernel's
# checks against its plain version on the card (chip_smoke.py and
# tests/test_torch_cuda_kernels.py): Lq = 1, Lq = Lk, ragged Lk > Lq, D in
# {16, 64, 80, 128, 256}, windows None / 1 / 8 / 1024 / 2**30, causal False,
# H / Hkv in {1, 2, 3, 4, 8, 16}, and the LM path's own shapes (gemma3-4b,
# 8 requests: a global layer's decode over 2064 keys, a local and a global
# layer's 2048-token prefill, where the window skips key tiles).  The
# variants' edges (kernel.flash_route): decode with Lk below one split,
# Lk = 1, a window of one key, a ragged key tail (2049), two query
# positions and the largest group (8 rows); sm90 prefill with one partial
# key tile, 9 rows (just past the decode limit, H/Hkv odd) and a single
# key at H/Hkv = 16.
FLASH_CASES = [
    (2, 4, 4, 1, 300, 64, True, None), (1, 2, 2, 128, 128, 64, True, None),
    (2, 4, 2, 37, 100, 128, True, 8), (1, 8, 2, 1, 2064, 256, True, 1024),
    (1, 8, 4, 64, 2049, 256, True, 2**30), (2, 2, 1, 50, 50, 16, False, None),
    (1, 4, 4, 33, 70, 16, False, 8), (1, 2, 2, 100, 100, 64, True, 1),
    (1, 4, 1, 200, 200, 128, True, 1024), (1, 2, 2, 40, 40, 80, True, None),
    (2, 8, 4, 300, 300, 256, True, 1024), (8, 8, 4, 1, 2064, 256, True, 2**30),
    (8, 8, 4, 2048, 2048, 256, True, 1024), (8, 8, 4, 2048, 2048, 256, True, 2**30),
    (2, 4, 2, 1, 20, 128, True, None), (1, 4, 4, 1, 1, 64, True, None),
    (2, 8, 4, 1, 2064, 256, True, 1), (2, 8, 4, 1, 2049, 256, True, 2**30),
    (1, 4, 2, 2, 77, 128, True, 16), (1, 8, 1, 1, 500, 64, True, None),
    (1, 2, 1, 10, 10, 128, True, None), (1, 3, 1, 3, 90, 64, True, None),
    (1, 16, 1, 1, 1, 64, True, None), (1, 4, 2, 70, 130, 64, False, 32),
]
# The counter of each attention variant's kernels (kernel.flash_route picks
# one a call; decode launches its split kernel and its combine), and what a
# call of each variant adds to them.
FLASH_VARIANTS = ("flash_attention_sm90", "flash_attention_decode", "flash_attention_combine",
                  "flash_attention_general")
VARIANT_LAUNCHES = {
    "decode": {"flash_attention_decode": 1, "flash_attention_combine": 1},
    "sm90": {"flash_attention_sm90": 1},
    "general": {"flash_attention_general": 1},
}
# (rtol, atol) of the kernel's output against the plain version computed
# in float32 from the same inputs (TF32 off).  float32: the reference's
# tolerance (tests/test_kernels_flash_attention.py:50-51).  bfloat16: the
# kernel computes in fp32 and rounds its output to the nearest bf16 once,
# so it lies within half a bf16 step, 2**-8 of |want|, plus the fp32
# difference; atol bounds that difference at eight times the largest the
# float32 cases read on the card (1.19e-6).  The reference's bf16
# tolerance (3e-2, :88) is about the size of a decode output at head dim
# 256, too wide to see a key tile dropped.
FLASH_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2**-8, 1e-5)}
# The sm90 prefill variant also rounds each probability p_j to bf16 for
# the P·V product (the row sum l stays the sum of the fp32 p).  A rounding
# moves p_j by at most the bf16 unit roundoff, 2**-8 · p_j, so an output
# element moves by at most 2**-8 · Σ_j p_j |v_jd| / l: P_ROUNDING times the
# plain attention of |v| (``p_rounding_term``).  That variant's limit adds
# this term to FLASH_TOL; the fp32 and decode variants keep FLASH_TOL.
P_ROUNDING = 2**-8


def p_rounding_term(q, k, v, causal, window):
    """``P_ROUNDING`` times the plain attention of |v| (float32): the sm90
    variant's extra limit per output element."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    return P_ROUNDING * attention_ref(q.float(), k.float(), v.float().abs(), causal=causal,
                                      window=window)


def flash_inputs(device, dtype, b, h, hkv, lq, lk, d, seed, model_layout=False):
    """q (B, H, Lq, D) and k, v (B, Hkv, Lk, D), standard normal from a
    seeded generator on ``device``; with ``model_layout`` they are
    (B, H, L, D) views of (B, L, H, D) buffers, as the model passes them."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    bufs = [torch.randn(shape, generator=gen, device=device).to(dtype)
            for shape in ((b, lq, h, d), (b, lk, hkv, d), (b, lk, hkv, d))]
    if model_layout:
        return [t.transpose(1, 2) for t in bufs]
    return [t.transpose(1, 2).contiguous() for t in bufs]


def flash_error(got, want, extra=None) -> tuple[float, float]:
    """The largest |got - want| of the kernel's output ``got`` against the
    plain version ``want`` (float32), and the largest share of its limit
    ``atol + rtol·|want|`` (``FLASH_TOL`` of got's dtype), plus ``extra``
    where given (``p_rounding_term`` for the sm90 variant); raises when the
    shapes differ or ``got`` is not finite."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} vs {tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0, 0.0
    rtol, atol = FLASH_TOL[str(got.dtype).removeprefix("torch.")]
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite output")
    err = (got - want).abs()
    limit = atol + rtol * want.abs()
    if extra is not None:
        limit = limit + extra
    return float(err.max()), float((err / limit).max())


def flash_close(got, want, extra=None) -> tuple[float, float]:
    """``flash_error``, raising when an element lies outside its limit."""
    err, share = flash_error(got, want, extra)
    if share > 1.0:
        rtol, atol = FLASH_TOL[str(got.dtype).removeprefix("torch.")]
        plus = "" if extra is None else " + P_ROUNDING·attention(|v|)"
        raise AssertionError(f"disagrees with the plain version beyond rtol={rtol}, atol={atol}"
                             f"{plus} (max |err| {err}, {share:.3g} of the limit)")
    return err, share
