"""Helpers shared by the ``test_torch_*`` parity suites: carry a fitted
state of the JAX package across to the PyTorch port as numpy arrays; the
flash-attention kernel's cases, inputs and tolerance; hand-built fold
layouts; and CPU emulations of the fold's and the staged scoring kernel's
algorithms, which the kernels must match bit for bit on the card.
``chip_smoke.py`` uses them too.  It imports no JAX."""

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


# ----------------------------------------------------------------------
# Emulations of the redesigned search fold and δ⁺ scoring kernels
# ----------------------------------------------------------------------

# csrc/fold.cu: the width of a block's per-query count table, the block.
FOLD_QUERY_TABLE = 512
FOLD_BLOCK = 256
WARP = 32


def fold_emulation(post_docs, cells, stage_seg, group_width, stage_iters, n_queries_pad,
                   return_members, query_table=FOLD_QUERY_TABLE):
    """The algorithm of ``csrc/fold.cu`` in plain torch: the reference's
    fixed-step search per live cell and stage, stage totals summed per
    block, and the counts merged per warp by query, then per block into a
    table of ``query_table`` entries from the block's smallest query (a
    query beyond it is added per warp), then added once per non-zero
    entry.  Returns ``(counts, entering, members, stats)``; ``stats``
    counts the global count atomics, those from block tables and those
    added directly."""
    import torch

    from repro_torch.kernels.intersect.ref import PAD, _search_segments

    pad = int(PAD)
    n_post = post_docs.shape[0]
    post, group, query, arity = (cells[r].long() for r in range(4))
    block = torch.arange(cells.shape[1]) // FOLD_BLOCK
    if n_post:
        cur = torch.where(post != pad, post_docs[post.clamp(0, n_post - 1)].long(), pad)
    else:
        cur = torch.full_like(post, pad)
    entering = torch.zeros(len(stage_iters), dtype=torch.int32)
    for s, iters in enumerate(stage_iters):
        live = (arity > s + 1) & (cur != pad)
        per_block = torch.zeros(int(block.max()) + 1 if block.numel() else 0, dtype=torch.long)
        per_block.index_add_(0, block[live], torch.ones_like(block[live]))
        entering[s] = int(per_block.sum())
        seg = stage_seg[:, s * group_width : (s + 1) * group_width].long()
        idx = live.nonzero().squeeze(1)
        lo = seg[0][group[idx]]
        found = _search_segments(post_docs, cur[idx].to(post_docs.dtype), lo,
                                 lo + seg[1][group[idx]], int(iters))
        cur[idx[~found]] = pad
    counted = (cur != pad) & (query >= 0) & (query < n_queries_pad)
    idx = counted.nonzero().squeeze(1)
    pairs, per_pair = torch.unique(torch.stack([idx // WARP, query[idx]]), dim=1,
                                   return_counts=True)
    counts = torch.zeros(n_queries_pad, dtype=torch.int32)
    stats = {"count_atomics": 0, "table_atomics": 0, "direct_atomics": 0}
    pair_block = pairs[0] // (FOLD_BLOCK // WARP)
    for b in torch.unique(pair_block).tolist():
        qs, cs = pairs[1][pair_block == b], per_pair[pair_block == b]
        q0 = int(qs.min())
        near = qs - q0 < query_table
        table = torch.zeros(query_table, dtype=torch.long).index_add_(0, qs[near] - q0, cs[near])
        nz = table.nonzero().squeeze(1)
        counts.index_add_(0, nz + q0, table[nz].to(torch.int32))
        counts.index_add_(0, qs[~near], cs[~near].to(torch.int32))
        stats["table_atomics"] += int(nz.numel())
        stats["direct_atomics"] += int((~near).sum())
    stats["count_atomics"] = stats["table_atomics"] + stats["direct_atomics"]
    members = cur.to(torch.int32) if return_members else None
    return counts, entering, members, stats


def staged_scores_emulation(ell, p, tables, base_misalignment=0):
    """The summation order of the ``staged`` variant of
    ``csrc/cluster_score.cu`` in plain fp32 torch: W = p[r] * tables[r, :]
    (columns padded to a power of two); each row is read as the 16-byte
    blocks that cover it (``base_misalignment`` int32 elements of the
    first block lie before ell's base, so a row starts ``(d * L + mis) %
    4`` elements into its first block); block ``m`` of a row goes to lane
    ``m % 32``; each lane adds the W rows of its valid slots in slot order,
    and an xor-shuffle tree (16, 8, 4, 2, 1) combines the lanes.  The same
    fp32 additions in the same order as the kernel, so its result should
    be bit-equal."""
    import torch

    from repro_torch.kernels.cluster_score.kernel import padded_k

    n, l = ell.shape
    tc, k = tables.shape
    kp = padded_k(k)
    w = torch.zeros((tc, kp), dtype=torch.float32)
    w[:, :k] = p.float()[:, None] * tables.float()
    acc = torch.zeros((n, WARP, kp), dtype=torch.float32)
    lead = (torch.arange(n, dtype=torch.long) * l + base_misalignment) % 4
    lanes = torch.arange(WARP)
    rows = torch.arange(n)[:, None]
    n_blocks = (l + 3 + 3) // 4 if l else 0
    ell = ell.long()
    for m in range(-(-n_blocks // WARP)):
        for q in range(4):
            slot = 4 * (WARP * m + lanes)[None, :] + q - lead[:, None]  # (n, 32)
            inside = (slot >= 0) & (slot < l)
            r = ell[rows, slot.clamp(0, max(l - 1, 0))] if l else torch.zeros_like(slot)
            valid = inside & (r >= 0) & (r < tc)
            add = torch.where(valid[..., None], w[r.clamp(0, tc - 1)], 0.0)
            acc = torch.where(valid[..., None], acc + add, acc)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lanes ^ off]
    return acc[:, 0, :k].contiguous()


def synthetic_fold_case(seed, group_sizes, seg_lens, arities, query_of=None, pad_cells=0.0,
                        hit_rate=0.5, dense_from=None, iters_shift=0, tail=37):
    """A lowered-plan layout for the fold built by hand (numpy int32):
    ``post_docs``, ``cells`` (4, N), ``stage_seg`` (2, S * G), ``group_width``,
    ``stage_iters`` and ``n_queries_pad``.

    Group g has ``group_sizes[g]`` cells (its rank-0 postings, consecutive
    cells as lower_plan writes them), arity ``arities[g]``, and at every
    stage s < arity - 1 a sorted segment of ``seg_lens[g]`` postings that
    holds about ``hit_rate`` of the group's docs (0 gives an empty
    segment).  Segments longer than ``dense_from`` are dense runs of doc
    ids.  ``query_of[g]`` is the group's query (default: three groups a
    query); ``pad_cells`` of the real cells become PAD holes inside their
    group; ``tail`` pad cells follow.  ``iters_shift`` lowers every
    stage's search depth below what resolves the longest segment."""
    from repro_torch.kernels.intersect.ref import PAD

    rng = np.random.default_rng(seed)
    n_groups = len(group_sizes)
    query_of = np.arange(n_groups) // 3 if query_of is None else np.asarray(query_of)
    n_stages = max(max(arities) - 1, 0)
    parts, pos = [], 0

    def put(docs):
        nonlocal pos
        parts.append(np.asarray(docs, np.int32))
        pos += len(docs)
        return pos - len(docs)

    cells, seg = [], np.zeros((2, n_stages, n_groups), np.int64)
    for g, (size, length, arity) in enumerate(zip(group_sizes, seg_lens, arities, strict=True)):
        universe = 4 * max(size, length, 1) + 50
        base = rng.integers(0, 1 << 20)
        docs = np.sort(rng.choice(universe, size, replace=False)) + base
        start = put(docs)
        post = np.arange(start, start + size)
        post[rng.random(size) < pad_cells] = PAD
        cells.append(np.stack([post, np.full(size, g), np.full(size, query_of[g]),
                               np.full(size, arity)]))
        for s in range(arity - 1):
            if length == 0:
                continue
            if dense_from is not None and length > dense_from:
                d0 = int(docs[0]) - int(rng.integers(0, 3))
                other = np.arange(d0, d0 + length)
            else:
                keep = docs[rng.random(size) < hit_rate]
                pool = np.setdiff1d(np.arange(base, base + universe), docs)
                extra = rng.choice(pool, max(length - len(keep), 0), replace=False)
                other = np.sort(np.concatenate([keep, extra]))[:length]
            seg[0, s, g], seg[1, s, g] = put(other), len(other)
    cells = np.concatenate(cells + [np.stack([np.full(tail, PAD), np.full(tail, n_groups),
                                              np.full(tail, int(query_of.max()) + 1),
                                              np.zeros(tail, np.int64)])], axis=1)
    stage_iters = []
    for s in range(n_stages):
        it = max(int(seg[1, s].max()).bit_length(), 1)
        stage_iters.append(max(it + (it & 1) - iters_shift, 1))
    return {
        "post_docs": np.concatenate(parts) if parts else np.zeros(0, np.int32),
        "cells": cells.astype(np.int32),
        "stage_seg": seg.reshape(2, n_stages * n_groups).astype(np.int32),
        "group_width": n_groups,
        "stage_iters": tuple(stage_iters),
        "n_queries_pad": int(query_of.max()) + 1,
    }


# Hand-built fold layouts (keyword arguments of synthetic_fold_case) that
# the kernel must fold bit-identically to the plain version: groups across
# warp (32) and block (256) edges, groups of one cell, long dense segments
# (deep searches), empty segments, PAD holes inside groups, arity-5 chains
# that thin to nothing, depths too shallow to resolve a segment (the
# reference's misses kept), and queries too far apart for a block's count
# table (added per warp).
FOLD_CASES = {
    "edges": dict(seed=1, group_sizes=[31, 33, 1, 1, 64, 257, 3, 300, 5, 255, 2],
                  seg_lens=[50, 700, 1, 9, 0, 779, 33, 400, 1024, 64, 3],
                  arities=[2, 3, 2, 2, 2, 3, 4, 2, 2, 3, 5]),
    "singletons": dict(seed=2, group_sizes=[1] * 300, seg_lens=[7, 40, 1, 300] * 75,
                       arities=[2, 3] * 150),
    "long_segments": dict(seed=3, group_sizes=[40, 200, 64, 5], seg_lens=[3000, 1025, 1024, 5000],
                         arities=[3, 2, 2, 3], dense_from=1024),
    "empty_segments": dict(seed=4, group_sizes=[20, 50, 33, 70], seg_lens=[0, 100, 0, 5],
                           arities=[3, 2, 2, 4]),
    "pad_holes": dict(seed=5, group_sizes=[100, 64, 300, 7], seg_lens=[200, 64, 500, 7],
                      arities=[2, 3, 2, 2], pad_cells=0.3),
    "arity5_thins_out": dict(seed=6, group_sizes=[400, 90, 33], seg_lens=[300, 100, 40],
                             arities=[5, 5, 5], hit_rate=0.15),
    "shallow_depth": dict(seed=7, group_sizes=[100, 64, 300], seg_lens=[700, 100, 40],
                          arities=[3, 2, 2], iters_shift=4),
    "far_queries": dict(seed=8, group_sizes=[40] * 12, seg_lens=[60] * 12, arities=[2] * 12,
                        query_of=[600 * g for g in range(12)]),
}
