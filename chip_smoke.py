"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # one GPU, no arguments

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of ``src/repro_torch/csrc`` for ``sm_90a``
   (one ``nvcc`` per source, all started together) and prints ptxas's
   registers and spills of each kernel;
3. holds each kernel against its plain PyTorch version on the card, on
   random and edge-case inputs: the search kernels exactly (their outputs
   are integers; the fold also on the hand-built layouts of
   ``tests/_torch_parity.FOLD_CASES`` and against the CPU emulation of its
   algorithm, twice), ``cluster_scores`` within ``rtol=2e-5, atol=1e-5``
   through the variant ``kernel.score_route`` picks (read from the
   counters), twice with the same bits, the staged variant bit-equal to
   the emulation of its summation order;
4. drives the search path through the launcher's own functions
   (``repro_torch.launch.search``): a host fit of the ``wiki`` corpus at
   ``N_DOCS`` documents and two logs of ``N_QUERIES`` queries, the
   index uploaded to the card, both query logs served through the fold
   kernel and the block path, every batch checked against the host
   engine bit for bit, one fold launch a batch — with every launch
   counter set to 0 just before and the search kernels' counters read
   just after (the fold's arguments of each batch are recorded, for its
   timing in step 9);
5. drives the clustering path: TopDown over the same frequent-term view
   with the device K-means (``distributed_kmeans_fn([cuda:0])``) as its
   ``kmeans_fn``, counters set to 0 just before and the
   ``cluster_scores`` counters read just after (every launch on the
   staged variant; each launch's shape recorded); checks the labels and
   that ψ beats a random assignment, and compares ψ and wall time with
   the host fit's;
6. runs one K-means round at full size through the kernel and through
   the plain version on the card (equal counts, bit-equal tables, scores
   within the tolerance, assignments equal but for near-ties);
7. holds the attention (``flash_attention_kernel``, the launcher's call)
   against its plain version computed in float32 from the same inputs, on
   random and edge-case inputs and at the LM path's shapes
   (``FLASH_CASES``, ``FLASH_TOL`` and ``p_rounding_term`` of
   ``tests/_torch_parity.py``, which the kernel tests share: float32
   within ``rtol=atol=2e-4``, bfloat16 within half a bf16 step, plus
   2**-8 times the plain attention of |v| on the sm90 variant, which
   rounds P to bf16), each case through the variant the launcher picks
   (``kernel.flash_route``: the bf16 tensor-core prefill ``sm90``, the
   split-K ``decode`` with its combine, or the ``general`` kernel) and
   read from the counters;
8. drives the LM serving path through the launcher's own functions
   (``repro_torch.launch.serve``): gemma3-4b at its full width with
   seeded random weights, ``LM_REQUESTS`` prompts of ``LM_PROMPT_LEN``
   tokens, ``LM_DECODE_STEPS`` greedy steps — counters set to 0 just
   before and the attention counters read just after (one call per layer
   per model call: the prefill's 34 on the sm90 variant, the 544 of the
   decode steps on the split-K variant and its combine) — then replays the
   same run with attention through the plain version, fed the kernel
   route's tokens, and compares every step's logits (within
   ``LOGIT_RTOL``) and tokens (equal but at near-ties), and at each
   attention call of that replay holds the kernel on the same inputs to
   its limit; two controls, plain attention with a fault (the window
   ignored on local layers; the ragged tail of keys dropped), must land
   beyond ``LOGIT_RTOL`` in the logit comparison, and the second beyond
   ``FLASH_TOL`` at the first decode step; then traces four decode steps
   with ``torch.profiler`` (device kernel time per step, the attention's
   part of it, the device's idle share);
9. times each kernel against its plain version at the main path's
   shapes (the attention call at four shapes, beside
   ``scaled_dot_product_attention`` with a boolean mask and as the fastest
   single call; the decode variant's split kernel and combine one by
   one; the fold, ``cluster_scores`` and attention also as device time
   from a CUDA-graph replay, without the host's launch cost;
   ``cluster_scores`` beside its first design, the ``general`` variant,
   re-timed on the same inputs), sums launches x (time - bound) over the
   search run's fold batches and over the TopDown's scoring calls (timed
   once per shape bucket), and prints one JSON line listing every kernel
   with its variant;
10. prints ``{"ok": true, "device": {...}}`` as its last line.

Any mismatch or error raises and the script exits non-zero.  Without a
GPU, or without the rest of the repository beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM fp32 rate outside the tensor cores, dense (NVIDIA data sheet):
# the peak for the scores' multiply-adds.
FP32_OPS_PER_S = 67e12
SECTOR_BYTES = 32  # the card's smallest device-memory transaction
# The main path's size: the `wiki` preset at 200,000 documents, the scale
# the host fit affords.  A cut changes these and is recorded in PERF.md.
N_DOCS = 200_000
N_QUERIES = 2000
# The host fit's clustering settings (``launch/search.py`` with the
# pipeline's defaults), which the device TopDown repeats.
K_CLUSTERS = 256
DOC_GRAINED_BELOW = 512
# fp32 sums over at most L terms, taken in another order than the plain
# version's: the tolerance of tests/test_kernels_cluster_score.py:40-41.
SCORE_RTOL, SCORE_ATOL = 2e-5, 1e-5
PAD_MAX = 2**31 - 1
# H100 SXM bf16 tensor-core rate, dense (NVIDIA data sheet): the peak for
# attention's products on bf16 inputs.
BF16_OPS_PER_S = 989e12
# scaled_dot_product_attention, a yardstick with bf16 products of its own,
# against the plain version: the reference's bf16 tolerance
# (tests/test_kernels_flash_attention.py:88).
LIBRARY_TOL = 3e-2
# The decode variant's step of keys (kernel.DECODE_CHUNK_STEP: its splits
# are whole multiples of it, and the general kernel's tile is as long): a
# fault control drops the ragged last one.
KEY_TILE = 32
# The LM path: gemma3-4b at its published widths, 8 requests of 2048
# tokens (past the 1024 window, so the local layers skip key tiles) and
# 16 greedy steps, a cache of 2064 positions.
LM_ARCH = "gemma3-4b"
LM_REQUESTS = 8
LM_PROMPT_LEN = 2048
LM_DECODE_STEPS = 16
# Logits of the kernel route against the plain route, per step:
# max |a - b| <= LOGIT_RTOL * max |b|.  Both routes round every attention
# output and every activation to bf16 (a step is 2**-7 to 2**-8 of the
# value); the fp32 differences inside attention (sum order, exp) flip a few
# of those roundings by one step, and 34 layers carry the flips on.  Sound
# runs read 0.0085-0.0108 on the card (PERF.md); every run also reads two
# faulty attentions through the same comparison and fails unless both land
# beyond the limit.  Greedy tokens must be equal except where the plain
# route's two logits lie within the same bound.
LOGIT_RTOL = 2e-2
SOURCES = {
    "segment_fold": ("src/repro_torch/csrc/fold.cu", "src/repro/core/device_engine.py:396"),
    "intersect_members_kernel": (
        "src/repro_torch/csrc/intersect.cu", "src/repro/kernels/intersect/kernel.py:182"),
    "intersect_members_count_kernel": (
        "src/repro_torch/csrc/intersect.cu", "src/repro/kernels/intersect/kernel.py:203"),
    "intersect_count_kernel": (
        "src/repro_torch/csrc/intersect.cu", "src/repro/kernels/intersect/kernel.py:223"),
    "cluster_scores_kernel": (
        "src/repro_torch/csrc/cluster_score.cu", "src/repro/kernels/cluster_score/kernel.py:67"),
    "cluster_scores_staged": (
        "src/repro_torch/csrc/cluster_score.cu", "src/repro/kernels/cluster_score/kernel.py:67"),
    "flash_attention_kernel": (
        "src/repro_torch/csrc/flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:95"),
    "flash_attention_sm90": (
        "src/repro_torch/csrc/flash_attention_sm90.cu",
        "src/repro/kernels/flash_attention/kernel.py:95"),
    "flash_attention_decode": (
        "src/repro_torch/csrc/flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:95"),
    "flash_attention_combine": (
        "src/repro_torch/csrc/flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:95"),
}
SEARCH_KERNELS = ("segment_fold", "intersect_members_kernel", "intersect_members_count_kernel",
                  "intersect_count_kernel")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Mean ms per call on the card (CUDA events, after a warm-up)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms per call without the host's launch cost: ``reps`` calls
    captured in one CUDA graph (after a warm-up on a side stream), replayed
    once between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def max_abs_err(a, b) -> int:
    """Largest integer difference of two int tensors (0 when equal); raises
    when shapes differ."""
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max().item())


def assert_equal(name: str, got, want) -> int:
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max |err| {err})")
    return err


def assert_close(name: str, got, want) -> float:
    """Largest |got - want| of two float tensors; raises when shapes
    differ, when ``got`` is not finite, or when an element lies outside
    ``SCORE_ATOL + SCORE_RTOL·|want|``."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs()
    if bool((err > SCORE_ATOL + SCORE_RTOL * want.abs()).any()):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version beyond rtol={SCORE_RTOL}, "
            f"atol={SCORE_ATOL} (max |err| {float(err.max())})")
    return float(err.max())


# ----------------------------------------------------------------------
# Kernels against their plain versions on random and edge-case inputs
# ----------------------------------------------------------------------


def _rows(rng, b, ls, ll, universe, holes=False):
    from repro_torch.kernels.intersect.ref import PAD

    short = np.full((b, ls), PAD, np.int32)
    long = np.full((b, ll), PAD, np.int32)
    for r in range(b):
        ns, nl = int(rng.integers(0, ls + 1)), int(rng.integers(0, ll + 1))
        s = np.sort(rng.choice(universe, size=min(ns, universe), replace=False))
        l = np.sort(rng.choice(universe, size=min(nl, universe), replace=False))
        short[r, : len(s)] = s
        long[r, : len(l)] = l
    if holes:
        short[rng.random(short.shape) < 0.3] = PAD
    return short, long


def check_intersect_cases(torch, dev) -> None:
    from repro_torch.kernels.intersect import kernel as K
    from repro_torch.kernels.intersect import ref as R
    from repro_torch.kernels.intersect.ref import PAD

    rng = np.random.default_rng(0)
    shapes = [(1, 16, 64), (8, 128, 128), (5, 100, 300), (16, 128, 512),
              (3, 257, 1000), (7, 1, 1), (4, 33, 0), (0, 8, 8), (6, 0, 5)]
    cases = []
    for b, ls, ll in shapes:
        cases.append(_rows(rng, b, ls, ll, universe=max(4 * ll, 8)))
        cases.append(_rows(rng, b, ls, ll, universe=max(4 * ll, 8), holes=True))
    all_pad = np.full((8, 128), PAD, np.int32)
    cases.append((all_pad, all_pad.copy()))
    ident = np.sort(rng.choice(1 << 20, size=(3, 200), replace=False).reshape(3, 200), axis=1).astype(np.int32)
    cases.append((ident, ident.copy()))
    for short_np, long_np in cases:
        s = torch.from_numpy(short_np).to(dev)
        l = torch.from_numpy(np.ascontiguousarray(long_np)).to(dev)
        hit = R.intersect_members_ref(s, l)
        assert_equal("intersect_members_kernel", K.intersect_members_cuda(s, l),
                     torch.where(hit, s, int(PAD)))
        assert_equal("intersect_members_count_kernel", K.intersect_members_count_cuda(s, l),
                     hit.sum(dim=1).to(torch.int32))
        # the count kernel's contract: short rows sorted, PAD last
        s_sorted = torch.sort(s, dim=1).values
        assert_equal("intersect_count_kernel", K.intersect_count_cuda(s_sorted, l),
                     R.intersect_count_ref(s_sorted, l))
    torch.cuda.synchronize()
    print(f"intersect trio: {len(cases)} random/edge cases equal to the plain versions")


def check_fold_cases(torch, dev) -> None:
    """A fold plan over an L = 3 hierarchy with arities 1-5 (duplicate and
    absent terms included), with and without members."""
    from repro_torch.core.batched_query import plan_segment_pairs
    from repro_torch.core.device_engine import device_index, lower_plan
    from repro_torch.core.queries import ConjunctiveQueries
    from repro_torch.core.seclud import SecludPipeline
    from repro_torch.data.corpus import CorpusSpec, synth_corpus
    from repro_torch.data.query_log import synth_query_log
    from repro_torch.kernels.intersect import kernel as K
    from repro_torch.kernels.intersect.ref import segment_fold_ref

    corpus = synth_corpus(CorpusSpec(n_docs=3000, n_terms=4000, mean_doc_len=40,
                                     n_topics=8, topicality=0.6, seed=7))
    log = synth_query_log(corpus, n_queries=200, seed=3, arity=[1, 2, 3, 4, 5])
    res = SecludPipeline(tc=800, doc_grained_below=256, seed=0).fit(
        corpus, k=12, log=log, levels=3, device=dev)
    di = device_index(res.hier_index, dev)
    rng = np.random.default_rng(5)
    lists = [list(map(int, t)) for t in log.as_conjunctive()]
    for _ in range(40):
        a = int(rng.integers(1, 6))
        t = rng.integers(0, corpus.n_terms, a).tolist()
        if a >= 2:
            t[1] = t[0]
        lists.append(t)
    batches = [ConjunctiveQueries.from_lists(lists),
               ConjunctiveQueries.from_lists([x[:1] for x in lists])]
    n_checked = 0
    for cq in batches:
        plan = plan_segment_pairs(di.host, cq, track_work=False)
        low = lower_plan(plan)
        cells = torch.from_numpy(low.cells).to(dev)
        seg = torch.from_numpy(low.stage_seg).to(dev)
        for members in (False, True):
            args = (di.post_docs, cells, seg, low.group_width, low.stage_iters,
                    low.n_queries_pad, members)
            got, want = K.segment_fold_cuda(*args), segment_fold_ref(*args)
            for g, w in zip(got, want, strict=True):
                if w is not None:
                    assert_equal("segment_fold", g, w)
            n_checked += 1
    # Hand-built layouts (tests/_torch_parity.FOLD_CASES): groups across
    # warp and block edges, long segments, empty segments, PAD holes, chains
    # that thin out, shallow depths, queries beyond a block's count table;
    # the kernel equal to the plain version and to the CPU emulation of its
    # algorithm, twice.
    from _torch_parity import FOLD_CASES, fold_emulation, synthetic_fold_case

    atomics = {}
    for name, spec in FOLD_CASES.items():
        case = synthetic_fold_case(**spec)
        host = [torch.from_numpy(case[key]) for key in ("post_docs", "cells", "stage_seg")]
        rest = (case["group_width"], case["stage_iters"], case["n_queries_pad"], True)
        args = tuple(t.to(dev) for t in host) + rest
        got, again, want = K.segment_fold_cuda(*args), K.segment_fold_cuda(*args), segment_fold_ref(*args)
        *emulated, stats = fold_emulation(*host, *rest)
        for g, a, w, e in zip(got, again, want, emulated, strict=True):
            assert_equal("segment_fold", g, w)
            assert_equal("segment_fold (second launch)", a, g)
            assert_equal("segment_fold (emulation)", g.cpu(), e)
        atomics[name] = stats["count_atomics"]
        n_checked += 1
    torch.cuda.synchronize()
    print(f"segment_fold: {n_checked} plans (fitted L=3 index, arities 1-5; hand-built layouts) "
          f"equal to the plain version, twice; global count atomics (emulated) {atomics}")


def score_inputs(rng, n, l, tc, k):
    """(N, L) ranks with pads (TC and 2**31 - 1) anywhere, an all-pad
    first row and duplicate ranks in the last; p (TC,), tables (TC, K).

    Up to the reference test's L = 128 the tables are standard normal, as
    there.  Above it they are non-negative, as δ⁺ tables are: mixed-sign
    sums over hundreds of slots cancel, and then the fixed tolerance no
    longer bounds the error of an fp32 sum taken in another order."""
    ell = rng.integers(0, tc, size=(n, l)).astype(np.int32)
    holes = rng.random((n, l))
    ell[holes < 0.2] = tc
    ell[(holes >= 0.2) & (holes < 0.3)] = PAD_MAX
    if n and l >= 3:
        ell[0, :] = PAD_MAX
        ell[n - 1, 1:3] = ell[n - 1, 0]
    p = rng.random(tc).astype(np.float32)
    if l <= 128:
        tables = rng.standard_normal((tc, k)).astype(np.float32)
    else:
        tables = rng.random((tc, k)).astype(np.float32)
    return ell, p, tables


def check_cluster_score_cases(torch, dev) -> float:
    """The reference test's shapes, N = 0, L = 0, K = 1, K above 256,
    all-pad rows, pads at 2**31 - 1 and negative, duplicate ranks, TC =
    3000 at K = 8 and K = 256, and the staged variant's edges (K padded to
    a power of two, L in {1, 3, 742}, N = 1, a table just within and just
    beyond its shared-memory budget), each also from an ELL whose base
    sits inside a 16-byte block.  Each case goes through the variant
    ``kernel.score_route`` picks, read from the counters; a second launch
    gives the same bits; the staged variant equals the emulation of its
    summation order (``_torch_parity.staged_scores_emulation``) bit for
    bit."""
    from _torch_parity import staged_scores_emulation
    from repro_torch.kernels import build as B
    from repro_torch.kernels.cluster_score.kernel import cluster_scores_cuda, score_route
    from repro_torch.kernels.cluster_score.ref import cluster_scores_ref

    rng = np.random.default_rng(0)
    shapes = [(4, 8, 32, 4), (16, 128, 128, 8), (10, 50, 300, 33), (32, 64, 1024, 128),
              (0, 8, 32, 4), (6, 0, 32, 4), (9, 40, 64, 1), (20, 100, 500, 300),
              (1000, 742, 3000, 8), (2000, 742, 3000, 256), (3000, 1, 3000, 1),
              (3000, 3, 3000, 2), (500, 742, 3000, 7), (500, 742, 3000, 9), (1, 742, 3000, 8),
              (200, 742, 6144, 8), (200, 742, 6145, 8), (200, 50, 3072, 16), (200, 50, 3073, 16)]
    err, routes = 0.0, {"staged": 0, "general": 0}
    for n, l, tc, k in shapes:
        for offset in (0, 1):
            ell, p, tables = score_inputs(rng, n + offset, l, tc, k)
            if n and l:
                ell[-1, -1] = -3
            ell, p, tables = torch.from_numpy(ell).to(dev)[offset:], *(
                torch.from_numpy(a).to(dev) for a in (p, tables))
            route = score_route(tc, k)
            before = dict(B.LAUNCHES)
            got = cluster_scores_cuda(ell, p, tables)
            launched = {v: B.LAUNCHES[f"cluster_scores_{v}"] - before[f"cluster_scores_{v}"]
                        for v in routes}
            if launched != {v: int(bool(n) and v == route) for v in routes}:
                raise AssertionError(f"cluster_scores {n, l, tc, k}: launched {launched}, "
                                     f"route {route}")
            routes[route] += int(bool(n))
            err = max(err, assert_close("cluster_scores_kernel", got,
                                        cluster_scores_ref(ell, p, tables)))
            assert_equal_float("cluster_scores_kernel (second launch)",
                               cluster_scores_cuda(ell, p, tables), got)
            if route == "staged":
                assert_equal_float("cluster_scores_staged (emulated order)", got.cpu(),
                                   staged_scores_emulation(ell.cpu(), p.cpu(), tables.cpu(),
                                                           (ell.data_ptr() // 4) % 4))
            if n and l >= 3 and offset == 0 and bool(got[0].any()):
                raise AssertionError("cluster_scores_kernel: an all-pad row is not zero")
    tc, k = 16, 4
    ell = torch.tensor([[3, 3, 3, tc, PAD_MAX]], dtype=torch.int32, device=dev)
    p = torch.arange(1, tc + 1, dtype=torch.float32, device=dev)
    tables = torch.eye(tc, k, dtype=torch.float32, device=dev)
    want = torch.zeros((1, k), dtype=torch.float32, device=dev)
    want[0, 3] = 3 * p[3]
    for variant in routes:
        err = max(err, assert_close("cluster_scores_kernel",
                                    cluster_scores_cuda(ell, p, tables, variant=variant), want))
    torch.cuda.synchronize()
    print(f"cluster_scores_kernel: {2 * len(shapes) + 2} random/edge cases within "
          f"rtol={SCORE_RTOL}, atol={SCORE_ATOL} of the plain version (max |err| {err:.3g}), "
          f"launches by variant {routes}, each twice with the same bits, the staged ones "
          "equal to their emulated order", flush=True)
    return err


def assert_equal_float(name: str, got, want) -> None:
    import torch

    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: not bit-equal")


# ----------------------------------------------------------------------
# The clustering path: TopDown with the device K-means
# ----------------------------------------------------------------------


class Spans:
    """Host-clock seconds spent in named functions of the clustering path
    during one run, taken by wrapping them and undone by ``restore``."""

    def __init__(self, torch):
        self.torch = torch
        self.seconds = {}
        self._undo = []

    def _add(self, label, t0):
        self.seconds[label] = self.seconds.get(label, 0.0) + time.perf_counter() - t0

    def wrap(self, owner, attr, label):
        fn = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self._add(label, t0)

        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, fn))

    def wrap_rounds(self, module, label):
        """Time each round that ``module.make_round_fn`` makes, to the end
        of its device work."""
        make = module.make_round_fn

        def timed_make(*args, **kwargs):
            fn = make(*args, **kwargs)

            def timed_round(*rargs):
                t0 = time.perf_counter()
                out = fn(*rargs)
                self.torch.cuda.synchronize()
                self._add(label, t0)
                return out

            return timed_round

        module.make_round_fn = timed_make
        self._undo.append((module, "make_round_fn", make))

    def record_calls(self, owner, attr, describe) -> list:
        """Wrap ``owner.attr`` so each call appends ``describe(*args,
        **kwargs)`` to the returned list (undone by ``restore``)."""
        fn, calls = getattr(owner, attr), []

        def recorded(*args, **kwargs):
            calls.append(describe(*args, **kwargs))
            return fn(*args, **kwargs)

        setattr(owner, attr, recorded)
        self._undo.append((owner, attr, fn))
        return calls

    def restore(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


def device_kmeans(torch, dev, res):
    """TopDown over the host fit's frequent-term view with the device
    K-means as ``kmeans_fn``; returns its report and its launch counts."""
    from repro_torch.core import multilevel
    from repro_torch.core.objective import FrequentTermView, cluster_counts, psi_from_counts
    from repro_torch.core.topdown import topdown_cluster
    from repro_torch.dist import cluster_dist
    from repro_torch.kernels import build as B
    from repro_torch.kernels.cluster_score import ops as score_ops

    view = res.view
    fn = cluster_dist.distributed_kmeans_fn([dev], doc_grained_below=DOC_GRAINED_BELOW)
    calls = {"device_calls": 0, "accepted_rounds": 0, "host_calls": 0}

    def counted(v, k, **kwargs):
        out = fn(v, k, **kwargs)
        if v.n_docs >= kwargs.get("doc_grained_below", DOC_GRAINED_BELOW):
            calls["device_calls"] += 1
            calls["accepted_rounds"] += out.n_iters
        else:
            calls["host_calls"] += 1
        return out

    spans = Spans(torch)
    spans.wrap(cluster_dist, "ell_pack", "ell_pack")
    spans.wrap(cluster_dist, "cluster_counts", "host_psi_check")
    spans.wrap(cluster_dist, "psi_from_counts", "host_psi_check")
    spans.wrap(cluster_dist, "kmeans", "host_kmeans_small_levels")
    spans.wrap(FrequentTermView, "subset", "view_subset")
    for name in ("cluster_counts", "delta_add_tables", "assignment_scores"):
        spans.wrap(multilevel, name, "multilevel_projection")
    spans.wrap_rounds(cluster_dist, "device_rounds")
    score_shapes = spans.record_calls(score_ops, "cluster_scores_cuda", lambda ell, p, tables, **_: (
        int(ell.shape[0]), int(ell.shape[1]), int(tables.shape[0]), int(tables.shape[1]),
        ((ell >= 0) & (ell < tables.shape[0])).sum()))
    B.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        td = topdown_cluster(view, K_CLUSTERS, chi=8, eps=0.1,
                             doc_grained_below=DOC_GRAINED_BELOW, seed=0, kmeans_fn=counted)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        spans.restore()
    launches = dict(B.LAUNCHES)
    if launches["cluster_scores_kernel"] <= 0:
        raise AssertionError("the device TopDown never launched cluster_scores_kernel")
    # every round scores K <= chi = 8 clusters over TC = 3000: the staged variant
    if not (launches["cluster_scores_staged"] == launches["cluster_scores_kernel"]
            == len(score_shapes)) or launches["cluster_scores_general"]:
        raise AssertionError(f"device TopDown: {len(score_shapes)} scoring calls, launches "
                             f"{ {k: v for k, v in launches.items() if 'scores' in k} }")
    labels = td.assign
    if labels.shape != (view.n_docs,) or labels.min() < 0 or labels.max() >= td.k_actual:
        raise AssertionError(f"device TopDown labels outside [0, {td.k_actual})")
    psi = psi_from_counts(cluster_counts(view, labels, td.k_actual), view.p_freq)
    rand = np.random.default_rng(0).integers(0, td.k_actual, view.n_docs)
    psi_random = psi_from_counts(cluster_counts(view, rand, td.k_actual), view.p_freq)
    if not psi < psi_random:
        raise AssertionError(f"device TopDown ψ {psi} does not beat random {psi_random}")
    report = {
        "n_docs": int(view.n_docs), "tc": int(view.tc), "k": K_CLUSTERS,
        "k_actual": int(td.k_actual), "n_splits": int(td.n_splits),
        "psi": float(psi), "psi_host_fit": float(res.psi), "psi_random": float(psi_random),
        "psi_ratio_to_host": float(psi / res.psi), "wall_s": wall_s,
        "host_fit_cluster_time_s": float(res.cluster_time_s),
        "wall_ratio_to_host": wall_s / float(res.cluster_time_s),
        "device_rounds": int(launches["cluster_scores_kernel"]),
        "cluster_scores_launches": int(launches["cluster_scores_kernel"]), **calls,
        "spans_s": spans.seconds,
        "score_shapes": [(n, l, tc, k, int(valid)) for n, l, tc, k, valid in score_shapes],
    }
    return report, launches


def round_check(torch, dev, view):
    """One K-means round over the full ELL at k = 8 from a seeded random
    assignment, through the kernel and through the plain version on the
    card.  Returns the ELL, P and (k, tc) tables on the card and the
    largest score error."""
    from repro_torch.core import torch_ops as T
    from repro_torch.core.objective import cluster_counts
    from repro_torch.kernels.cluster_score.ref import cluster_scores_ref

    k, tc = 8, view.tc
    ell_np, l_pad = T.ell_pack(view)
    ell = torch.from_numpy(ell_np).to(dev)
    p = torch.from_numpy(np.asarray(view.p_freq, np.float32)).to(dev)
    assign_np = np.random.default_rng(0).integers(0, k, view.n_docs).astype(np.int32)
    assign = torch.from_numpy(assign_np).to(dev)
    counts = [T.counts_from_ell(ell, assign, k, tc) for _ in range(2)]
    if not torch.equal(counts[0], counts[1]):
        raise AssertionError("counts_from_ell: two runs on the card differ")
    host_counts = cluster_counts(view, assign_np.astype(np.int64), k)
    if not np.array_equal(counts[0].cpu().numpy(), host_counts):
        raise AssertionError("counts_from_ell: the card's counts differ from the host's")
    tables = [T.delta_add_tables_torch(c, p) for c in counts]
    if not torch.equal(tables[0], tables[1]):
        raise AssertionError("delta_add_tables_torch: the two paths' tables are not bit-equal")
    got = T.scores_from_ell(ell, tables[0], p)  # the kernel
    want = cluster_scores_ref(ell, p, tables[1].T.contiguous())  # the plain version
    err = assert_close("cluster_scores_kernel (round)", got, want)
    a_kernel, a_plain = torch.argmin(got, dim=1), torch.argmin(want, dim=1)
    diff = (a_kernel != a_plain).nonzero().squeeze(1)
    s_plain = want[diff, a_plain[diff]]
    s_kernel = want[diff, a_kernel[diff]]
    far = (s_plain - s_kernel).abs() > SCORE_ATOL + SCORE_RTOL * s_plain.abs()
    if bool(far.any()):
        raise AssertionError("K-means round: assignments differ beyond a near-tie")
    torch.cuda.synchronize()
    n_ties = int(diff.numel())
    print(f"one round at full size ({view.n_docs} x {l_pad}, k={k}): counts equal to the host, "
          f"tables bit-equal, scores within tolerance (max |err| {err:.3g}), "
          f"{n_ties} near-tie documents assigned apart", flush=True)
    return ell, p, tables[0], {"l_pad": int(l_pad), "max_abs_err": err, "near_ties": n_ties}


# ----------------------------------------------------------------------
# Kernel timings at the main path's shapes
# ----------------------------------------------------------------------


def fold_sectors_read(torch, post_docs, cells, seg, group_width, stage_iters) -> int:
    """Distinct sectors of ``post_docs`` that this plan's data needs: each
    real cell's first posting, and every binary-search probe of every live
    cell at every stage inside a non-empty window, replayed with the plain
    version's integer steps.  Probes that several cells share count once."""
    from repro_torch.kernels.intersect.ref import PAD

    n, pad = post_docs.shape[0], int(PAD)
    if n == 0:
        return 0
    per_sector = SECTOR_BYTES // post_docs.element_size()
    post, group, arity = cells[0].long(), cells[1].long(), cells[3]
    real = post != pad
    touched = [post[real].clamp(0, n - 1) // per_sector]
    cur = torch.where(real, post_docs[post.clamp(0, n - 1)], pad)
    group = group.clamp(max=max(group_width - 1, 0))
    for s, iters in enumerate(stage_iters, start=1):
        idx = ((arity > s) & (cur != pad)).nonzero().squeeze(1)
        c = cur[idx]
        cols = seg[:, (s - 1) * group_width : s * group_width].long()
        lo = cols[0][group[idx]]
        hi = lo + cols[1][group[idx]]
        end = hi
        for _ in range(int(iters)):
            mid = (lo + hi) >> 1
            v = post_docs[mid.clamp(max=n - 1)]
            touched.append(mid[lo < hi].clamp(max=n - 1) // per_sector)
            below = v < c
            lo = torch.where(below, mid + 1, lo)
            hi = torch.where(below, hi, mid)
        inside = lo < end
        touched.append(lo[inside].clamp(max=n - 1) // per_sector)
        found = inside & (post_docs[lo.clamp(max=n - 1)] == c)
        cur[idx[~found]] = pad
    return int(torch.unique(torch.cat(touched)).numel())


def fold_rows(torch, svc, logs, launches, batches):
    """The fold at each log's first batch (eager, and as device time from a
    CUDA-graph replay, which the launcher allows since it copies nothing
    from the host), and the excess over the bound summed over every batch
    the search path folded (``batches``: the launcher's arguments, recorded
    while the path ran)."""
    from repro_torch.core.batched_query import plan_segment_pairs
    from repro_torch.core.device_engine import lower_plan
    from repro_torch.core.queries import as_queries
    from repro_torch.kernels.intersect import kernel as K
    from repro_torch.kernels.intersect.ref import segment_fold_ref
    from repro_torch.launch import search

    di = svc.device_index
    dev = di.device
    rows = []
    for name, lg in logs.items():
        cq = as_queries(lg.queries)[:search.SERVE_BATCH]
        low = lower_plan(plan_segment_pairs(di.host, cq, track_work=False))
        cells = torch.from_numpy(low.cells).to(dev)
        seg = torch.from_numpy(low.stage_seg).to(dev)
        args = (di.post_docs, cells, seg, low.group_width, low.stage_iters,
                low.n_queries_pad, True)
        got, want = K.segment_fold_cuda(*args), segment_fold_ref(*args)
        err = max(assert_equal("segment_fold", g, w) for g, w in zip(got, want, strict=True))
        ms = time_ms(lambda: K.segment_fold_cuda(*args))
        device_ms = graph_ms(lambda: K.segment_fold_cuda(*args))
        plain_ms = time_ms(lambda: segment_fold_ref(*args), reps=5)
        # The rest of device_counts' t_fold_s: the plan's upload and the
        # copy of the results back, timed apart from the kernel.
        upload_ms = time_ms(lambda: (torch.from_numpy(low.cells).to(dev),
                                     torch.from_numpy(low.stage_seg).to(dev)), reps=5)
        copyback_ms = time_ms(lambda: [t.cpu() for t in got], reps=5)
        nbytes = fold_bytes(torch, args)
        rows.append({
            "shape": name, "cells": int(low.n_cells), "stages": len(low.stage_iters),
            "stage_iters": list(low.stage_iters), "entering": want[1].cpu().tolist(),
            "bytes": nbytes, "max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": nbytes / MEM_BYTES_PER_S * 1e3,
            "upload_ms": upload_ms, "copyback_ms": copyback_ms,
        })
    # Every batch of the search run: device time against its own bound.
    per_batch = []
    for args in batches:
        bound_ms = fold_bytes(torch, args) / MEM_BYTES_PER_S * 1e3
        per_batch.append({"cells": int(args[1].shape[1]), "stages": len(args[4]),
                          "device_ms": graph_ms(lambda args=args: K.segment_fold_cuda(*args), reps=10),
                          "bound_ms": bound_ms})
    entry = kernel_entry("segment_fold", launches, rows, variant="block-merged counts")
    entry["device_ms"] = rows[0]["device_ms"]
    entry["batches"] = per_batch
    entry["excess_ms"] = sum(b["device_ms"] - b["bound_ms"] for b in per_batch)
    return entry


def fold_bytes(torch, args) -> int:
    """Bytes the fold must move for a plan's data: the cell, segment and
    depth arrays read once, the distinct sectors of post_docs the data
    needs, the counts, stage totals and members written once."""
    _, cells, seg, _, stage_iters, n_queries_pad, _ = args
    sectors = fold_sectors_read(torch, *args[:5])
    return (4 * (cells.numel() + seg.numel()) + 8 * len(stage_iters) + SECTOR_BYTES * sectors
            + 4 * n_queries_pad + 4 * cells.shape[1])


def intersect_rows(torch, svc, logs, launches):
    from repro_torch.kernels.intersect import kernel as K
    from repro_torch.kernels.intersect import ref as R
    from repro_torch.kernels.intersect.ref import PAD
    from repro_torch.launch.search import BLOCK_QUERIES

    dev = svc.device
    packs = {name: svc.pack(lg.queries[:BLOCK_QUERIES]) for name, lg in logs.items()}

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    pairs = [put(b) for b in packs["arity2"].segments]
    mixed = [put(b) for b in packs["arity1to5"].segments]
    cases = {
        # the pairs-only block path: rank 0 against rank 1
        "intersect_count_kernel": (
            pairs[0], pairs[1], K.intersect_count_cuda, R.intersect_count_ref),
        # the mixed fold's first masked stage and its last counted stage
        "intersect_members_kernel": (
            mixed[0], mixed[1], K.intersect_members_cuda,
            lambda s, l: torch.where(R.intersect_members_ref(s, l), s, int(PAD))),
        "intersect_members_count_kernel": (
            mixed[0], mixed[-1], K.intersect_members_count_cuda,
            lambda s, l: R.intersect_members_ref(s, l).sum(dim=1).to(torch.int32)),
    }
    entries = []
    for name, (s, l, kern, plain) in cases.items():
        got, want = kern(s, l), plain(s, l)
        err = assert_equal(name, got, want)
        ms = time_ms(lambda kern=kern, s=s, l=l: kern(s, l))
        plain_ms = time_ms(lambda plain=plain, s=s, l=l: plain(s, l))
        nbytes = (s.numel() + l.numel() + want.numel()) * 4
        entries.append(kernel_entry(name, launches, variant="binary probe", rows=[{
            "shape": f"{tuple(s.shape)} x {tuple(l.shape)}", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": nbytes / MEM_BYTES_PER_S * 1e3,
        }]))
    return entries


def score_bound(ell_numel, tc, k, n, n_valid):
    """Each input read once, the output written once; one multiply-add per
    valid slot and output column.  Returns the bound in ms, what bounds it
    and the bytes."""
    nbytes = 4 * (ell_numel + tc + tc * k + n * k)
    bytes_ms, ops_ms = nbytes / MEM_BYTES_PER_S * 1e3, 2 * n_valid * k / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", nbytes


def cluster_scores_rows(torch, view, ell, p, tables8, launches, checked_err):
    """The top TopDown split's shape (K = 8, the round's own tables) and
    the flat algorithm's (K = 256, tables of a seeded random assignment),
    over the full ELL, each through the variant its route picks (eager
    and as device time from a CUDA-graph replay), with the general
    variant, the first design, re-timed at the same inputs (``old_ms``).
    The entry's ``max_abs_err`` also covers the earlier checks
    (``checked_err``)."""
    import torch.nn.functional as F

    from repro_torch.core import torch_ops as T
    from repro_torch.kernels.cluster_score.kernel import cluster_scores_cuda, score_route
    from repro_torch.kernels.cluster_score.ref import cluster_scores_ref

    tc = view.tc
    assign = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, view.n_docs).astype(np.int32)).to(ell.device)
    tables256 = T.delta_add_tables_torch(T.counts_from_ell(ell, assign, 256, tc), p)
    valid = (ell >= 0) & (ell < tc)
    n_valid = int(valid.sum())
    # The yardstick's inputs: pads mapped to an appended zero row of the
    # table and of P, built once outside its timing.
    ids = torch.where(valid, ell, tc).long()
    weights = torch.cat([p, p.new_zeros(1)])[ids]
    rows = []
    for shape, tables in (("top TopDown split, K=8", tables8), ("flat, K=256", tables256)):
        t = tables.T.contiguous()
        k = t.shape[1]
        route = score_route(tc, k)
        got, want = cluster_scores_cuda(ell, p, t), cluster_scores_ref(ell, p, t)
        err = assert_close("cluster_scores_kernel", got, want)
        t_pad = torch.cat([t, t.new_zeros((1, k))])

        def library(t_pad=t_pad):
            return F.embedding_bag(ids, t_pad, per_sample_weights=weights, mode="sum")

        assert_close("embedding_bag yardstick", library(), want)
        ms = time_ms(lambda t=t: cluster_scores_cuda(ell, p, t))
        device_ms = graph_ms(lambda t=t: cluster_scores_cuda(ell, p, t), reps=10)
        old_ms = time_ms(lambda t=t: cluster_scores_cuda(ell, p, t, variant="general"))
        plain_ms = time_ms(lambda t=t: cluster_scores_ref(ell, p, t), reps=3)
        library_ms = time_ms(library)
        bound_ms, bound_by, nbytes = score_bound(ell.numel(), tc, k, ell.shape[0], n_valid)
        rows.append({
            "shape": f"{shape}: ({ell.shape[0]}, {ell.shape[1]}) x ({tc}, {k})",
            "variant": route, "valid_slots": n_valid, "bytes": nbytes, "ops": 2 * n_valid * k,
            "max_abs_err": err, "ms": ms, "device_ms": device_ms, "old_ms": old_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
        })
    entry = kernel_entry("cluster_scores_kernel", launches, rows, variant=rows[0]["variant"])
    entry["max_abs_err"] = max(entry["max_abs_err"], checked_err)
    entry["device_ms"], entry["old_ms"] = rows[0]["device_ms"], rows[0]["old_ms"]
    return entry


def topdown_score_buckets(torch, dev, score_shapes, launches):
    """The device TopDown's scoring calls (N, L, TC, K, valid slots, as
    recorded while it ran) grouped by N and L rounded up to powers of two
    and by K; each bucket timed once at its median-N call's shape, on ranks
    drawn at that call's share of valid slots (pads elsewhere), through the
    staged variant and the general one (the first design), eager and as
    device time from a CUDA-graph replay, against that shape's bound.
    Returns the buckets and each variant's launches x (time - bound)
    summed over the TopDown, eager and device."""
    from repro_torch.kernels.cluster_score.kernel import cluster_scores_cuda, score_route

    groups = {}
    for n, l, tc, k, n_valid in score_shapes:
        key = (1 << max(n - 1, 0).bit_length(), 1 << max(l - 1, 0).bit_length(), k, tc)
        groups.setdefault(key, []).append((n, l, tc, k, n_valid))
    rng = np.random.default_rng(7)
    buckets = []
    excess = {"staged": 0.0, "general": 0.0, "staged_device": 0.0, "general_device": 0.0}
    for key, calls in sorted(groups.items(), reverse=True):
        n, l, tc, k, n_valid = sorted(calls)[len(calls) // 2]
        share = n_valid / max(n * l, 1)
        ell_np = np.where(rng.random((n, l)) < share, rng.integers(0, tc, (n, l)), tc)
        ell = torch.from_numpy(ell_np.astype(np.int32)).to(dev)
        p = torch.from_numpy(rng.random(tc).astype(np.float32)).to(dev)
        t = torch.from_numpy(rng.random((tc, k)).astype(np.float32)).to(dev)
        bound_ms, bound_by, _nbytes = score_bound(ell.numel(), tc, k, n, int(((ell < tc)).sum()))
        row = {"bucket": list(key[:3]), "launches": len(calls), "shape": [n, l, tc, k],
               "valid_share": share, "route": score_route(tc, k), "bound_ms": bound_ms,
               "bound_by": bound_by}
        for variant in ("staged", "general"):
            def call(v=variant):
                return cluster_scores_cuda(ell, p, t, variant=v)

            row[f"{variant}_ms"] = time_ms(call)
            row[f"{variant}_device_ms"] = graph_ms(call, reps=10)
            excess[variant] += len(calls) * (row[f"{variant}_ms"] - bound_ms)
            excess[f"{variant}_device"] += len(calls) * (row[f"{variant}_device_ms"] - bound_ms)
        buckets.append(row)
    if sum(r["launches"] for r in buckets) != launches["cluster_scores_kernel"]:
        raise AssertionError("TopDown scoring buckets do not cover every launch")
    return buckets, excess


# ----------------------------------------------------------------------
# The LM serving path: flash attention
# ----------------------------------------------------------------------


def plain_attention(q, k, v, causal=True, window=None):
    """The plain version in float32 from the same inputs, cast back to q's
    dtype: what the plain route of the LM path runs."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    return attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window).to(q.dtype)


def global_attention(q, k, v, causal=True, window=None):
    """A fault control: plain attention with the window ignored, so local
    layers attend to every earlier key."""
    return plain_attention(q, k, v, causal, None)


def tail_dropped_attention(q, k, v, causal=True, window=None):
    """A fault control: plain attention without the keys past the last
    whole ``KEY_TILE``: at decode the newest 1-16 tokens, at the 2048-token
    prefill none."""
    lk = k.shape[2]
    keep = lk - lk % KEY_TILE
    if keep == lk:
        return plain_attention(q, k, v, causal, window)
    if q.shape[2] != 1:
        raise ValueError("the tail control takes one query at a ragged length")
    # The query stays at position lk - 1: its window keeps its lower edge.
    return plain_attention(q, k[:, :, :keep], v[:, :, :keep], causal,
                           None if window is None else window - (lk - keep))


def assert_close_tol(name: str, got, want, tol: float) -> float:
    """Largest |got - want| (in float32); raises when ``got`` is not finite
    or an element lies outside ``tol + tol·|want|``."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    got, want = got.float(), want.float()
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs()
    if bool((err > tol + tol * want.abs()).any()):
        raise AssertionError(f"{name}: disagrees with the plain version beyond rtol=atol={tol} "
                             f"(max |err| {float(err.max())})")
    return float(err.max())


def check_flash_cases(torch, dev) -> dict:
    """Every case of ``FLASH_CASES`` in float32 and bfloat16, half of them
    in the model's strided layout, each through the variant the launcher
    picks (read from the counters); returns the largest error and share of
    the limit per dtype, and the cases per variant."""
    from _torch_parity import (FLASH_CASES, FLASH_VARIANTS, VARIANT_LAUNCHES, flash_close,
                               flash_inputs, p_rounding_term)
    from repro_torch.kernels import build as B
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda, flash_route
    from repro_torch.kernels.flash_attention.ref import attention_ref

    errs, routes = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        err = share = 0.0
        for n, (b, h, hkv, lq, lk, d, causal, window) in enumerate(FLASH_CASES):
            q, k, v = flash_inputs(dev, dtype, b, h, hkv, lq, lk, d, seed=n,
                                   model_layout=n % 2 == 0)
            route = flash_route(dtype, h, hkv, lq, d)
            before = {name: B.LAUNCHES[name] for name in FLASH_VARIANTS}
            got = flash_attention_cuda(q, k, v, causal=causal, window=window)
            took = {name: B.LAUNCHES[name] - before[name] for name in FLASH_VARIANTS}
            if took != {name: VARIANT_LAUNCHES[route].get(name, 0) for name in FLASH_VARIANTS}:
                raise AssertionError(f"flash_attention_kernel, case {FLASH_CASES[n]} {dtype}: "
                                     f"launched {took}, the {route} variant expected")
            routes[route] = routes.get(route, 0) + 1
            if got.stride() != q.stride():
                raise AssertionError("flash_attention_kernel: the output lost q's layout")
            want = attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window)
            extra = p_rounding_term(q, k, v, causal, window) if route == "sm90" else None
            try:
                e, sh = flash_close(got, want, extra)
            except AssertionError as exc:
                raise AssertionError(f"flash_attention_kernel ({route}), case {FLASH_CASES[n]} "
                                     f"{dtype}: {exc}") from exc
            err, share = max(err, e), max(share, sh)
            del q, k, v, got, want, extra
        # a window of one key returns that key's value row
        q, k, v = flash_inputs(dev, dtype, 1, 2, 2, 20, 50, 64, seed=99, model_layout=True)
        got = flash_attention_cuda(q, k, v, causal=True, window=1)
        err = max(err, assert_close_tol("flash_attention_kernel (window 1)", got, v[:, :, 30:], 1e-6))
        errs[str(dtype).removeprefix("torch.")] = {"max_abs_err": err, "share_of_limit": share}
    torch.cuda.synchronize()
    print(f"flash_attention_kernel: {len(FLASH_CASES) + 1} random/edge cases in float32 and "
          f"bfloat16 within their limits of the plain version (variants {routes}): " + "; ".join(
              f"{t} max |err| {e['max_abs_err']:.3g} ({e['share_of_limit']:.3g} of the limit)"
              for t, e in errs.items()), flush=True)
    errs["cases_per_variant"] = routes
    return errs


class CheckedPlain:
    """Attention for the plain route: the plain version, in float32 from
    the same inputs and cast to q's dtype.  At every call it also runs the
    kernel on the same inputs and holds it to ``FLASH_TOL`` (plus the
    P-rounding term on the sm90 variant's calls), and, where the keys end
    in a ragged tile, reads the tail-dropped control's share of the same
    limit."""

    def __init__(self):
        self.calls, self.max_abs_err, self.share, self.control_shares = 0, 0.0, 0.0, []
        self.share_by_variant = {}

    def __call__(self, q, k, v, causal=True, window=None):
        from _torch_parity import flash_close, flash_error, p_rounding_term
        from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda, flash_route
        from repro_torch.kernels.flash_attention.ref import attention_ref

        want = attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window)
        sm90 = flash_route(q.dtype, q.shape[1], k.shape[1], q.shape[2], q.shape[3]) == "sm90"
        extra = p_rounding_term(q, k, v, causal, window) if sm90 else None
        try:
            err, share = flash_close(flash_attention_cuda(q, k, v, causal=causal, window=window),
                                     want, extra)
        except AssertionError as exc:
            raise AssertionError(f"serve path, attention call {self.calls} (q {tuple(q.shape)}, "
                                 f"{k.shape[2]} keys, window {window}): {exc}") from exc
        self.calls += 1
        self.max_abs_err, self.share = max(self.max_abs_err, err), max(self.share, share)
        variant = "sm90" if sm90 else "decode"
        self.share_by_variant[variant] = max(self.share_by_variant.get(variant, 0.0), share)
        if k.shape[2] % KEY_TILE:
            self.control_shares.append(
                flash_error(tail_dropped_attention(q, k, v, causal, window), want)[1])
        return want.to(q.dtype)


class LogitRecorder:
    """Keeps a float32 copy of the logits of every ``prefill`` and
    ``decode_step`` call made while it is installed."""

    def __init__(self, module):
        self.module = module
        self.logits = []
        self._fns = {name: getattr(module, name) for name in ("prefill", "decode_step")}
        for name, fn in self._fns.items():
            setattr(module, name, self._wrap(fn))

    def _wrap(self, fn):
        def wrapped(*args, **kwargs):
            logits, cache = fn(*args, **kwargs)
            self.logits.append(logits.detach().float().clone())
            return logits, cache
        return wrapped

    def record_calls(self, owner, attr, describe) -> list:
        """Wrap ``owner.attr`` so each call appends ``describe(*args,
        **kwargs)`` to the returned list (undone by ``restore``)."""
        fn, calls = getattr(owner, attr), []

        def recorded(*args, **kwargs):
            calls.append(describe(*args, **kwargs))
            return fn(*args, **kwargs)

        setattr(owner, attr, recorded)
        self._undo.append((owner, attr, fn))
        return calls

    def restore(self):
        for name, fn in self._fns.items():
            setattr(self.module, name, fn)


def replay(torch, model, prompts, fed, attention):
    """The serve run again with attention through ``attention``, fed the
    tokens ``fed`` (requests, steps) instead of its own: the logits of the
    prefill and of every step."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    dev = fed.device
    kernel_attention, L.flash_attention = L.flash_attention, attention
    try:
        cache = T.init_cache(model.cfg, fed.shape[0], prompts.shape[1] + fed.shape[1], dev)
        logits = [T.prefill(model, torch.from_numpy(prompts).to(dev), cache)[0].float()]
        for s in range(fed.shape[1]):
            logits.append(T.decode_step(model, fed[:, s:s + 1], cache)[0].float())
        torch.cuda.synchronize()
        return logits
    finally:
        L.flash_attention = kernel_attention


def logit_rel_errs(got, want) -> list:
    """max |a - b| / max |b| of each call's logits."""
    return [float((a - b).abs().max()) / float(b.abs().max())
            for a, b in zip(got, want, strict=True)]


def lm_serve(torch, dev):
    """gemma3-4b at its full width through ``launch/serve.py``'s own
    functions, then the same run with attention through the plain version
    (the kernel held to it at every call) and through two faulty versions,
    fed the kernel route's tokens.  Returns its report and the attention
    kernel's launch count."""
    from _torch_parity import FLASH_VARIANTS
    from repro_torch.kernels import build as B
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    args = serve.build_parser().parse_args([
        "--arch", LM_ARCH, "--config", "full", "--requests", str(LM_REQUESTS),
        "--prompt-len", str(LM_PROMPT_LEN), "--decode-steps", str(LM_DECODE_STEPS),
        "--device", "cuda"])
    t0 = time.perf_counter()
    model, prompts = serve.setup(args)
    init_s = time.perf_counter() - t0
    cfg = model.cfg
    torch.cuda.reset_peak_memory_stats(dev)
    rec = LogitRecorder(T)
    B.reset_launch_counts()
    try:
        report = serve.serve(model, prompts, args.decode_steps)
    finally:
        rec.restore()
    torch.cuda.synchronize()
    launches = {name: B.LAUNCHES[name] for name in ("flash_attention_kernel", *FLASH_VARIANTS)}
    peak_bytes = torch.cuda.max_memory_allocated(dev)
    expected = cfg.n_layers * (1 + args.decode_steps)
    # One call a layer a model call: the prefill's on the sm90 variant, each
    # decode step's on the split-K variant and its combine.
    design = {"flash_attention_kernel": expected, "flash_attention_sm90": cfg.n_layers,
              "flash_attention_decode": cfg.n_layers * args.decode_steps,
              "flash_attention_combine": cfg.n_layers * args.decode_steps,
              "flash_attention_general": 0}
    if launches != design:
        raise AssertionError(f"serve path: attention launches {launches}, the design gives "
                             f"{design}")
    tokens = report["tokens"]
    if tokens.shape != (args.requests, args.decode_steps) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab:
        raise AssertionError(f"serve path: tokens of shape {tokens.shape} outside [0, vocab)")
    kernel_logits = rec.logits
    if not all(bool(x.isfinite().all()) for x in kernel_logits):
        raise AssertionError("serve path: non-finite logits")

    # The plain route and the fault controls, teacher-forced with the
    # kernel route's tokens.
    fed = torch.from_numpy(tokens).to(dev)
    checked = CheckedPlain()
    plain_logits = replay(torch, model, prompts, fed, checked)
    rel_errs = logit_rel_errs(kernel_logits, plain_logits)
    controls = {}
    for name, attention in (("window ignored on local layers", global_attention),
                            ("ragged tail tile of keys dropped", tail_dropped_attention)):
        controls[name] = logit_rel_errs(replay(torch, model, prompts, fed, attention),
                                        plain_logits)
    print(f"LM logits against the plain route (max |a - b| / max |b| per call, limit "
          f"{LOGIT_RTOL}): kernel route {max(rel_errs):.4g}; " + "; ".join(
              f"{name} {max(errs):.4g}" for name, errs in controls.items()), flush=True)
    shares = checked.control_shares
    flagged = sum(x > 1.0 for x in shares)
    print(f"LM attention calls of the plain route: the kernel on the same inputs within "
          f"{checked.share:.3g} of its limit (max |err| {checked.max_abs_err:.3g}; by variant "
          f"{checked.share_by_variant}) at "
          f"{checked.calls} calls; the tail-dropped control beyond it at {flagged} of "
          f"{len(shares)} ragged decode calls ({min(shares):.3g}-{max(shares):.3g} of it)",
          flush=True)
    if checked.calls != expected:
        raise AssertionError(f"serve path: {checked.calls} checked attention calls, not {expected}")
    if max(shares[:cfg.n_layers]) <= 1.0:
        raise AssertionError("serve path: the per-call check cannot tell the tail-dropped control "
                             "(one key) at the first decode step")
    if max(rel_errs) > LOGIT_RTOL:
        raise AssertionError(f"serve path: logits differ from the plain route by "
                             f"{max(rel_errs):.3g} of their largest value (limit {LOGIT_RTOL})")
    for name, errs in controls.items():
        if max(errs) <= LOGIT_RTOL:
            raise AssertionError(f"serve path: the control '{name}' reads {max(errs):.3g}, "
                                 f"within the limit {LOGIT_RTOL}: the comparison cannot tell it")
    near_ties = []
    for s, b in enumerate(plain_logits[:args.decode_steps]):
        plain_top = b.argmax(dim=1)
        kern_tok = fed[:, s].long()
        for r in (plain_top != kern_tok).nonzero().flatten().tolist():
            gap = float(b[r, plain_top[r]] - b[r, kern_tok[r]])
            if gap > LOGIT_RTOL * float(b[r].abs().max()):
                raise AssertionError(f"serve path: request {r} step {s}: token "
                                     f"{int(kern_tok[r])} is {gap:.4g} below the plain "
                                     f"route's top logit, beyond a near-tie")
            near_ties.append({"request": r, "step": s, "gap": gap})
    decode_ms = [t * 1e3 for t in report["decode_step_s"]]
    trace = decode_trace(torch, model, prompts, dev)
    out = {
        "arch": LM_ARCH, "n_params": cfg.n_params(), "requests": args.requests,
        "prompt_len": args.prompt_len, "decode_steps": args.decode_steps,
        "cache_len": int(report["cache_len"]), "init_s": init_s,
        "prefill_s": report["prefill_s"], "decode_step_ms": decode_ms,
        "decode_step_ms_median": report["decode_step_s_median"] * 1e3,
        "wall_s": report["wall_s"], "tokens_per_s": report["tokens_per_s"],
        "peak_memory_bytes": int(peak_bytes),
        "attention_launches": launches, "launches_expected": design,
        "logit_rel_err": rel_errs, "logit_rel_err_max": max(rel_errs),
        "control_logit_rel_err": controls, "attention_calls_checked": checked.calls,
        "attention_max_abs_err": checked.max_abs_err, "attention_share_of_limit": checked.share,
        "attention_share_of_limit_by_variant": checked.share_by_variant,
        "tail_control_share_of_limit": shares,
        "near_ties": near_ties, "first_request": tokens[0].tolist(), "decode_trace": trace,
    }
    print(f"LM serve path: {LM_ARCH} ({cfg.n_params() / 1e9:.3f} B parameters), "
          f"{args.requests} x {args.prompt_len} prompt tokens + {args.decode_steps} steps: "
          f"{out['tokens_per_s']:.1f} tok/s, prefill {out['prefill_s']:.3f} s, median decode "
          f"step {out['decode_step_ms_median']:.2f} ms, peak memory "
          f"{peak_bytes / 2**30:.2f} GiB; attention launches {launches} (as designed); "
          f"{len(near_ties)} near-tie tokens", flush=True)
    return out, launches


def decode_trace(torch, model, prompts, dev, steps: int = 4) -> dict:
    """The decode step under ``torch.profiler``: a fresh cache and the
    prompts prefilled (not traced), one warm step, then ``steps`` greedy
    steps traced.  Returns ms per step on the host clock, the device's
    kernel ms per step (one stream, so kernels do not overlap), the
    attention kernels' part of it, and the device's idle share; None
    where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T

    cache = T.init_cache(model.cfg, prompts.shape[0], prompts.shape[1] + steps + 1, dev)
    logits, cache = T.prefill(model, torch.from_numpy(prompts).to(dev), cache)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    logits, cache = T.decode_step(model, nxt, cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            logits, cache = T.decode_step(model, nxt, cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    del cache
    device_us = attention_us = 0.0
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        device_us += us
        if "flash_" in e.key:
            attention_us += us
    if device_us <= 0.0:
        print("decode trace: the profiler saw no device time (not measured)", flush=True)
        return {"step_ms": wall_ms, "device_ms": None, "attention_ms": None, "idle_share": None}
    out = {"step_ms": wall_ms, "device_ms": device_us / 1e3 / steps,
           "attention_ms": attention_us / 1e3 / steps,
           "idle_share": 1.0 - device_us / 1e3 / steps / wall_ms}
    print(f"decode trace ({steps} steps, torch.profiler): {out['step_ms']:.2f} ms a step on the "
          f"host clock, device kernels {out['device_ms']:.2f} ms (attention "
          f"{out['attention_ms']:.2f} ms), device idle {out['idle_share']:.1%}", flush=True)
    return out


def visible_pairs(lq: int, lk: int, causal: bool, window) -> int:
    """(query, key) pairs the masks leave visible, counted exactly."""
    p = np.arange(lq, dtype=np.int64) + (lk - lq)
    hi = np.minimum(p, lk - 1) if causal else np.full(lq, lk - 1, np.int64)
    lo = np.maximum(p - window + 1, 0) if window is not None else np.zeros(lq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_rows(torch, dev, launches, checked_errs):
    """The attention at the LM path's shapes in bf16 (the model's strided
    layout): a local and a global layer's prefill, and a global and a local
    layer's last decode step.  Decode rotates over enough copies of its
    inputs to exceed the L2 cache, as each layer's own cache would.
    Returns four entries: the attention call (``flash_attention_kernel``)
    at all four shapes, the sm90 variant at the prefill shapes, and the
    decode variant's split kernel and combine, each alone against its
    plain version, at the decode shapes."""
    import torch.nn.functional as F

    from _torch_parity import flash_close, flash_inputs, p_rounding_term
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (attention_ref, combine_ref,
                                                         decode_partials_ref)

    b, h, hkv, d = LM_REQUESTS, 8, 4, 256
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lk_decode = LM_PROMPT_LEN + LM_DECODE_STEPS
    shapes = [("prefill, local layer (window 1024)", LM_PROMPT_LEN, LM_PROMPT_LEN, 1024, 1),
              ("prefill, global layer", LM_PROMPT_LEN, LM_PROMPT_LEN, 2**30, 1),
              ("decode, global layer", 1, lk_decode, 2**30, 4),
              ("decode, local layer (window 1024)", 1, lk_decode, 1024, 4)]
    call_rows, sm90_rows, decode_rows, combine_rows = [], [], [], []
    for n, (shape, lq, lk, window, copies) in enumerate(shapes):
        sets = [flash_inputs(dev, torch.bfloat16, b, h, hkv, lq, lk, d, seed=100 + n + c,
                             model_layout=True)
                for c in range(copies)]
        q, k, v = sets[0]
        route = FK.flash_route(q.dtype, h, hkv, lq, d)
        got = FK.flash_attention_cuda(q, k, v, causal=True, window=window)
        extra = p_rounding_term(q, k, v, True, window) if route == "sm90" else None
        err, share = flash_close(got, attention_ref(q.float(), k.float(), v.float(), True, window),
                                 extra)
        i = torch.arange(lq, device=dev)[:, None] + (lk - lq)
        j = torch.arange(lk, device=dev)[None, :]
        mask = (j <= i) & (j > i - window)

        def library_mask(q=q, k=k, v=v, mask=mask):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)

        # The fastest single call of the same function: no boolean mask
        # where none is needed (it keeps the library off its flash backend).
        if window < lk:
            library, library_call = library_mask, "attn_mask (the window needs it)"
        elif lq == lk:
            library, library_call = (lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)), "is_causal=True"
        else:  # one query at the end of the keys sees every key
            library, library_call = (lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True)), "no mask"
        plain = plain_attention(q, k, v, True, window)
        assert_close_tol("scaled_dot_product_attention yardstick", library_mask(), plain,
                         LIBRARY_TOL)
        assert_close_tol(f"scaled_dot_product_attention ({library_call}) yardstick", library(),
                         plain, LIBRARY_TOL)
        turn = iter(range(10**9))

        def kernel(sets=sets, window=window):
            qq, kk, vv = sets[next(turn) % len(sets)]
            return FK.flash_attention_cuda(qq, kk, vv, causal=True, window=window)

        ms = time_ms(kernel)
        plain_ms = time_ms(lambda q=q, k=k, v=v, window=window: plain_attention(q, k, v, True, window),
                           reps=3)
        library_mask_ms = time_ms(library_mask, reps=5)
        library_ms = library_mask_ms if library is library_mask else time_ms(library, reps=5)
        device = {"ms": graph_ms(kernel), "library_ms": graph_ms(library, reps=5),
                  "library_mask_ms": graph_ms(library_mask, reps=5)}
        pairs = visible_pairs(lq, lk, True, window)
        ops = 4 * b * h * d * pairs
        # Each input read once: q, and the K/V rows some query row sees
        # (a local decode needs the window's 1024 of 2064); o written once.
        visible_keys = lk - max(0, lk - lq - window + 1)
        kv_bytes = 2 * 2 * b * hkv * visible_keys * d
        nbytes = 2 * (q.numel() + got.numel()) + kv_bytes
        bytes_ms, ops_ms = nbytes / MEM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
        row = {
            "shape": f"{shape}: q ({b}, {h}, {lq}, {d}), k/v ({b}, {hkv}, {lk}, {d}) bf16",
            "variant": route, "visible_pairs": pairs, "visible_keys": visible_keys, "ops": ops,
            "bytes": nbytes, "max_abs_err": err, "share_of_limit": share, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "library_call": library_call,
            "library_mask_ms": library_mask_ms, "device_ms": device,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        call_rows.append(row)
        if route == "sm90":
            sm90_rows.append(row)  # the call is the variant's one launch
        else:
            decode_rows.append(decode_split_row(torch, FK, decode_partials_ref, sets, shape,
                                                window, FK.decode_plan(lq, lk, window, b * hkv,
                                                                       sms), q.numel() * 2 + kv_bytes,
                                                ops))
            combine_rows.append(decode_combine_row(torch, FK, combine_ref, sets[0], shape, window,
                                                   decode_rows[-1]["plan"]))
        del sets, q, k, v, got, mask, plain
    entries = [kernel_entry("flash_attention_kernel", launches, call_rows,
                            variant=call_rows[0]["variant"]),
               kernel_entry("flash_attention_sm90", launches, sm90_rows, variant="sm90"),
               kernel_entry("flash_attention_decode", launches, decode_rows, variant="decode"),
               kernel_entry("flash_attention_combine", launches, combine_rows, variant="decode")]
    entries[0]["max_abs_err"] = max(entries[0]["max_abs_err"],
                                    *(checked_errs[t]["max_abs_err"] for t in ("float32",
                                                                               "bfloat16")))
    return entries


def decode_split_row(torch, FK, decode_partials_ref, sets, shape, window, plan, in_bytes, ops):
    """The decode variant's split kernel alone against its plain version:
    partials within rtol 1e-4 and 1e-4 of the largest |acc| (fp32 sums in
    another order)."""
    q, k, v = sets[0]
    ml, acc = FK.decode_partials_cuda(q, k, v, True, window, plan)
    want_ml, want_acc = decode_partials_ref(q, k, v, True, window, plan)
    torch.testing.assert_close(ml, want_ml, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(acc, want_acc, rtol=1e-4, atol=1e-4 * float(want_acc.abs().max()))
    err = max(float((ml - want_ml).abs().max()), float((acc - want_acc).abs().max()))
    turn = iter(range(10**9))

    def kernel():
        qq, kk, vv = sets[next(turn) % len(sets)]
        return FK.decode_partials_cuda(qq, kk, vv, True, window, plan)

    ms = time_ms(kernel)
    device_ms = graph_ms(kernel)
    plain_ms = time_ms(lambda: decode_partials_ref(q, k, v, True, window, plan), reps=3)
    # q and the visible K/V rows read once, the fp32 partials written once.
    nbytes = in_bytes + 4 * (ml.numel() + acc.numel())
    bytes_ms, ops_ms = nbytes / MEM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return {"shape": f"{shape}: split-K partials, plan (j_begin, j_end, chunk, splits) {plan}",
            "plan": plan, "bytes": nbytes, "ops": ops, "max_abs_err": err, "ms": ms,
            "device_ms": device_ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def decode_combine_row(torch, FK, combine_ref, qkv, shape, window, plan):
    """The decode variant's combine alone, on the plain version's partials,
    against the plain combine (``FLASH_TOL``: one rounding to bf16)."""
    from _torch_parity import flash_close
    from repro_torch.kernels.flash_attention.ref import decode_partials_ref

    q, k, v = qkv
    b, h, lq, _ = q.shape
    hkv = k.shape[1]
    ml, acc = decode_partials_ref(q, k, v, True, window, plan)
    out = torch.empty_like(q)
    FK.combine_cuda(ml, acc, out, hkv)
    err, _share = flash_close(out, combine_ref(ml, acc, b, h, hkv, lq, torch.float32))
    ms = time_ms(lambda: FK.combine_cuda(ml, acc, out, hkv))
    device_ms = graph_ms(lambda: FK.combine_cuda(ml, acc, out, hkv))
    plain_ms = time_ms(lambda: combine_ref(ml, acc, b, h, hkv, lq, q.dtype), reps=5)
    nbytes = 4 * (ml.numel() + acc.numel()) + 2 * out.numel()
    return {"shape": f"{shape}: combine of {plan[3]} splits", "bytes": nbytes,
            "max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": nbytes / MEM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def kernel_entry(name, launches, rows, variant):
    source, replaces = SOURCES[name]
    main = rows[0]
    return {
        "name": name, "route": "cuda", "variant": variant, "source": source,
        "replaces": replaces, "launches": int(launches[name]),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main.get("bound_by", "bytes"), "library_ms": main.get("library_ms"),
        "shapes": rows,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))  # _torch_parity: the flash kernel's cases
    from repro_torch.kernels import build as B
    from repro_torch.launch import search

    t_start = time.perf_counter()
    print(card_line(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    paths = B.build_libraries()
    print(f"built {sorted(p.name for p in paths.values())} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for stem, lines in B.PTXAS.items():
        print(f"ptxas {stem}.cu: " + " | ".join(lines), flush=True)

    check_intersect_cases(torch, dev)
    check_fold_cases(torch, dev)
    score_case_err = check_cluster_score_cases(torch, dev)

    # The search path: only the search kernels' counters are read.
    args = search.build_parser().parse_args([
        "--corpus", "wiki", "--docs", str(N_DOCS), "--k", str(K_CLUSTERS), "--tc", "3000",
        "--queries", str(N_QUERIES), "--device", "cuda",
    ])
    from repro_torch.kernels.intersect import kernel as search_kernels

    B.reset_launch_counts()
    svc, logs, report = search.setup(args)
    recorder = Spans(torch)  # the fold's arguments per batch, for its timing below
    fold_batches = recorder.record_calls(search_kernels, "segment_fold_cuda",
                                         lambda *fold_args, **_: fold_args)
    try:
        search.serve(svc, logs, report)
        torch.cuda.synchronize()
    finally:
        recorder.restore()
    launches = {name: B.LAUNCHES[name] for name in SEARCH_KERNELS}
    print(f"launches on the search path: {launches}", flush=True)
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels the search path never launched: {missing}")
    n_batches = sum(report[f"engine_{name}"]["n_batches"] for name in logs)
    if not launches["segment_fold"] == len(fold_batches) == n_batches:
        raise AssertionError(f"{launches['segment_fold']} fold launches for {n_batches} batches")
    print("search path: n_docs={n_docs} n_postings={n_postings} index_nbytes={index_nbytes} "
          "fit_s={fit_s:.1f}".format(**report))
    for name in logs:
        e = report[f"engine_{name}"]
        print(f"  {name}: median t_plan_s={e['t_plan_s_median']:.6f} "
              f"t_lower_s={e['t_lower_s_median']:.6f} t_fold_s={e['t_fold_s_median']:.6f}")

    # The clustering path: only the cluster_scores counter is read.
    kmeans, kmeans_launches = device_kmeans(torch, dev, svc.res)
    for name in ("cluster_scores_kernel", "cluster_scores_staged"):
        launches[name] = kmeans_launches[name]
    print("clustering path: device TopDown k_actual={k_actual} (host fit {host_k}) in "
          "{wall_s:.1f}s vs host fit {host_fit_cluster_time_s:.1f}s (ratio "
          "{wall_ratio_to_host:.3f}); psi {psi:.6g} / host {psi_host_fit:.6g} = "
          "{psi_ratio_to_host:.4f}, random {psi_random:.6g}; {device_calls} device K-means "
          "calls, {device_rounds} device rounds ({accepted_rounds} accepted), "
          "cluster_scores_kernel launches {cluster_scores_launches}".format(
              host_k=svc.res.k, **kmeans), flush=True)
    print("  host-clock spans (s): " + " ".join(
        f"{name}={sec:.3f}" for name, sec in sorted(kmeans["spans_s"].items())), flush=True)

    ell, p, tables8, kmeans["round_check"] = round_check(torch, dev, svc.res.view)

    # The LM serving path: only the attention kernel's counter is read.
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions run in full fp32
    torch.backends.cudnn.allow_tf32 = False
    flash_errs = check_flash_cases(torch, dev)
    lm, lm_launches = lm_serve(torch, dev)
    launches.update(lm_launches)

    fold = fold_rows(torch, svc, logs, launches, fold_batches)
    del fold_batches
    scores = cluster_scores_rows(torch, svc.res.view, ell, p, tables8, launches,
                                 max(score_case_err, kmeans["round_check"]["max_abs_err"]))
    del ell, p, tables8
    buckets, score_excess = topdown_score_buckets(torch, dev, kmeans["score_shapes"], launches)
    staged = kernel_entry("cluster_scores_staged", launches, scores["shapes"][:1], variant="staged")
    staged["device_ms"], staged["old_ms"] = scores["device_ms"], scores["old_ms"]
    kernels = [fold, *intersect_rows(torch, svc, logs, launches), scores, staged,
               *flash_rows(torch, dev, launches, flash_errs)]
    for k in kernels:
        print(f"{k['name']} [{k['variant']}]: launches={k['launches']} ms={k['ms']:.4f} "
              f"plain_ms={k['plain_ms']:.4f} bound_ms={k['bound_ms']:.5f} ({k['bound_by']})"
              + (f" library_ms={k['library_ms']:.4f}" if k["library_ms"] is not None else "")
              + (f" device_ms={k['device_ms']:.4f}" if "device_ms" in k else "")
              + (f" old_ms={k['old_ms']:.4f}" if "old_ms" in k else ""), flush=True)
    for row in fold["shapes"]:
        print(f"segment_fold {row['shape']}: upload_ms={row['upload_ms']:.4f} "
              f"kernel_ms={row['ms']:.4f} device_ms={row['device_ms']:.4f} "
              f"copyback_ms={row['copyback_ms']:.4f} bytes={row['bytes']} "
              f"bound_ms={row['bound_ms']:.5f}", flush=True)
    print(f"segment_fold over the search run's {len(fold['batches'])} batches: "
          f"sum of launches x (device ms - bound ms) = {fold['excess_ms']:.4f} ms "
          f"(device ms per batch {[round(b['device_ms'], 4) for b in fold['batches']]})",
          flush=True)
    for row in buckets:
        print(f"cluster_scores TopDown bucket N<={row['bucket'][0]} L<={row['bucket'][1]} "
              f"K={row['bucket'][2]}: {row['launches']} launches, at {tuple(row['shape'])} "
              f"(valid share {row['valid_share']:.3f}) staged {row['staged_ms']:.4f} ms "
              f"(device {row['staged_device_ms']:.4f}), general {row['general_ms']:.4f} ms "
              f"(device {row['general_device_ms']:.4f}), bound {row['bound_ms']:.5f} ms",
              flush=True)
    print("cluster_scores over the device TopDown: sum of launches x (ms - bound ms) = "
          f"{score_excess['staged']:.3f} ms staged, device {score_excess['staged_device']:.3f} "
          f"ms (general, the first design: {score_excess['general']:.3f} ms, device "
          f"{score_excess['general_device']:.3f} ms)", flush=True)
    kmeans["score_buckets"], kmeans["score_excess_ms"] = buckets, score_excess
    for row in kernels[-4]["shapes"]:
        print(f"flash_attention_kernel {row['shape']} [{row['variant']}]: ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
              f"({row['library_call']}) library_mask_ms={row['library_mask_ms']:.4f} "
              f"device_ms (CUDA graph: kernel, library, mask) " + "/".join(
                  f"{row['device_ms'][key]:.4f}" for key in ("ms", "library_ms", "library_mask_ms"))
              + " "
              f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}) "
              f"visible_pairs={row['visible_pairs']} max_abs_err={row['max_abs_err']:.3g} "
              f"({row['share_of_limit']:.3g} of the limit)",
              flush=True)
    for entry in kernels[-2:]:
        for row in entry["shapes"]:
            print(f"{entry['name']} {row['shape']}: ms={row['ms']:.4f} "
                  f"device_ms={row['device_ms']:.4f} "
                  f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.5f} "
                  f"({row['bound_by']}) bytes={row['bytes']} max_abs_err={row['max_abs_err']:.3g}",
                  flush=True)
    for row in scores["shapes"]:
        print(f"cluster_scores_kernel {row['shape']} [{row['variant']}]: ms={row['ms']:.4f} "
              f"device_ms={row['device_ms']:.4f} old_ms (general)={row['old_ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
              f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}) bytes={row['bytes']} "
              f"valid_slots={row['valid_slots']}", flush=True)

    out = ROOT / "chiprun_out" / "chip_smoke.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "card": card_line(), "report": report, "kmeans": kmeans, "lm": lm,
        "flash_cases": flash_errs, "ptxas": B.PTXAS, "kernels": kernels,
        "wall_s": time.perf_counter() - t_start,
    }, indent=1, default=float))
    print(json.dumps({"kernels": [
        {k: v for k, v in entry.items() if k != "shapes"} for entry in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
