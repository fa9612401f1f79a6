"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # one GPU, no arguments

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of ``src/repro_torch/csrc`` for ``sm_90a``
   (one ``nvcc`` per source, all started together);
3. holds each kernel against its plain PyTorch version on the card, on
   random and edge-case inputs: the search kernels exactly (their outputs
   are integers), ``cluster_scores`` within ``rtol=2e-5, atol=1e-5``;
4. drives the search path through the launcher's own functions
   (``repro_torch.launch.search``): a host fit of the ``wiki`` corpus at
   ``N_DOCS`` documents and two logs of ``N_QUERIES`` queries, the
   index uploaded to the card, both query logs served through the fold
   kernel and the block path, every batch checked against the host
   engine bit for bit — with every launch counter set to 0 just before
   and the search kernels' counters read just after;
5. drives the clustering path: TopDown over the same frequent-term view
   with the device K-means (``distributed_kmeans_fn([cuda:0])``) as its
   ``kmeans_fn``, counters set to 0 just before and the
   ``cluster_scores`` counter read just after; checks the labels and
   that ψ beats a random assignment, and compares ψ and wall time with
   the host fit's;
6. runs one K-means round at full size through the kernel and through
   the plain version on the card (equal counts, bit-equal tables, scores
   within the tolerance, assignments equal but for near-ties);
7. times each kernel against its plain version at the main path's
   shapes, and prints one JSON line listing every kernel;
8. prints ``{"ok": true, "device": {...}}`` as its last line.

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
    torch.cuda.synchronize()
    print(f"segment_fold: {n_checked} plans over an L=3 index (arities 1-5) "
          "equal to the plain version")


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
    all-pad rows, pads at 2**31 - 1, duplicate ranks, and TC = 3000 at
    K = 8 and K = 256."""
    from repro_torch.kernels.cluster_score.kernel import cluster_scores_cuda
    from repro_torch.kernels.cluster_score.ref import cluster_scores_ref

    rng = np.random.default_rng(0)
    shapes = [(4, 8, 32, 4), (16, 128, 128, 8), (10, 50, 300, 33), (32, 64, 1024, 128),
              (0, 8, 32, 4), (6, 0, 32, 4), (9, 40, 64, 1), (20, 100, 500, 300),
              (1000, 742, 3000, 8), (2000, 742, 3000, 256)]
    err = 0.0
    for n, l, tc, k in shapes:
        ell, p, tables = (torch.from_numpy(a).to(dev) for a in score_inputs(rng, n, l, tc, k))
        got, want = cluster_scores_cuda(ell, p, tables), cluster_scores_ref(ell, p, tables)
        err = max(err, assert_close("cluster_scores_kernel", got, want))
        if n and l >= 3 and bool(got[0].any()):
            raise AssertionError("cluster_scores_kernel: an all-pad row is not zero")
    tc, k = 16, 4
    ell = torch.tensor([[3, 3, 3, tc, PAD_MAX]], dtype=torch.int32, device=dev)
    p = torch.arange(1, tc + 1, dtype=torch.float32, device=dev)
    tables = torch.eye(tc, k, dtype=torch.float32, device=dev)
    want = torch.zeros((1, k), dtype=torch.float32, device=dev)
    want[0, 3] = 3 * p[3]
    err = max(err, assert_close("cluster_scores_kernel", cluster_scores_cuda(ell, p, tables), want))
    torch.cuda.synchronize()
    print(f"cluster_scores_kernel: {len(shapes) + 1} random/edge cases within "
          f"rtol={SCORE_RTOL}, atol={SCORE_ATOL} of the plain version (max |err| {err:.3g})",
          flush=True)
    return err


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


def fold_rows(torch, svc, logs, launches):
    from repro_torch.core.batched_query import plan_segment_pairs
    from repro_torch.core.device_engine import lower_plan
    from repro_torch.core.queries import as_queries
    from repro_torch.kernels.intersect import kernel as K
    from repro_torch.kernels.intersect.ref import segment_fold_ref
    from repro_torch.launch.search import SERVE_BATCH

    di = svc.device_index
    dev = di.device
    rows = []
    for name, lg in logs.items():
        cq = as_queries(lg.queries)[:SERVE_BATCH]
        low = lower_plan(plan_segment_pairs(di.host, cq, track_work=False))
        cells = torch.from_numpy(low.cells).to(dev)
        seg = torch.from_numpy(low.stage_seg).to(dev)
        args = (di.post_docs, cells, seg, low.group_width, low.stage_iters,
                low.n_queries_pad, True)
        got, want = K.segment_fold_cuda(*args), segment_fold_ref(*args)
        err = max(assert_equal("segment_fold", g, w) for g, w in zip(got, want, strict=True))
        ms = time_ms(lambda: K.segment_fold_cuda(*args))
        plain_ms = time_ms(lambda: segment_fold_ref(*args), reps=5)
        # The rest of device_counts' t_fold_s: the plan's upload and the
        # copy of the results back, timed apart from the kernel.
        upload_ms = time_ms(lambda: (torch.from_numpy(low.cells).to(dev),
                                     torch.from_numpy(low.stage_seg).to(dev)), reps=5)
        copyback_ms = time_ms(lambda: [t.cpu() for t in got], reps=5)
        # Bytes the fold must move for this plan's data: the cell, segment
        # and depth arrays read once, the distinct sectors of post_docs the
        # data needs, the counts, stage totals and members written once.
        entering = want[1].cpu().numpy()
        sectors = fold_sectors_read(torch, *args[:5])
        nbytes = (low.cells.nbytes + low.stage_seg.nbytes + 8 * len(low.stage_iters)
                  + SECTOR_BYTES * sectors + 4 * low.n_queries_pad + 4 * low.n_cells)
        rows.append({
            "shape": name, "cells": int(low.n_cells), "stages": len(low.stage_iters),
            "stage_iters": list(low.stage_iters), "entering": entering.tolist(),
            "post_docs_bytes_read": SECTOR_BYTES * sectors, "bytes": nbytes,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / MEM_BYTES_PER_S * 1e3,
            "upload_ms": upload_ms, "copyback_ms": copyback_ms,
        })
    return kernel_entry("segment_fold", launches, rows)


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
        entries.append(kernel_entry(name, launches, [{
            "shape": f"{tuple(s.shape)} x {tuple(l.shape)}", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": nbytes / MEM_BYTES_PER_S * 1e3,
        }]))
    return entries


def cluster_scores_rows(torch, view, ell, p, tables8, launches, checked_err):
    """The top TopDown split's shape (K = 8, the round's own tables) and
    the flat algorithm's (K = 256, tables of a seeded random
    assignment), over the full ELL.  The entry's ``max_abs_err`` also
    covers the earlier checks (``checked_err``)."""
    import torch.nn.functional as F

    from repro_torch.core import torch_ops as T
    from repro_torch.kernels.cluster_score.kernel import cluster_scores_cuda
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
        got, want = cluster_scores_cuda(ell, p, t), cluster_scores_ref(ell, p, t)
        err = assert_close("cluster_scores_kernel", got, want)
        t_pad = torch.cat([t, t.new_zeros((1, k))])

        def library(t_pad=t_pad):
            return F.embedding_bag(ids, t_pad, per_sample_weights=weights, mode="sum")

        assert_close("embedding_bag yardstick", library(), want)
        ms = time_ms(lambda t=t: cluster_scores_cuda(ell, p, t))
        plain_ms = time_ms(lambda t=t: cluster_scores_ref(ell, p, t), reps=3)
        library_ms = time_ms(library)
        # Each input read once, the output written once; one multiply-add
        # per valid slot and output column.
        nbytes = ell.numel() * 4 + p.numel() * 4 + t.numel() * 4 + got.numel() * 4
        ops = 2 * n_valid * k
        bytes_ms, ops_ms = nbytes / MEM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        rows.append({
            "shape": f"{shape}: ({ell.shape[0]}, {ell.shape[1]}) x ({tc}, {k})",
            "valid_slots": n_valid, "bytes": nbytes, "ops": ops,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        })
    entry = kernel_entry("cluster_scores_kernel", launches, rows)
    entry["max_abs_err"] = max(entry["max_abs_err"], checked_err)
    return entry


def kernel_entry(name, launches, rows):
    source, replaces = SOURCES[name]
    main = rows[0]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": int(launches[name]),
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

    check_intersect_cases(torch, dev)
    check_fold_cases(torch, dev)
    score_case_err = check_cluster_score_cases(torch, dev)

    # The search path: only the search kernels' counters are read.
    args = search.build_parser().parse_args([
        "--corpus", "wiki", "--docs", str(N_DOCS), "--k", str(K_CLUSTERS), "--tc", "3000",
        "--queries", str(N_QUERIES), "--device", "cuda",
    ])
    B.reset_launch_counts()
    svc, logs, report = search.setup(args)
    search.serve(svc, logs, report)
    torch.cuda.synchronize()
    launches = {name: B.LAUNCHES[name] for name in SEARCH_KERNELS}
    print(f"launches on the search path: {launches}", flush=True)
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels the search path never launched: {missing}")
    print("search path: n_docs={n_docs} n_postings={n_postings} index_nbytes={index_nbytes} "
          "fit_s={fit_s:.1f}".format(**report))
    for name in logs:
        e = report[f"engine_{name}"]
        print(f"  {name}: median t_plan_s={e['t_plan_s_median']:.6f} "
              f"t_lower_s={e['t_lower_s_median']:.6f} t_fold_s={e['t_fold_s_median']:.6f}")

    # The clustering path: only the cluster_scores counter is read.
    kmeans, kmeans_launches = device_kmeans(torch, dev, svc.res)
    launches["cluster_scores_kernel"] = kmeans_launches["cluster_scores_kernel"]
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

    kernels = [fold_rows(torch, svc, logs, launches), *intersect_rows(torch, svc, logs, launches),
               cluster_scores_rows(torch, svc.res.view, ell, p, tables8, launches,
                                   max(score_case_err, kmeans["round_check"]["max_abs_err"]))]
    for k in kernels:
        print(f"{k['name']}: launches={k['launches']} ms={k['ms']:.4f} "
              f"plain_ms={k['plain_ms']:.4f} bound_ms={k['bound_ms']:.5f} ({k['bound_by']})"
              + (f" library_ms={k['library_ms']:.4f}" if k["library_ms"] is not None else ""),
              flush=True)
    for row in kernels[0]["shapes"]:
        print(f"segment_fold {row['shape']}: upload_ms={row['upload_ms']:.4f} "
              f"kernel_ms={row['ms']:.4f} copyback_ms={row['copyback_ms']:.4f} "
              f"bytes={row['bytes']} post_docs_bytes_read={row['post_docs_bytes_read']}",
              flush=True)
    for row in kernels[-1]["shapes"]:
        print(f"cluster_scores_kernel {row['shape']}: ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
              f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}) bytes={row['bytes']} "
              f"valid_slots={row['valid_slots']}", flush=True)

    out = ROOT / "chiprun_out" / "chip_smoke.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "card": card_line(), "report": report, "kmeans": kmeans, "kernels": kernels,
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
