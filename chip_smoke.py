"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # one GPU, no arguments

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels of ``src/repro_torch/csrc`` for ``sm_90a``;
3. holds each kernel against its plain PyTorch version on the card, on
   random and edge-case inputs (exact equality: the outputs are integers);
4. drives the main path through the launcher's own functions
   (``repro_torch.launch.search``): a host fit of the ``wiki`` corpus at
   ``N_DOCS`` documents and two logs of ``N_QUERIES`` queries, the
   index uploaded to the card, both query logs served through the fold
   kernel and the block path, every batch checked against the host
   engine bit for bit — with every launch counter set to 0 just before
   and read just after;
5. times each kernel against its plain version at the main path's
   shapes, and prints one JSON line listing every kernel;
6. prints ``{"ok": true, "device": {...}}`` as its last line.

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
SECTOR_BYTES = 32  # the card's smallest device-memory transaction
# The main path's size: the `wiki` preset at 200,000 documents, the scale
# the host fit affords.  A cut changes these and is recorded in PERF.md.
N_DOCS = 200_000
N_QUERIES = 2000
SOURCES = {
    "segment_fold": ("src/repro_torch/csrc/fold.cu", "src/repro/core/device_engine.py:396"),
    "intersect_members_kernel": (
        "src/repro_torch/csrc/intersect.cu", "src/repro/kernels/intersect/kernel.py:182"),
    "intersect_members_count_kernel": (
        "src/repro_torch/csrc/intersect.cu", "src/repro/kernels/intersect/kernel.py:203"),
    "intersect_count_kernel": (
        "src/repro_torch/csrc/intersect.cu", "src/repro/kernels/intersect/kernel.py:223"),
}


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


def kernel_entry(name, launches, rows):
    source, replaces = SOURCES[name]
    main = rows[0]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": int(launches[name]),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "shapes": rows,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.intersect import kernel as K
    from repro_torch.launch import search

    t_start = time.perf_counter()
    print(card_line(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    paths = K.build_libraries()
    print(f"built {sorted(p.name for p in paths.values())} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    check_intersect_cases(torch, dev)
    check_fold_cases(torch, dev)

    args = search.build_parser().parse_args([
        "--corpus", "wiki", "--docs", str(N_DOCS), "--k", "256", "--tc", "3000",
        "--queries", str(N_QUERIES), "--device", "cuda",
    ])
    K.reset_launch_counts()
    svc, logs, report = search.setup(args)
    search.serve(svc, logs, report)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print(f"launches on the main path: {launches}", flush=True)
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels the main path never launched: {missing}")
    print("main path: n_docs={n_docs} n_postings={n_postings} index_nbytes={index_nbytes} "
          "fit_s={fit_s:.1f}".format(**report))
    for name in logs:
        e = report[f"engine_{name}"]
        print(f"  {name}: median t_plan_s={e['t_plan_s_median']:.6f} "
              f"t_lower_s={e['t_lower_s_median']:.6f} t_fold_s={e['t_fold_s_median']:.6f}")

    kernels = [fold_rows(torch, svc, logs, launches), *intersect_rows(torch, svc, logs, launches)]
    for k in kernels:
        print(f"{k['name']}: launches={k['launches']} ms={k['ms']:.4f} "
              f"plain_ms={k['plain_ms']:.4f} bound_ms={k['bound_ms']:.5f}", flush=True)
    for row in kernels[0]["shapes"]:
        print(f"segment_fold {row['shape']}: upload_ms={row['upload_ms']:.4f} "
              f"kernel_ms={row['ms']:.4f} copyback_ms={row['copyback_ms']:.4f} "
              f"bytes={row['bytes']} post_docs_bytes_read={row['post_docs_bytes_read']}",
              flush=True)

    out = ROOT / "chiprun_out" / "chip_smoke.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "card": card_line(), "report": report, "kernels": kernels,
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
