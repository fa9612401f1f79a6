"""SeCluD search-service launcher on one device (the paper's system, end
to end):

    PYTHONPATH=src python -m repro_torch.launch.search --docs 8000 --k 128
    PYTHONPATH=src python -m repro_torch.launch.search --device cpu --docs 2000

Builds a corpus + query log, fits the clustering on the host, uploads the
index to ``--device``, reports the paper's speedups, then serves:

  * the whole log through the device engine (``serve_counts_device`` with
    member docs, in batches of :data:`SERVE_BATCH`), and a second log of
    arities 1-5, each batch checked against the host engine bit for bit;
  * 64 queries of each log through the block path (``pack`` +
    ``device_counts``), checked against the host counts.

On ``cuda`` every step of the device path runs the CUDA kernels of
``repro_torch.kernels.intersect``; ``--device cpu`` runs their plain
PyTorch versions.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

SERVE_BATCH = 256
BLOCK_QUERIES = 64
MIXED_ARITIES = (1, 2, 3, 4, 5)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=8000)
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--corpus", default="forum",
                    choices=["forum", "gov2", "gov2s", "wiki"])
    ap.add_argument("--algo", default="topdown", choices=["topdown", "flat"])
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--tc", type=int, default=3000)
    ap.add_argument("--device", default="cuda")
    return ap


def _serve_log(svc, queries, name: str) -> Dict[str, object]:
    """Serve ``queries`` through the device engine in batches, each batch
    checked against the host engine (counts and member docs)."""
    from repro_torch.core.batched_query import batched_query
    from repro_torch.core.queries import as_queries

    cq = as_queries(queries)
    t_plan: List[float] = []
    t_lower: List[float] = []
    t_fold: List[float] = []
    n_results = 0
    for i in range(0, cq.n_queries, SERVE_BATCH):
        batch = cq[i : i + SERVE_BATCH]
        counts, docs, info = svc.serve_counts_device(batch, return_docs=True)
        ptr, host_docs, _work = batched_query(svc.query_index, batch)
        if not (np.array_equal(counts, np.diff(ptr)) and np.array_equal(docs, host_docs)):
            raise AssertionError(f"{name}: device engine disagrees with host at batch {i}")
        t_plan.append(info["t_plan_s"])
        t_lower.append(info["t_lower_s"])
        t_fold.append(info["t_fold_s"])
        n_results += int(counts.sum())
    return {
        "n_queries": cq.n_queries,
        "n_batches": len(t_fold),
        "n_results": n_results,
        "t_plan_s_median": float(np.median(t_plan)) if t_plan else 0.0,
        "t_lower_s_median": float(np.median(t_lower)) if t_lower else 0.0,
        "t_fold_s_median": float(np.median(t_fold)) if t_fold else 0.0,
    }


def _serve_blocks(svc, queries, name: str) -> Dict[str, object]:
    """Serve ``queries`` through ``pack`` + ``device_counts``, checked
    against the host counts."""
    counts, work = svc.serve_counts(queries)
    packed = svc.pack(queries)
    dev = svc.device_counts(packed).cpu().numpy()
    if not np.array_equal(dev, counts):
        raise AssertionError(f"{name}: block path disagrees with host counts")
    return {
        "n_queries": len(counts),
        "rows": packed.short.shape[0],
        "blocks": len(packed.segments),
        "host_work": float(work["work"]),
    }


def setup(args: argparse.Namespace, log_fn=print):
    """Corpus, query logs, host fit and index upload, speedup report.
    Returns ``(service, logs, report)`` with ``logs`` the arity-2 log and
    the arity 1-5 log by name."""
    from repro_torch.core.seclud import SecludPipeline
    from repro_torch.data.corpus import CorpusSpec, corpus_stats, synth_corpus
    from repro_torch.data.query_log import synth_query_log
    from repro_torch.serve.search_service import SearchService

    spec = getattr(CorpusSpec, f"{args.corpus}_like")(n_docs=args.docs)
    corpus = synth_corpus(spec)
    log = synth_query_log(corpus, n_queries=args.queries, seed=1)
    mixed = synth_query_log(corpus, n_queries=args.queries, seed=2, arity=list(MIXED_ARITIES))
    log_fn(f"corpus: {corpus_stats(corpus)}")

    pipe = SecludPipeline(tc=args.tc, doc_grained_below=512)
    t0 = time.perf_counter()
    res = pipe.fit(corpus, args.k, algo=args.algo, log=log, device=args.device)
    fit_s = time.perf_counter() - t0
    log_fn(f"fit[{args.algo}]: k={res.k} in {fit_s:.1f}s "
           f"(clustering {res.cluster_time_s:.1f}s) S_T(objective)={res.s_t:.2f}")

    t0 = time.perf_counter()
    ev = pipe.evaluate(corpus, res, log, max_queries=min(400, args.queries))
    evaluate_s = time.perf_counter() - t0
    log_fn(f"speedups: S_T={ev['S_T']:.2f} S_C={ev['S_C']:.2f} "
           f"S_R={ev['S_R']:.2f} over {int(ev['n_queries'])} queries (lossless)")

    svc = SearchService(res, device=args.device)
    dindex = svc.device_index
    report: Dict[str, object] = {
        "device": str(dindex.device),
        "n_docs": int(dindex.n_docs),
        "n_postings": int(dindex.n_postings),
        "index_nbytes": int(dindex.nbytes),
        "k": int(res.k),
        "fit_s": fit_s,
        "evaluate_s": evaluate_s,
        "speedups": {key: float(ev[key]) for key in ("S_T", "S_C", "S_R")},
    }
    return svc, {"arity2": log, "arity1to5": mixed}, report


def serve(svc, logs, report: Dict[str, object], log_fn=print) -> Dict[str, object]:
    """Serve every log through the device engine and its first
    :data:`BLOCK_QUERIES` queries through the block path, each checked
    against the host engine; adds the results to ``report``."""
    for name, lg in logs.items():
        t0 = time.perf_counter()
        served = _serve_log(svc, lg.queries, name)
        served["wall_s"] = time.perf_counter() - t0
        report[f"engine_{name}"] = served
        log_fn(f"device engine [{name}]: {served['n_queries']} queries in "
               f"{served['n_batches']} batches agree with host "
               f"({served['n_results']} results); median t_fold "
               f"{served['t_fold_s_median'] * 1e3:.2f} ms")
        blocks = _serve_blocks(svc, lg.queries[:BLOCK_QUERIES], name)
        report[f"blocks_{name}"] = blocks
        log_fn(f"block path [{name}]: {blocks['n_queries']} queries, "
               f"{blocks['rows']} segment rows, agrees with host")
    return report


def run(args: argparse.Namespace, log_fn=print) -> Dict[str, object]:
    """The launcher's whole path; returns its report (sizes and host
    timings).  Raises on any disagreement between device and host."""
    svc, logs, report = setup(args, log_fn)
    return serve(svc, logs, report, log_fn)


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
