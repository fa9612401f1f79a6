"""SeCluD search-service launcher on one device (the paper's system, end
to end):

    PYTHONPATH=src python -m repro_torch.launch.search --docs 8000 --k 128
    PYTHONPATH=src python -m repro_torch.launch.search --device cpu --docs 2000
    PYTHONPATH=src python -m repro_torch.launch.search --device cpu --docs 2000 \
        --shards 2 --qps 2000

Builds a corpus + query log, fits the clustering on the host, uploads the
index to ``--device``, reports the paper's speedups, then serves:

  * the whole log through the device engine (``serve_counts_device`` with
    member docs, in batches of :data:`SERVE_BATCH`), and a second log of
    arities 1-5, each batch checked against the host engine bit for bit;
  * 64 queries of each log through the block path (``pack`` +
    ``device_counts``), checked against the host counts.

With ``--shards N`` the serving tier follows (:func:`serve_tier`), on N
shard slots of ``--device``:

  * both logs again through the sharded engine (``enable_sharded``), every
    batch checked against the host engine, and the block path split over
    the N slots (``device_counts(packed, devices=...)``);
  * for each ``--qps``, a Poisson-arrival log of ``--queries`` queries
    (the settings of :func:`traffic_log`) replayed sealed through the
    deadline batcher (:data:`REPLAY_MAX_BATCH`, :data:`REPLAY_DEADLINE_S`)
    and the resilience ladder after ``prewarm``: counts
    equal to the host engine, no compile, every batch served at the
    ``"device"`` rung;
  * an async (wall-clock) replay at the first ``--qps``, exact;
  * two chaos replays of :data:`CHAOS_QUERIES` queries at the first
    ``--qps``: shard 0 lost at batch 2
    (that batch served at the ``"remesh"`` rung, the corpus
    re-partitioned over the survivors), and a queue flood of 600 at batch
    3 for 3 batches against a shed depth of 500 (exactly those batches
    shed, and any other only where its real backlog passes the depth);
    every answered request exact.

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
# The serving tier's replay: the deadline batcher's policy, and a
# flood deep enough to pass the shed depth for its three batches.
REPLAY_MAX_BATCH = 64
REPLAY_DEADLINE_S = 0.002
SHED_QUEUE_DEPTH = 500
FLOOD = dict(at=3, depth=600, n_batches=3)
LOST_SHARD, LOST_AT = 0, 2
# The chaos replays' log (the reference's quick chaos bench): fewer
# requests than the shed depth, so no real backlog can pass it however
# far the host falls behind, and only the flood's batches can be shed.
CHAOS_QUERIES = 400
# Info keys of the sharded engine whose medians a served log reports.
SHARD_KEYS = ("shards_touched", "load_balance", "agg_throughput")


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
    ap.add_argument("--shards", type=int, default=0,
                    help="serving tier on this many shard slots of --device (0: off)")
    ap.add_argument("--qps", type=float, nargs="+", default=[2000.0],
                    help="arrival rates of the serving tier's replays")
    return ap


def _serve_log(svc, queries, name: str) -> Dict[str, object]:
    """Serve ``queries`` through the device engine in batches, each batch
    checked against the host engine (counts and member docs)."""
    from repro_torch.core.batched_query import batched_query
    from repro_torch.core.queries import as_queries

    cq = as_queries(queries)
    keys = ("t_plan_s", "t_lower_s", "t_fold_s") + SHARD_KEYS
    seen: Dict[str, List[float]] = {key: [] for key in keys}
    n_batches = n_results = 0
    for i in range(0, cq.n_queries, SERVE_BATCH):
        batch = cq[i : i + SERVE_BATCH]
        counts, docs, info = svc.serve_counts_device(batch, return_docs=True)
        ptr, host_docs, _work = batched_query(svc.query_index, batch)
        if not (np.array_equal(counts, np.diff(ptr)) and np.array_equal(docs, host_docs)):
            raise AssertionError(f"{name}: device engine disagrees with host at batch {i}")
        for key in keys:
            if key in info:
                seen[key].append(float(info[key]))
        n_batches += 1
        n_results += int(counts.sum())
    out: Dict[str, object] = {"n_queries": cq.n_queries, "n_batches": n_batches,
                              "n_results": n_results}
    for key, values in seen.items():
        if values:
            out[f"{key}_median"] = float(np.median(values))
    return out


def _serve_blocks(svc, queries, name: str, devices=None) -> Dict[str, object]:
    """Serve ``queries`` through ``pack`` + ``device_counts`` (split over
    ``devices`` when given), checked against the host counts."""
    counts, work = svc.serve_counts(queries)
    packed = svc.pack(queries)
    dev = svc.device_counts(packed, devices=devices).cpu().numpy()
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
    Returns ``(service, logs, report, corpus)`` with ``logs`` the arity-2
    log and the arity 1-5 log by name."""
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
    return svc, {"arity2": log, "arity1to5": mixed}, report, corpus


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


def traffic_log(corpus, n_queries: int, qps: float):
    """The serving tier's traffic: a mixed-arity (1-3) Zipf log with
    co-topic terms and Poisson arrivals at ``qps``, seed 17."""
    from repro_torch.data.query_log import synth_query_log

    return synth_query_log(corpus, n_queries=n_queries, co_topic=0.6, seed=17,
                           arity=(1, 2, 3), arity_weights=(0.2, 0.6, 0.2), arrival_qps=qps)


def sharded_service(svc, n_shards: int):
    """A service over ``svc``'s fit and device index, sharded over
    ``n_shards`` slots of its device (evicting after 3 strikes)."""
    from repro_torch.serve.search_service import SearchService

    tier = SearchService(svc.res, device=svc.device)
    tier.enable_sharded(devices=[svc.device] * n_shards, strikes_to_evict=3)
    return tier


def _replay_summary(rep) -> Dict[str, object]:
    s = rep.summary()
    keep = ("n_requests", "n_batches", "p50_ms", "p99_ms", "p999_ms", "qps_sustained",
            "qps_offered", "mean_batch", "occupancy", "jit_compiles", "n_shed", "frac_shed",
            "levels", "max_attempts")
    return {key: s[key] for key in keep}


def _fmt(s: Dict[str, object]) -> str:
    return (f"p50 {s['p50_ms']:.3f} ms, p99 {s['p99_ms']:.3f} ms, p999 {s['p999_ms']:.3f} ms, "
            f"{s['qps_sustained']:.1f} qps sustained, mean batch {s['mean_batch']:.2f}, "
            f"{s['n_batches']} batches, compiles {s['jit_compiles']}, levels {s['levels']}")


def serve_sharded(tier, logs, report: Dict[str, object], log_fn=print) -> Dict[str, object]:
    """Both logs through the sharded engine of ``tier`` (every batch
    checked against the host engine) and their first
    :data:`BLOCK_QUERIES` queries through the block path split over the
    shards' devices; adds the results to ``report``."""
    devices = list(tier.sharded_index.devices)
    for name, lg in logs.items():
        served = _serve_log(tier, lg.queries, name)
        report[f"sharded_{name}"] = served
        log_fn(f"sharded engine [{name}]: {tier.n_shards} shards, {served['n_batches']} batches "
               f"agree with host; median shards_touched {served['shards_touched_median']:.1f} "
               f"load_balance {served['load_balance_median']:.3f} agg_throughput "
               f"{served['agg_throughput_median']:.3f}, t_plan "
               f"{served['t_plan_s_median'] * 1e3:.2f} ms, t_lower "
               f"{served['t_lower_s_median'] * 1e3:.2f} ms, t_fold "
               f"{served['t_fold_s_median'] * 1e3:.2f} ms")
        blocks = _serve_blocks(tier, lg.queries[:BLOCK_QUERIES], name, devices=devices)
        report[f"sharded_blocks_{name}"] = blocks
        log_fn(f"block path [{name}] over {len(devices)} devices: {blocks['rows']} rows, "
               f"agrees with host")
    return report


def replay_sealed(tier, log, log_fn=print, engine=None) -> Dict[str, object]:
    """``log`` replayed sealed through the deadline batcher and the
    resilience ladder after ``prewarm``: raises unless the counts equal
    the host engine's, nothing compiled and every batch was served at the
    ``"device"`` rung.  ``engine`` overrides the service's device path
    (a counting wrapper)."""
    from repro_torch.core.device_engine import prewarm
    from repro_torch.serve.loop import ServeConfig, plan_batches
    from repro_torch.serve.replay import replay
    from repro_torch.serve.resilience import ResilienceConfig

    cfg = ServeConfig(max_batch=REPLAY_MAX_BATCH, deadline_s=REPLAY_DEADLINE_S)
    truth, _ = tier.serve_counts(log.as_conjunctive())
    batches = plan_batches(log.arrivals, cfg.max_batch, cfg.deadline_s)
    pw = prewarm(tier.query_index, log.queries, batches=batches)
    rep = replay(tier, log, config=cfg, mode="sealed", engine=engine,
                 resilience=ResilienceConfig())
    if rep.jit_compiles != 0 or pw["n_compiles"] != 0:
        raise AssertionError("the sealed replay compiled")
    if not np.array_equal(rep.counts, truth):
        raise AssertionError("the sealed replay disagrees with host")
    if set(rep.stats.batch_levels) != {"device"}:
        raise AssertionError(f"the sealed replay left the device rung: {rep.summary()['levels']}")
    out = {**_replay_summary(rep), "prewarm_keys": pw["n_keys"]}
    log_fn(f"sealed replay of {log.n_queries} queries: {_fmt(out)}, "
           f"{pw['n_keys']} shape keys warmed")
    return out


def replay_async(tier, log, log_fn=print) -> Dict[str, object]:
    """``log`` replayed on the wall clock through the async loop; raises
    unless every count equals the host engine's."""
    from repro_torch.serve.loop import ServeConfig
    from repro_torch.serve.replay import replay

    cfg = ServeConfig(max_batch=REPLAY_MAX_BATCH, deadline_s=REPLAY_DEADLINE_S)
    truth, _ = tier.serve_counts(log.as_conjunctive())
    rep = replay(tier, log, config=cfg, mode="async")
    if not np.array_equal(rep.counts, truth):
        raise AssertionError("the async replay disagrees with host")
    out = _replay_summary(rep)
    log_fn(f"async replay of {log.n_queries} queries: {_fmt(out)}")
    return out


def _real_depths(rep) -> np.ndarray:
    """Each batch's real queue depth in a sealed replay: requests arrived
    by its dispatch (or shed) time and not yet sealed, as
    :mod:`repro_torch.serve.replay` counts them before any injected
    backlog."""
    t_dispatch = np.asarray(rep.stats.t_dispatch)
    return np.array([max(0, int(np.searchsorted(rep.arrivals, t_dispatch[i], side="right")) - j)
                     for i, j in rep.batches], np.int64)


def replay_chaos(svc, log, n_shards: int, log_fn=print) -> Dict[str, object]:
    """The two chaos replays of ``log`` on fresh sharded services: shard
    :data:`LOST_SHARD` lost at batch :data:`LOST_AT`, and a queue flood
    (:data:`FLOOD`) against :data:`SHED_QUEUE_DEPTH`.  Raises unless every
    answered request equals the host engine, the lost shard's batch is
    the only one off the ``"device"`` rung and is served at ``"remesh"``,
    and a batch is shed exactly when the flood's window or its real
    backlog puts it past the shed depth."""
    from repro_torch.serve.faults import SHED, FaultSchedule
    from repro_torch.serve.loop import ServeConfig
    from repro_torch.serve.replay import replay
    from repro_torch.serve.resilience import ResilienceConfig

    cfg = ServeConfig(max_batch=REPLAY_MAX_BATCH, deadline_s=REPLAY_DEADLINE_S)
    lossy = sharded_service(svc, n_shards)
    truth, _ = lossy.serve_counts(log.as_conjunctive())
    rep = replay(lossy, log, config=cfg, mode="sealed",
                 faults=FaultSchedule.shard_loss(LOST_SHARD, at=LOST_AT),
                 resilience=ResilienceConfig(dispatch_timeout_s=1e9))
    levels = rep.stats.batch_levels
    degraded = [b for b, lv in enumerate(levels) if lv != "device"]
    if not np.array_equal(rep.counts, truth):
        raise AssertionError("the shard-loss replay disagrees with host")
    if n_shards > 1 and (degraded != [LOST_AT] or levels[LOST_AT] != "remesh"
                         or lossy.n_shards != n_shards - 1):
        raise AssertionError(f"shard loss: degraded batches "
                             f"{ {b: levels[b] for b in degraded} }, {lossy.n_shards} shards after")
    loss = {**_replay_summary(rep), "shards_after": lossy.n_shards,
            "degraded": {b: levels[b] for b in degraded}}
    log_fn(f"chaos shard_loss({LOST_SHARD}, at={LOST_AT}) over {log.n_queries} queries: "
           f"shards {n_shards} -> {lossy.n_shards}, recovery batches {len(degraded)} "
           f"({', '.join(f'{b}:{levels[b]}' for b in degraded)}), exact")

    flooded = sharded_service(svc, n_shards)
    rep = replay(flooded, log, config=cfg, mode="sealed", faults=FaultSchedule.flood(**FLOOD),
                 resilience=ResilienceConfig(dispatch_timeout_s=1e9,
                                             shed_queue_depth=SHED_QUEUE_DEPTH))
    shed = rep.counts == SHED
    if not np.array_equal(rep.counts[~shed], truth[~shed]):
        raise AssertionError("flood replay: an answered request disagrees with host")
    # The flood's phantom backlog alone passes the shed depth, so its
    # batches are shed; any other batch only when its real backlog does.
    in_flood = np.zeros(len(rep.batches), bool)
    in_flood[FLOOD["at"] : FLOOD["at"] + FLOOD["n_batches"]] = True
    backlog = _real_depths(rep) >= SHED_QUEUE_DEPTH
    shed_b = np.array([bool(shed[i]) for i, _j in rep.batches])
    if not np.array_equal(shed_b, in_flood | backlog) or set(rep.stats.batch_levels) - {"device"}:
        raise AssertionError(f"flood: shed batches {np.flatnonzero(shed_b).tolist()}, flood "
                             f"{np.flatnonzero(in_flood).tolist()}, backlog past the depth "
                             f"{np.flatnonzero(backlog).tolist()}, levels "
                             f"{rep.summary()['levels']}")
    flood = {**_replay_summary(rep), "shed_batches": int(shed_b.sum()),
             "shed_by_flood": int(in_flood.sum()),
             "shed_by_backlog": int((backlog & ~in_flood).sum())}
    log_fn(f"chaos flood(depth={FLOOD['depth']}, at={FLOOD['at']}, "
           f"n_batches={FLOOD['n_batches']}) at shed depth {SHED_QUEUE_DEPTH}: "
           f"{flood['shed_batches']} of {len(rep.batches)} batches shed ({flood['shed_by_flood']} "
           f"by the flood, {flood['shed_by_backlog']} by a real backlog past the depth), shed "
           f"fraction {flood['frac_shed']:.4f}, answered requests exact, every dispatched batch "
           f"at the device rung")
    return {"shard_loss": loss, "flood": flood}


def serve_tier(svc, logs, corpus, n_shards: int, qps: Sequence[float], n_queries: int,
               report: Dict[str, object], log_fn=print) -> Dict[str, object]:
    """The serving tier on ``n_shards`` slots of ``svc``'s device (see the
    module docstring); adds its results to ``report``."""
    tier = sharded_service(svc, n_shards)
    serve_sharded(tier, logs, report, log_fn)
    replays: Dict[str, object] = {}
    for rate in qps:
        log_fn(f"-- {rate:g} qps")
        replays[f"sealed_r{rate:g}"] = replay_sealed(tier, traffic_log(corpus, n_queries, rate),
                                                     log_fn)
    replays[f"async_r{qps[0]:g}"] = replay_async(tier, traffic_log(corpus, n_queries, qps[0]),
                                                 log_fn)
    log_fn(f"-- chaos, {qps[0]:g} qps")
    replays.update(replay_chaos(svc, traffic_log(corpus, CHAOS_QUERIES, qps[0]), n_shards,
                                log_fn))
    report["tier"] = {"n_shards": n_shards, "replays": replays}
    return report


def run(args: argparse.Namespace, log_fn=print) -> Dict[str, object]:
    """The launcher's whole path; returns its report (sizes and host
    timings).  Raises on any disagreement between device and host."""
    svc, logs, report, corpus = setup(args, log_fn)
    serve(svc, logs, report, log_fn)
    if args.shards:
        serve_tier(svc, logs, corpus, args.shards, args.qps, args.queries, report, log_fn)
    return report


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
