"""Open-loop traffic replay against the serving loop.

Drives the deadline batcher with a Zipf-skewed query stream under
Poisson arrivals (``synth_query_log(..., arrival_qps=...)``) in two
modes:

* ``"sealed"`` (default) — a discrete-event simulation over the *pure*
  batching policy: batch composition comes from
  :func:`repro_torch.serve.loop.plan_batches` (a deterministic function of the
  arrival timestamps), every batch is executed for real on the device
  engine, and latencies unroll on a virtual clock — a batch dispatches
  at ``max(seal_time, device_free)`` and occupies the device for its
  measured service time.  Composition (and therefore result counts and
  shape-key traffic) is bit-reproducible under a fixed seed; latencies
  are real measurements and carry the usual noise.

* ``"async"`` — drives the real :class:`~repro_torch.serve.loop.AsyncServingLoop`
  on wall clock: one asyncio task per request sleeps until its arrival
  offset and submits.  Live-serving realism (actual event-loop timing,
  actual deadline races), at the price of nondeterministic composition.

Both modes return a :class:`ReplayReport` whose per-request counts are
in arrival order and bit-identical to calling the engine directly on
the same queries — batching never changes results, only latency.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.data.query_log import QueryLog, poisson_arrivals
from repro_torch.serve.loop import (
    AsyncServingLoop,
    ServeConfig,
    ServeStats,
    plan_batches,
    seal_times,
)

__all__ = ["ReplayReport", "replay"]


@dataclasses.dataclass
class ReplayReport:
    """What a replay produced: exact per-request counts (arrival order),
    the arrival trace, the batch windows actually dispatched, the full
    :class:`ServeStats`, and the compile-probe growth over the whole
    measured pass (``jit_compiles``; the port's fold compiles nothing
    per shape, so it is 0)."""

    counts: np.ndarray
    arrivals: np.ndarray
    batches: List[Tuple[int, int]]
    stats: ServeStats
    jit_compiles: int
    mode: str

    def summary(self) -> dict:
        s = self.stats.summary()
        s["jit_compiles"] = self.jit_compiles
        s["mode"] = self.mode
        if len(self.arrivals) > 1:
            span = max(float(self.arrivals[-1] - self.arrivals[0]), 1e-12)
            s["qps_offered"] = (len(self.arrivals) - 1) / span
        else:
            s["qps_offered"] = 0.0
        return s


def replay(
    service,
    log: QueryLog,
    qps: Optional[float] = None,
    config: Optional[ServeConfig] = None,
    mode: str = "sealed",
    seed: int = 0,
    engine=None,
    cache_probe=None,
    faults=None,
    resilience=None,
) -> ReplayReport:
    """Replay a query log's traffic through the deadline batcher.

    ``log.arrivals`` supplies the open-loop timestamps; without them,
    ``qps`` must be given and a Poisson process is drawn under ``seed``.
    ``engine`` overrides ``service.serve_counts_device`` (tests inject
    counting shims); ``cache_probe`` overrides the fold's compiled-entry
    counter (:func:`repro_torch.core.device_engine.fold_cache_size`).

    ``faults`` (a :class:`repro_torch.serve.faults.FaultSchedule`) turns the
    run into a *chaos replay*: the schedule's failures fire inside the
    real dispatch path and the batches serve through the resilience
    ladder (``resilience`` — a ``ResilienceConfig`` — defaults apply
    when omitted).  Shed requests reply with the ``SHED`` sentinel in
    ``counts`` and outcome ``"shed"`` in the stats; every non-shed count
    stays bit-identical to the host engine.  Batch composition and
    fault firing are both pure functions of the arrivals and the
    schedule, so the same seed + schedule reproduces the same
    ``ServeStats`` outcome/attempt/level records exactly.
    """
    if log.arrivals is not None:
        arrivals = np.asarray(log.arrivals, np.float64)
    elif qps is not None:
        arrivals = poisson_arrivals(log.n_queries, qps, seed=seed)
    else:
        raise ValueError("log has no arrivals and no qps given")
    if len(arrivals) != log.n_queries:
        raise ValueError("one arrival timestamp per query required")
    cfg = config or ServeConfig()
    if engine is None:
        engine = service.serve_counts_device
    if cache_probe is None:
        from repro_torch.core.device_engine import fold_cache_size as cache_probe
    if mode == "sealed":
        return _replay_sealed(
            engine,
            log,
            arrivals,
            cfg,
            cache_probe,
            service=service,
            faults=faults,
            resilience=resilience,
        )
    if mode == "async":
        return asyncio.run(
            _replay_async(
                service,
                engine,
                log,
                arrivals,
                cfg,
                cache_probe,
                faults=faults,
                resilience=resilience,
            )
        )
    raise ValueError(f"unknown replay mode {mode!r} (sealed|async)")


def _replay_sealed(
    engine,
    log,
    arrivals,
    cfg,
    probe,
    service=None,
    faults=None,
    resilience=None,
) -> ReplayReport:
    injector = None
    dispatcher = None
    rcfg = None
    if faults is not None:
        from repro_torch.serve.faults import FaultInjector

        injector = (
            faults if isinstance(faults, FaultInjector) else FaultInjector(faults)
        )
    if resilience is not None or injector is not None:
        from repro_torch.serve.resilience import ResilienceConfig, ResilientDispatcher

        rcfg = resilience or ResilienceConfig()
        dispatcher = ResilientDispatcher(
            service, rcfg, engine=engine, injector=injector
        )
    if injector is not None and service is not None:
        service.install_faults(injector)
    try:
        return _sealed_loop(
            engine, log, arrivals, cfg, probe, injector, dispatcher, rcfg
        )
    finally:
        if injector is not None and service is not None:
            service.install_faults(None)


def _sealed_loop(
    engine, log, arrivals, cfg, probe, injector, dispatcher, rcfg
) -> ReplayReport:
    from repro_torch.serve.faults import SHED

    batches = plan_batches(arrivals, cfg.max_batch, cfg.deadline_s)
    seals = seal_times(arrivals, batches, cfg.max_batch, cfg.deadline_s)
    stats = ServeStats(cfg.max_batch)
    counts_all = np.zeros(log.n_queries, np.int64)
    cache_start = probe()
    device_free = 0.0
    shed_limit = rcfg.shed_queue_depth if rcfg is not None else None
    for (i, j), t_seal in zip(batches, seals, strict=True):
        # Single-server queue on the virtual clock: the batch cannot
        # dispatch before it seals nor before the device frees up.
        dispatch = max(float(t_seal), device_free)
        # Requests arrived but not yet sealed at dispatch time, plus any
        # phantom backlog an active queue-flood fault injects.
        depth = int(
            max(0, np.searchsorted(arrivals, dispatch, side="right") - j)
        )
        if injector is not None:
            injector.begin_batch()
            depth += injector.extra_queue_depth()
        if shed_limit is not None and depth >= shed_limit:
            # Brownout: refuse the whole sealed batch immediately with
            # the SHED sentinel — the device stays free to drain the
            # backlog instead of queueing work it cannot answer in SLO.
            counts_all[i:j] = SHED
            stats.add_shed(arrivals[i:j], dispatch, depth)
            continue
        before = probe()
        t0 = time.perf_counter()
        if dispatcher is not None:
            counts, _info, outcome = dispatcher.dispatch(log.queries[i:j])
            attempts, level = outcome.attempts, outcome.level
            extra_s = outcome.delay_s
        else:
            out = engine(log.queries[i:j])
            counts = np.asarray(out[0] if isinstance(out, tuple) else out)
            attempts, level, extra_s = 1, "device", 0.0
        service_s = time.perf_counter() - t0 + extra_s
        counts_all[i:j] = counts
        reply = dispatch + service_s
        device_free = reply
        stats.add_batch(
            arrivals[i:j],
            dispatch,
            reply,
            device_s=service_s,
            jit_compiles=probe() - before,
            queue_depth=depth,
            attempts=attempts,
            level=level,
        )
    return ReplayReport(
        counts=counts_all,
        arrivals=arrivals,
        batches=batches,
        stats=stats,
        jit_compiles=probe() - cache_start,
        mode="sealed",
    )


async def _replay_async(
    service, engine, log, arrivals, cfg, probe, faults=None, resilience=None
) -> ReplayReport:
    from repro_torch.serve.faults import SHED
    from repro_torch.serve.resilience import ShedError

    loop = AsyncServingLoop(
        service,
        cfg,
        engine=engine,
        cache_probe=probe,
        resilience=resilience,
        faults=faults,
    )
    cache_start = probe()
    await loop.start()
    t0 = arrivals[0] if len(arrivals) else 0.0
    cq = log.as_conjunctive()

    async def one(r: int) -> int:
        await asyncio.sleep(float(arrivals[r] - t0))
        try:
            return await loop.submit(cq.terms(r))
        except ShedError:
            return int(SHED)

    counts = await asyncio.gather(
        *(one(r) for r in range(log.n_queries))
    )
    await loop.stop()
    batches = []
    off = 0
    for size in loop.stats.batch_sizes:
        batches.append((off, off + size))
        off += size
    return ReplayReport(
        counts=np.asarray(counts, np.int64),
        arrivals=arrivals,
        batches=batches,
        stats=loop.stats,
        jit_compiles=probe() - cache_start,
        mode="async",
    )
