"""Async serving loop: deadline batching over the device engine.

A search tier absorbs an *open-loop* arrival process — requests land
when they land — and its contract is a latency SLO (p50/p99/p999), not
batch throughput.  This module turns the device engine
(:mod:`repro_torch.core.device_engine`) into that tier:

* :func:`plan_batches` — the batching *policy*, a pure function of the
  arrival timestamps: accumulate requests until the oldest one has
  waited ``deadline_s`` or ``max_batch`` are pending, whichever first.
  Keeping the policy pure is what makes traffic replay deterministic
  (same arrivals -> same batch composition, bit for bit).

* :class:`AsyncServingLoop` — the real-time batcher: an asyncio task
  applying the same policy to live ``submit()`` calls, dispatching each
  sealed batch as ONE engine call (``serve_counts_device``, through the
  sharded fold after ``enable_sharded``), resolving per-request futures
  with the counts, and accounting every request (enqueue -> dispatch ->
  reply) and every batch (size, queue depth, device time, compile-probe
  growth) in :class:`ServeStats`.

* ``AsyncServingLoop.prewarm`` — plan and lower the quantized shape grid
  at startup (:func:`repro_torch.core.device_engine.prewarm`).  The JAX
  engine compiles one executable per shape key there; the port's fold
  kernel takes every shape at run time, so the probe
  (:func:`repro_torch.core.device_engine.fold_cache_size`) stays 0 and
  warming launches each key once on dead cells.

The deadline/max-batch accumulation idiom follows the batch schedulers
in serving systems, specialized to the fact that the "model" is an exact
set-intersection engine whose cost is shape-quantized.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.queries import ConjunctiveQueries

__all__ = [
    "ServeConfig",
    "ServeStats",
    "AsyncServingLoop",
    "plan_batches",
    "seal_times",
]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The batching policy knobs.

    ``max_batch`` — dispatch immediately once this many requests are
    pending (the engine's shape quantization makes any size up to this
    share few executables).  ``deadline_s`` — the longest the *oldest*
    pending request may wait before its batch is sealed regardless of
    size: the knob that trades p99 latency against batch occupancy.
    """

    max_batch: int = 32
    deadline_s: float = 0.002

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {self.deadline_s}")


def plan_batches(
    arrivals: np.ndarray, max_batch: int, deadline_s: float
) -> List[Tuple[int, int]]:
    """The deadline batcher as a pure function of arrival timestamps.

    Returns half-open ``(start, end)`` windows partitioning
    ``range(len(arrivals))`` in order: a batch starting at request ``i``
    absorbs every request arriving within ``arrivals[i] + deadline_s``,
    up to ``max_batch``; the next batch starts at the first request it
    could not take.  ``arrivals`` must be nondecreasing (an arrival
    order).  This is exactly the composition the real-time loop
    converges to, but deterministic — replay and prewarm both build on
    it.
    """
    t = np.asarray(arrivals, np.float64)
    if t.ndim != 1:
        raise ValueError("arrivals must be a 1-d timestamp array")
    if len(t) > 1 and (np.diff(t) < 0).any():
        raise ValueError("arrivals must be nondecreasing")
    batches: List[Tuple[int, int]] = []
    i, n = 0, len(t)
    while i < n:
        seal = t[i] + deadline_s
        j = i + 1
        while j < n and j - i < max_batch and t[j] <= seal:
            j += 1
        batches.append((i, j))
        i = j
    return batches


def seal_times(
    arrivals: np.ndarray,
    batches: Sequence[Tuple[int, int]],
    max_batch: int,
    deadline_s: float,
) -> np.ndarray:
    """When each planned batch seals: at its filling arrival when it hit
    ``max_batch``, else at the first request's deadline.  (A deadline
    batch cannot dispatch earlier even if traffic stops — the loop does
    not know the trace ended.)"""
    t = np.asarray(arrivals, np.float64)
    out = np.empty(len(batches), np.float64)
    for b, (i, j) in enumerate(batches):
        out[b] = t[j - 1] if j - i == max_batch else t[i] + deadline_s
    return out


class ServeStats:
    """Per-request and per-batch serving telemetry.

    Requests carry (enqueue, dispatch, reply) timestamps — latency is
    reply minus enqueue, the number the SLO is written against — plus a
    per-request ``outcome`` ("ok" or "shed").  Batches carry size, queue
    depth at seal, device time, the jit-cache growth their dispatch
    caused (0 on every warm batch), and the resilience accounting:
    dispatch ``attempts`` spent and the degradation ``level`` the batch
    was served at (``repro_torch.serve.resilience.LEVELS`` ladder).
    """

    def __init__(self, max_batch: int):
        self.max_batch = int(max_batch)
        self.t_enqueue: List[float] = []
        self.t_dispatch: List[float] = []
        self.t_reply: List[float] = []
        self.outcomes: List[str] = []  # per request: "ok" | "shed"
        self.batch_sizes: List[int] = []
        self.batch_device_s: List[float] = []
        self.batch_compiles: List[int] = []
        self.queue_depths: List[int] = []
        self.batch_attempts: List[int] = []
        self.batch_levels: List[str] = []
        self.shed_batches: List[int] = []  # sizes of refused seals

    def add_batch(
        self,
        t_enqueue: Sequence[float],
        t_dispatch: float,
        t_reply: float,
        device_s: float,
        jit_compiles: int,
        queue_depth: int,
        attempts: int = 1,
        level: str = "device",
    ) -> None:
        self.t_enqueue.extend(float(t) for t in t_enqueue)
        self.t_dispatch.extend([float(t_dispatch)] * len(t_enqueue))
        self.t_reply.extend([float(t_reply)] * len(t_enqueue))
        self.outcomes.extend(["ok"] * len(t_enqueue))
        self.batch_sizes.append(len(t_enqueue))
        self.batch_device_s.append(float(device_s))
        self.batch_compiles.append(int(jit_compiles))
        self.queue_depths.append(int(queue_depth))
        self.batch_attempts.append(int(attempts))
        self.batch_levels.append(str(level))

    def add_shed(
        self, t_enqueue: Sequence[float], t_reply: float, queue_depth: int
    ) -> None:
        """Record requests refused with the typed SHED error: replied
        immediately (the whole point of shedding), never dispatched.
        Shed requests stay out of the per-batch dispatch accounting —
        those lists describe work the device actually did."""
        self.t_enqueue.extend(float(t) for t in t_enqueue)
        self.t_dispatch.extend([float(t_reply)] * len(t_enqueue))
        self.t_reply.extend([float(t_reply)] * len(t_enqueue))
        self.outcomes.extend(["shed"] * len(t_enqueue))
        self.shed_batches.append(len(t_enqueue))

    @property
    def n_shed(self) -> int:
        return sum(self.shed_batches)

    @property
    def n_requests(self) -> int:
        return len(self.t_enqueue)

    @property
    def n_batches(self) -> int:
        return len(self.batch_sizes)

    def latencies_s(self, outcome: Optional[str] = None) -> np.ndarray:
        lat = np.asarray(self.t_reply, np.float64) - np.asarray(
            self.t_enqueue, np.float64
        )
        if outcome is None:
            return lat
        mask = np.asarray([o == outcome for o in self.outcomes], bool)
        return lat[mask]

    def percentile_ms(self, p: float, outcome: Optional[str] = None) -> float:
        lat = self.latencies_s(outcome)
        if len(lat) == 0:
            return 0.0
        return float(np.percentile(lat, p) * 1e3)

    def batch_hist(self) -> Dict[int, int]:
        sizes, counts = np.unique(
            np.asarray(self.batch_sizes, np.int64), return_counts=True
        )
        return {int(s): int(c) for s, c in zip(sizes, counts, strict=True)}

    def summary(self) -> Dict[str, object]:
        if self.n_requests == 0:
            return {
                "n_requests": 0,
                "n_batches": 0,
                "duration_s": 0.0,
                "qps_sustained": 0.0,
                "p50_ms": 0.0,
                "p99_ms": 0.0,
                "p999_ms": 0.0,
                "mean_batch": 0.0,
                "occupancy": 0.0,
                "max_queue_depth": 0,
                "jit_compiles": 0,
                "batch_hist": {},
                "n_shed": 0,
                "frac_shed": 0.0,
                "levels": {},
                "max_attempts": 0,
            }
        duration = max(max(self.t_reply) - min(self.t_enqueue), 1e-12)
        # Latency percentiles describe answered requests; a shed reply is
        # a refusal, not a fast answer, and must not deflate the p50.
        pct = "ok" if self.n_shed else None
        levels: Dict[str, int] = {}
        for lv in self.batch_levels:
            levels[lv] = levels.get(lv, 0) + 1
        if self.shed_batches:
            levels["shed"] = len(self.shed_batches)
        mean_batch = (
            float(np.mean(self.batch_sizes)) if self.batch_sizes else 0.0
        )
        return {
            "n_requests": self.n_requests,
            "n_batches": self.n_batches,
            "duration_s": duration,
            "qps_sustained": self.n_requests / duration,
            "p50_ms": self.percentile_ms(50, pct),
            "p99_ms": self.percentile_ms(99, pct),
            "p999_ms": self.percentile_ms(99.9, pct),
            "mean_batch": mean_batch,
            "occupancy": mean_batch / self.max_batch,
            "max_queue_depth": (
                int(max(self.queue_depths)) if self.queue_depths else 0
            ),
            "jit_compiles": int(sum(self.batch_compiles)),
            "batch_hist": self.batch_hist(),
            "n_shed": self.n_shed,
            "frac_shed": self.n_shed / self.n_requests,
            "levels": levels,
            "max_attempts": max(self.batch_attempts, default=0),
        }


class AsyncServingLoop:
    """The real-time deadline batcher over a :class:`SearchService`.

    One asyncio task accumulates ``submit()`` arrivals under the
    :class:`ServeConfig` policy and dispatches each sealed batch as one
    engine call; every request's future resolves to its exact result
    count.  The engine call runs inline on the event loop — the
    device is the serial resource, and queuing behind it IS the serving
    model (matching the sealed replay's single-server semantics).

    ``engine`` defaults to ``service.serve_counts_device`` — the routed
    entry that serves through the sharded fold after ``enable_sharded``.
    ``cache_probe`` defaults to the fold's compiled-entry count
    (:func:`repro_torch.core.device_engine.fold_cache_size`, always 0)
    and feeds the per-batch compile accounting.

    ``resilience`` (a :class:`repro_torch.serve.resilience.ResilienceConfig`)
    arms the degradation ladder: each sealed batch dispatches through a
    ``ResilientDispatcher`` (timeout + bounded retry + breaker + exact
    host fallback) and ``submit`` sheds with a typed ``ShedError`` once
    queue depth passes ``shed_queue_depth``.  ``faults`` (a
    :class:`repro_torch.serve.faults.FaultSchedule` or ``FaultInjector``)
    installs the chaos harness into the service's dispatch path.
    """

    def __init__(
        self,
        service=None,
        config: Optional[ServeConfig] = None,
        engine=None,
        cache_probe=None,
        resilience=None,
        faults=None,
    ):
        if engine is None:
            if service is None:
                raise ValueError("need a SearchService or an explicit engine")
            engine = service.serve_counts_device
        if cache_probe is None:
            from repro_torch.core.device_engine import fold_cache_size as cache_probe
        self.service = service
        self.config = config or ServeConfig()
        self.stats = ServeStats(self.config.max_batch)
        self._engine = engine
        self._probe = cache_probe
        self._pending: collections.deque = collections.deque()
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._closing = False
        self.resilience = resilience
        self._injector = None
        self._dispatcher = None
        if faults is not None:
            from repro_torch.serve.faults import FaultInjector

            self._injector = (
                faults
                if isinstance(faults, FaultInjector)
                else FaultInjector(faults)
            )
            if service is not None:
                service.install_faults(self._injector)
        if resilience is not None or self._injector is not None:
            from repro_torch.serve.resilience import (
                ResilienceConfig,
                ResilientDispatcher,
            )

            self.resilience = resilience or ResilienceConfig()
            self._dispatcher = ResilientDispatcher(
                service,
                self.resilience,
                engine=engine,
                injector=self._injector,
            )

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        if self._task is not None:
            raise RuntimeError("serving loop already running")
        self._closing = False
        self._wake = asyncio.Event()
        self._task = asyncio.create_task(self._run())

    async def stop(self) -> None:
        """Seal and dispatch everything still pending, then stop."""
        if self._task is None:
            return
        self._closing = True
        self._wake.set()
        await self._task
        self._task = None

    # -- request entry -----------------------------------------------------

    async def submit(self, terms: Sequence[int]) -> int:
        """Enqueue one conjunctive query; resolves to its result count.

        With a resilience policy armed, arrivals past the brownout
        queue depth are refused immediately with a typed
        ``ShedError`` — the explicit load-shedding rung."""
        if self._task is None:
            raise RuntimeError("serving loop not started")
        limit = getattr(self.resilience, "shed_queue_depth", None)
        if limit is not None:
            depth = len(self._pending)
            if self._injector is not None:
                depth += self._injector.extra_queue_depth()
            if depth >= limit:
                from repro_torch.serve.resilience import ShedError

                t = time.perf_counter()
                self.stats.add_shed([t], t, depth)
                raise ShedError(depth, limit)
        fut = asyncio.get_running_loop().create_future()
        self._pending.append(
            ([int(t) for t in terms], fut, time.perf_counter())
        )
        self._wake.set()
        return await fut

    @property
    def queue_depth(self) -> int:
        return len(self._pending)

    # -- startup: compile the shape grid before traffic --------------------

    def prewarm(
        self,
        queries,
        batch_sizes: Optional[Sequence[int]] = None,
        batches: Optional[Sequence[Tuple[int, int]]] = None,
    ) -> Dict[str, object]:
        """Warm the engine's quantized shape grid from a sample workload
        (plan and lower each window; the port compiles nothing per key).

        Defaults to warming power-of-two prefix sizes up to
        ``max_batch``; pass ``batches`` (e.g. from :func:`plan_batches`
        over a recorded arrival trace) to warm the exact windows a
        replay will dispatch.  The sharded path has no dead-content
        warmer, so there the sample batches are executed for real.
        """
        if self.service is None:
            raise RuntimeError("prewarm needs a SearchService-backed loop")
        from repro_torch.core.queries import as_queries

        if batches is None and batch_sizes is None:
            b = self.config.max_batch
            batch_sizes = sorted(
                {s for s in (1 << i for i in range(b.bit_length())) if s <= b}
                | {b}
            )
        if getattr(self.service, "sharded_index", None) is not None:
            cq = as_queries(queries)
            if batches is None:
                batches = [(0, min(int(s), cq.n_queries)) for s in batch_sizes]
            n = 0
            for i, j in batches:
                if j > i:
                    self._engine(cq[int(i) : int(j)])
                    n += 1
            return {"n_batches": n, "n_keys": n, "n_compiles": 0, "keys": []}
        from repro_torch.core.device_engine import prewarm as engine_prewarm

        return engine_prewarm(
            self.service.query_index,
            queries,
            batch_sizes=batch_sizes,
            batches=batches,
        )

    # -- the loop ----------------------------------------------------------

    async def _run(self) -> None:
        cfg = self.config
        while True:
            if not self._pending:
                if self._closing:
                    return
                await self._wake.wait()
                self._wake.clear()
                continue
            first_t = self._pending[0][2]
            while len(self._pending) < cfg.max_batch and not self._closing:
                remaining = first_t + cfg.deadline_s - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=remaining)
                except asyncio.TimeoutError:
                    break
                self._wake.clear()
            batch = [
                self._pending.popleft()
                for _ in range(min(cfg.max_batch, len(self._pending)))
            ]
            self._dispatch(batch)

    def _dispatch(self, batch) -> None:
        terms, futs, t_enq = zip(*batch, strict=True)
        cq = ConjunctiveQueries.from_lists(list(terms))
        depth = len(self._pending)  # what the dispatch leaves queued
        before = self._probe()
        t_d = time.perf_counter()
        if self._dispatcher is not None:
            if self._injector is not None:
                self._injector.begin_batch()
            counts, _info, outcome = self._dispatcher.dispatch(cq)
            attempts, level = outcome.attempts, outcome.level
        else:
            out = self._engine(cq)
            counts = np.asarray(out[0] if isinstance(out, tuple) else out)
            attempts, level = 1, "device"
        t_r = time.perf_counter()
        self.stats.add_batch(
            t_enq,
            t_d,
            t_r,
            device_s=t_r - t_d,
            jit_compiles=self._probe() - before,
            queue_depth=depth,
            attempts=attempts,
            level=level,
        )
        for fut, c in zip(futs, counts, strict=True):
            if not fut.done():
                fut.set_result(int(c))
