"""Graceful degradation for the serving tier: the policy that keeps
responses exact while the device path fails underneath it.

The degradation ladder, rung by rung (each one strictly cheaper for the
cluster and strictly worse for the request than the one before):

1. **retry** — a failed dispatch is retried with bounded exponential
   backoff (``max_retries``; never an unbounded loop — seclint SEC006
   forbids those in this tier).
2. **evict / remesh** — a failure blamed on a shard feeds a targeted
   strike into ``SearchService.record_shard_times``; the straggler
   monitor's consecutive-strike rule evicts the device, the
   ``ElasticMesh`` rebuilds one shard smaller, the corpus re-partitions,
   and the retry lands on the surviving world.  Results stay
   bit-identical — the partition changes, the math does not.
3. **host fallback** — retry budget exhausted (or the breaker open):
   the sealed batch re-executes on the exact host engine
   (``SearchService.serve_counts``, the ``batched_query`` path), so even
   total device loss returns bit-identical counts.
4. **shed** — queue depth past the brownout threshold: the request is
   refused *immediately* with a typed :class:`ShedError` instead of
   joining a queue it would time out in.  Shedding is the only rung that
   does not answer; every answered request is exact.

The :class:`CircuitBreaker` keeps rung 3 cheap: after
``breaker_threshold`` consecutive device-path failures it opens and
batches go straight to host (no doomed device attempts), then after
``probe_after`` host-served batches it half-opens and admits exactly one
probe — success closes it, failure re-opens it.

Only the typed faults — :class:`~repro_torch.serve.faults.InjectedFault`
(``DeviceLostError`` among them) and ``NoDevicesError`` — go down the
ladder on a service whose device path is on CUDA.  Any other error there
is the kernels' own (a library that did not build, a failed launch, an
input the launcher refuses) and propagates: answering that batch on the
host would hide a broken kernel behind an exact count.  Off the card the
ladder takes every error, as the JAX package's does.

A *timeout* here is detection, not preemption: the engine call is one
batch of kernel launches and cannot be interrupted midway, so a dispatch that
completes past ``dispatch_timeout_s`` keeps its (exact) result but
counts as a breaker failure — persistent slowness routes traffic to the
host path just like persistent raising does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np

from repro_torch.dist.fault_tolerance import NoDevicesError
from repro_torch.serve.faults import FaultInjector, InjectedFault

__all__ = [
    "LEVELS",
    "ShedError",
    "ResilienceConfig",
    "CircuitBreaker",
    "DispatchOutcome",
    "ResilientDispatcher",
]

# Degradation levels a batch can be served at, in ladder order.
LEVELS = ("device", "retry", "remesh", "host", "shed")


class ShedError(RuntimeError):
    """Typed SHED reply: the tier refused the request to protect its SLO
    (queue depth past the brownout threshold)."""

    def __init__(self, queue_depth: int, threshold: int):
        super().__init__(
            f"request shed: queue depth {queue_depth} >= brownout "
            f"threshold {threshold}"
        )
        self.queue_depth = int(queue_depth)
        self.threshold = int(threshold)


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Policy knobs for :class:`ResilientDispatcher` and the serving
    loop's load shedding.

    ``dispatch_timeout_s`` — a completed dispatch slower than this is a
    breaker failure (the result is kept; it is exact).  ``max_retries``
    — extra attempts after the first; the bound the backoff loop runs
    to.  ``shed_queue_depth`` — queue depth at which new arrivals are
    refused with :class:`ShedError` (None = never shed).
    ``backoff_sleep`` — really sleep between retries (the live loop);
    sealed replay leaves it off and keeps time virtual.
    """

    dispatch_timeout_s: float = 1.0
    max_retries: int = 3
    backoff_base_s: float = 0.001
    backoff_factor: float = 2.0
    breaker_threshold: int = 2
    probe_after: int = 4
    shed_queue_depth: Optional[int] = None
    backoff_sleep: bool = False

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        if self.probe_after < 1:
            raise ValueError("probe_after must be >= 1")
        if self.shed_queue_depth is not None and self.shed_queue_depth < 0:
            raise ValueError("shed_queue_depth must be >= 0 (or None)")


class CircuitBreaker:
    """closed → open after ``threshold`` consecutive device-path
    failures; open admits nothing for ``probe_after`` host-served
    batches, then half-opens for exactly one probe.  ``trip(permanent=
    True)`` (no devices left at all) opens it for good."""

    def __init__(self, threshold: int = 2, probe_after: int = 4):
        self.threshold = int(threshold)
        self.probe_after = int(probe_after)
        self.state = "closed"
        self.consecutive_failures = 0
        self.host_batches = 0  # host-served batches since the breaker opened
        self.permanent = False

    def allow(self) -> bool:
        """May the next batch try the device path?"""
        if self.permanent:
            return False
        if self.state == "closed":
            return True
        if self.state == "open" and self.host_batches >= self.probe_after:
            self.state = "half_open"
        return self.state == "half_open"

    def record_success(self) -> None:
        self.state = "closed"
        self.consecutive_failures = 0
        self.host_batches = 0

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.state == "half_open" or (
            self.consecutive_failures >= self.threshold
        ):
            self.state = "open"
            self.host_batches = 0

    def note_host(self) -> None:
        """One batch served on the host path while the breaker is open."""
        self.host_batches += 1

    def trip(self, permanent: bool = False) -> None:
        self.state = "open"
        self.host_batches = 0
        self.permanent = self.permanent or permanent


@dataclasses.dataclass
class DispatchOutcome:
    """How one batch was served: the ladder rung (``level``), attempts
    spent, whether a remesh happened underneath it, whether the kept
    result came in past the timeout, and accrued virtual fault delay."""

    level: str = "device"
    attempts: int = 0
    remeshed: bool = False
    timed_out: bool = False
    delay_s: float = 0.0
    error: Optional[str] = None  # last device-path error, if any


class ResilientDispatcher:
    """Wraps one engine callable in the full degradation ladder.

    ``engine`` defaults to ``service.serve_counts_device`` (the routed
    device path), ``host_engine`` to ``service.serve_counts`` (the exact
    ``batched_query`` fallback).  ``injector`` is the shared
    :class:`~repro_torch.serve.faults.FaultInjector` whose virtual delays are
    drained into the outcome (the batch owner calls ``begin_batch``).
    """

    def __init__(
        self,
        service=None,
        config: Optional[ResilienceConfig] = None,
        engine=None,
        host_engine=None,
        injector: Optional[FaultInjector] = None,
        clock=time.perf_counter,
    ):
        if engine is None:
            if service is None:
                raise ValueError("need a SearchService or an explicit engine")
            engine = service.serve_counts_device
        if host_engine is None:
            if service is None:
                raise ValueError(
                    "need a SearchService or an explicit host_engine for "
                    "the fallback rung"
                )
            host_engine = service.serve_counts
        self.service = service
        self.cfg = config or ResilienceConfig()
        self.breaker = CircuitBreaker(
            self.cfg.breaker_threshold, self.cfg.probe_after
        )
        self._engine = engine
        self._host = host_engine
        self.injector = injector
        self._clock = clock

    # -- the ladder --------------------------------------------------------

    def dispatch(self, queries) -> Tuple[np.ndarray, dict, DispatchOutcome]:
        """Serve one sealed batch at the cheapest rung that answers.

        Returns ``(counts, info, outcome)``; counts are exact at every
        rung (shedding happens upstream, before dispatch)."""
        out = DispatchOutcome()
        if not self.breaker.allow():
            self.breaker.note_host()
            return self._fallback(queries, out, why="circuit open")
        epoch0 = self._epoch()
        backoff = self.cfg.backoff_base_s
        last_err: Optional[BaseException] = None
        for attempt in range(self.cfg.max_retries + 1):
            out.attempts = attempt + 1
            t0 = self._clock()
            try:
                raw = self._engine(queries)
            except NoDevicesError as err:
                # Nothing left to evict to: host forever.
                last_err = err
                self.breaker.trip(permanent=True)
                break
            except Exception as err:  # typed faults + real dispatch errors
                if not self._absorbs(err):
                    raise
                last_err = err
                shard = getattr(err, "shard", None)
                if shard is not None:
                    try:
                        out.remeshed = self._strike(int(shard)) or out.remeshed
                    except NoDevicesError as lost:
                        last_err = lost
                        self.breaker.trip(permanent=True)
                        break
                if attempt >= self.cfg.max_retries:
                    break
                if self.cfg.backoff_sleep and backoff > 0:
                    time.sleep(backoff)
                backoff *= self.cfg.backoff_factor
                continue
            elapsed = self._clock() - t0
            if self.injector is not None:
                d = self.injector.take_delay()
                out.delay_s += d
                elapsed += d
            counts = np.asarray(raw[0] if isinstance(raw, tuple) else raw)
            info = raw[1] if isinstance(raw, tuple) and len(raw) > 1 else {}
            if not isinstance(info, dict):  # (counts, docs, info) form
                info = raw[-1] if isinstance(raw[-1], dict) else {}
            out.remeshed = out.remeshed or self._epoch() > epoch0
            out.timed_out = elapsed > self.cfg.dispatch_timeout_s
            if out.timed_out:
                # Slow-but-exact: keep the result, strike the breaker.
                self.breaker.record_failure()
            else:
                self.breaker.record_success()
            out.level = (
                "remesh"
                if out.remeshed
                else ("retry" if out.attempts > 1 else "device")
            )
            return counts, info, out
        self.breaker.record_failure()
        why = f"{type(last_err).__name__}: {last_err}" if last_err else None
        return self._fallback(queries, out, why=why)

    # -- rungs -------------------------------------------------------------

    def _fallback(self, queries, out: DispatchOutcome, why=None):
        """Rung 3: the exact host engine.  Bit-identical counts, no
        device involved."""
        counts, info = self._host(queries)
        if self.injector is not None:
            out.delay_s += self.injector.take_delay()
        out.level = "host"
        out.error = why
        info = dict(info)
        info["fallback"] = why or "host"
        return np.asarray(counts), info, out

    def _strike(self, shard: int) -> bool:
        """Rung 2: one targeted strike into the eviction chain.  A
        failure blamed on ``shard`` reports it unambiguously past the
        straggler deadline; ``strikes_to_evict`` consecutive failures
        evict it and re-partition.  Returns True when a remesh ran."""
        svc = self.service
        n = getattr(svc, "n_shards", 0) if svc is not None else 0
        if not n or shard >= n:
            return False
        times = np.ones(n, np.float64)
        times[shard] = 1e6  # unambiguously past any deadline_factor
        _verdicts, remeshed = svc.record_shard_times(times)
        return bool(remeshed)

    def _absorbs(self, err: Exception) -> bool:
        """Whether the ladder takes ``err``: a typed fault always, any
        other error only when the device path is off the card."""
        if isinstance(err, (InjectedFault, NoDevicesError)):
            return True
        svc = self.service
        if svc is None:
            return True
        sidx = getattr(svc, "sharded_index", None)
        devices = [svc.device, *(sidx.devices if sidx is not None else ())]
        return not any(d.type == "cuda" for d in devices)

    def _epoch(self) -> int:
        elastic = getattr(self.service, "_elastic", None)
        return int(elastic.epoch) if elastic is not None else 0
