"""Deterministic, seeded fault injection for the serving tier.

A :class:`FaultSchedule` is a pure description of what goes wrong and
when — shard slowdowns, dispatch exceptions, device loss, queue floods —
keyed on *sealed-batch ordinals*, not wall clock, so a chaos replay with
the same seed and schedule reproduces the same failures, retries,
evictions and sheds bit for bit.  A :class:`FaultInjector` interprets
the schedule inside the real dispatch path: ``device_counts`` and
``sharded_device_counts`` accept it as ``fault_hook`` and call
:meth:`FaultInjector.on_dispatch` before the fold (where it may
raise or charge virtual latency) and
:meth:`FaultInjector.perturb_shard_times` on the per-shard timing
attribution afterwards — faults fire inside the engine call itself, no
test monkeypatching.

Batch/attempt bookkeeping: the *batch owner* (sealed replay or the async
loop) calls :meth:`FaultInjector.begin_batch` once per sealed batch;
every engine call inside that batch is one dispatch *attempt*
(``on_dispatch`` counts them), which is how an ``exception`` event with
``n_attempts=1`` fails the first try and lets the retry through.

Persistence: events with ``n_batches=None`` stay active *until the
serving mesh shrinks* — the injector watches the ``n_shards`` each
dispatch reports and consumes such events when a remesh drops it.  That
is the device-loss contract: shard ``k`` keeps failing until failover
evicts it, after which the survivors (a re-partitioned world where
"shard k" no longer names the lost device) serve cleanly.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "SHED",
    "KINDS",
    "InjectedFault",
    "DeviceLostError",
    "FaultEvent",
    "FaultSchedule",
    "FaultInjector",
]

# Count sentinel a shed request replies with (its typed error is
# ShedError in repro_torch.serve.resilience; this is the value that lands in
# ReplayReport.counts so arrival-order arrays stay rectangular).
SHED = -1

KINDS = ("slowdown", "exception", "device_loss", "queue_flood")


class InjectedFault(RuntimeError):
    """A scheduled dispatch failure, raised inside the engine call.

    ``shard`` carries the blamed shard (None = unattributed), which is
    what lets the resilience layer feed a targeted strike into
    ``record_shard_times`` and drive the eviction chain."""

    def __init__(
        self,
        message: str,
        shard: Optional[int] = None,
        batch: Optional[int] = None,
    ):
        super().__init__(message)
        self.shard = shard
        self.batch = batch


class DeviceLostError(InjectedFault):
    """The scheduled loss of a device: every dispatch touching the lost
    shard fails until failover re-partitions the corpus without it."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``at`` is the first sealed-batch ordinal the event is active on;
    ``n_batches`` how many consecutive batches it stays active
    (``None`` = until the mesh shrinks, the device-loss semantics).
    ``n_attempts`` bounds how many dispatch *attempts* per active batch
    an ``exception``/``device_loss`` event fails (``None`` = all — only
    eviction or the host fallback ends it).
    """

    kind: str
    at: int
    n_batches: Optional[int] = 1
    shard: Optional[int] = None
    factor: float = 10.0  # slowdown multiplier on the reported shard time
    delay_s: float = 0.0  # virtual service-time delay per faulted dispatch
    depth: int = 0  # queue_flood: phantom backlog while active
    n_attempts: Optional[int] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (one of {KINDS})")
        if self.at < 0:
            raise ValueError(f"batch ordinal must be >= 0, got {self.at}")
        if self.n_batches is not None and self.n_batches < 1:
            raise ValueError("n_batches must be >= 1 (or None for until-remesh)")
        if self.factor <= 0:
            raise ValueError("slowdown factor must be > 0")

    def active_at(self, batch: int) -> bool:
        if batch < self.at:
            return False
        if self.n_batches is None:
            return True
        return batch < self.at + self.n_batches


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """An immutable, seed-stamped list of :class:`FaultEvent`.

    The seed is part of the schedule's identity (chaos replays compare
    runs by it); :meth:`chaos` derives a reproducible random mix from it.
    """

    events: Tuple[FaultEvent, ...] = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    # -- canonical scenarios ----------------------------------------------

    @classmethod
    def shard_loss(cls, shard: int, at: int = 0, seed: int = 0) -> "FaultSchedule":
        """Shard ``shard``'s device dies at batch ``at`` and stays dead
        until failover re-partitions the corpus without it."""
        return cls(
            (FaultEvent("device_loss", at=at, n_batches=None, shard=shard),),
            seed=seed,
        )

    @classmethod
    def shard_slowdown(
        cls,
        shard: int,
        at: int = 0,
        factor: float = 10.0,
        n_batches: Optional[int] = None,
        delay_s: float = 0.0,
        seed: int = 0,
    ) -> "FaultSchedule":
        """Shard ``shard`` straggles by ``factor`` from batch ``at`` —
        dispatches still succeed, the reported shard time inflates, and
        the straggler monitor does the rest."""
        return cls(
            (
                FaultEvent(
                    "slowdown",
                    at=at,
                    n_batches=n_batches,
                    shard=shard,
                    factor=factor,
                    delay_s=delay_s,
                ),
            ),
            seed=seed,
        )

    @classmethod
    def flaky(
        cls,
        at: int = 0,
        n_batches: int = 1,
        n_attempts: Optional[int] = 1,
        seed: int = 0,
    ) -> "FaultSchedule":
        """A transient dispatch exception: the first ``n_attempts`` tries
        of each affected batch raise, the retry after them succeeds."""
        return cls(
            (
                FaultEvent(
                    "exception", at=at, n_batches=n_batches, n_attempts=n_attempts
                ),
            ),
            seed=seed,
        )

    @classmethod
    def flood(
        cls, at: int, depth: int, n_batches: int = 1, seed: int = 0
    ) -> "FaultSchedule":
        """``depth`` phantom requests sit in the queue while active —
        the brownout trigger for load-shedding tests."""
        return cls(
            (FaultEvent("queue_flood", at=at, n_batches=n_batches, depth=depth),),
            seed=seed,
        )

    @classmethod
    def chaos(
        cls,
        seed: int,
        n_batches: int,
        n_events: int = 4,
        n_shards: int = 1,
    ) -> "FaultSchedule":
        """A reproducible random mix of transient faults over a replay of
        ``n_batches`` sealed batches.  Deliberately excludes device loss
        (which is one-way); compose :meth:`shard_loss` explicitly."""
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        for _ in range(n_events):
            kind = ("slowdown", "exception", "queue_flood")[int(rng.integers(3))]
            at = int(rng.integers(max(n_batches, 1)))
            span = int(rng.integers(1, 4))
            if kind == "slowdown":
                events.append(
                    FaultEvent(
                        "slowdown",
                        at=at,
                        n_batches=span,
                        shard=int(rng.integers(max(n_shards, 1))),
                        factor=float(2.0 + 8.0 * rng.random()),
                    )
                )
            elif kind == "exception":
                events.append(
                    FaultEvent("exception", at=at, n_batches=span, n_attempts=1)
                )
            else:
                events.append(
                    FaultEvent(
                        "queue_flood",
                        at=at,
                        n_batches=span,
                        depth=int(rng.integers(4, 64)),
                    )
                )
        events.sort(key=lambda e: (e.at, e.kind))
        return cls(tuple(events), seed=seed)


class FaultInjector:
    """Stateful interpreter of a :class:`FaultSchedule` over one run.

    The engine calls :meth:`on_dispatch` / :meth:`perturb_shard_times`
    (threaded through as ``fault_hook``); the batch owner calls
    :meth:`begin_batch` per sealed batch and :meth:`extra_queue_depth`
    for the flood contribution to its shed decision; the resilience
    layer drains accrued virtual latency with :meth:`take_delay`.
    """

    def __init__(self, schedule: FaultSchedule):
        if not isinstance(schedule, FaultSchedule):
            schedule = FaultSchedule(tuple(schedule))
        self.schedule = schedule
        self.batch_idx = -1  # advanced by begin_batch (the batch owner)
        self.attempt = 0  # dispatch attempts within the current batch
        self._last_n_shards: Optional[int] = None
        self._consumed: set = set()  # event positions ended by a remesh
        self._delay_pending = 0.0
        self.fired: List[Tuple[int, int, str]] = []  # (batch, attempt, kind)

    # -- batch-owner side ---------------------------------------------------

    def begin_batch(self) -> int:
        """Advance to the next sealed batch; resets the attempt counter."""
        self.batch_idx += 1
        self.attempt = 0
        return self.batch_idx

    def extra_queue_depth(self) -> int:
        """Phantom backlog from the queue_flood events active now."""
        return sum(
            ev.depth for _, ev in self._active("queue_flood")
        )

    def take_delay(self) -> float:
        """Drain the virtual service-time delay accrued since last taken."""
        d = self._delay_pending
        self._delay_pending = 0.0
        return d

    # -- engine side (the fault_hook protocol) -----------------------------

    def on_dispatch(self, n_shards: int = 1) -> None:
        """Called inside the engine before the fold.  Raises the
        scheduled :class:`InjectedFault`/:class:`DeviceLostError` and
        accrues virtual slowdown latency.  Watches ``n_shards`` to
        consume until-remesh events once failover shrank the mesh."""
        if self.batch_idx < 0:
            self.batch_idx = 0  # direct engine use without a batch owner
        if self._last_n_shards is not None and n_shards < self._last_n_shards:
            self._note_remesh()
        self._last_n_shards = int(n_shards)
        attempt = self.attempt
        self.attempt += 1
        batch = self.batch_idx
        for _, ev in self._active("slowdown", batch):
            if ev.delay_s:
                self._delay_pending += ev.delay_s
                self.fired.append((batch, attempt, "slowdown"))
        for pos, ev in self._active("exception", batch) + self._active(
            "device_loss", batch
        ):
            if ev.n_attempts is not None and attempt >= ev.n_attempts:
                continue
            self.fired.append((batch, attempt, ev.kind))
            if ev.kind == "device_loss":
                raise DeviceLostError(
                    f"injected device loss (shard {ev.shard}) at batch {batch}",
                    shard=ev.shard,
                    batch=batch,
                )
            raise InjectedFault(
                f"injected dispatch fault at batch {batch} attempt {attempt}",
                shard=ev.shard,
                batch=batch,
            )

    def perturb_shard_times(self, times) -> np.ndarray:
        """Apply active slowdowns to the engine's per-shard timing
        attribution — the signal the straggler monitor acts on."""
        t = np.asarray(times, np.float64).copy()
        for _, ev in self._active("slowdown"):
            if ev.shard is None:
                t *= ev.factor
            elif 0 <= ev.shard < len(t):
                t[ev.shard] *= ev.factor
        return t

    # -- internals ---------------------------------------------------------

    def _active(
        self, kind: str, batch: Optional[int] = None
    ) -> List[Tuple[int, FaultEvent]]:
        b = self.batch_idx if batch is None else batch
        return [
            (pos, ev)
            for pos, ev in enumerate(self.schedule.events)
            if ev.kind == kind
            and pos not in self._consumed
            and ev.active_at(max(b, 0))
        ]

    def _note_remesh(self) -> None:
        """The mesh shrank: until-remesh events have done their damage —
        the shard they named no longer exists in the new partition."""
        for pos, ev in enumerate(self.schedule.events):
            if (
                pos not in self._consumed
                and ev.n_batches is None
                and ev.active_at(max(self.batch_idx, 0))
            ):
                self._consumed.add(pos)
