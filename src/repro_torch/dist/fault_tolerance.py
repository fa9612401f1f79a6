"""Fault tolerance for sharded serving: straggler detection and elastic
re-meshing over shard slots.

* :class:`StragglerMonitor` — per-host step-time tracking against the
  median of the other hosts; ``strikes_to_evict`` *consecutive* misses of
  the ``deadline_factor × median`` deadline flags the host for eviction
  (consecutive, so transient hiccups don't evict anyone).
* :class:`ElasticMesh` — rebuilds the mesh from the live shard slots and
  counts re-mesh epochs.

A torch device does not name a shard: on one GPU every shard of a serving
mesh is ``cuda:0``, and in CPU runs every shard is ``cpu``.  The pool
therefore holds :class:`ShardSlot` entries — a slot's ``id`` is its
position in the first pool, its ``device`` where its tensors live — and
:meth:`ElasticMesh.exclude_device` excludes one slot, never every slot that
shares its device.  The port shards rows over one axis, so the "mesh" is
the ordered tuple of surviving slots, one shard each.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "Verdict",
    "StragglerMonitor",
    "ShardSlot",
    "ElasticMesh",
    "NoDevicesError",
]


class NoDevicesError(RuntimeError):
    """Eviction left no slot to build a mesh from.

    Raised by :meth:`ElasticMesh.remesh` when every pooled slot is
    excluded — the typed signal the serving tier's resilience layer
    catches to drop to its host-fallback rung."""


@dataclasses.dataclass(frozen=True)
class Verdict:
    host: int
    slow: bool  # missed the deadline on this record
    strikes: int  # consecutive misses so far
    evict: bool  # strikes reached the eviction threshold


class StragglerMonitor:
    """Flags hosts whose step time persistently exceeds the deadline.

    ``record(step_times)`` takes one wall-clock step duration per host and
    returns a verdict per host.  The deadline is
    ``deadline_factor × median(other hosts' times)`` — with a single host
    there is no reference population and nothing is ever flagged.
    """

    def __init__(
        self,
        n_hosts: int,
        deadline_factor: float = 1.5,
        strikes_to_evict: int = 3,
    ):
        if n_hosts < 1:
            raise ValueError("n_hosts must be >= 1")
        self.n_hosts = n_hosts
        self.deadline_factor = float(deadline_factor)
        self.strikes_to_evict = int(strikes_to_evict)
        self._strikes = np.zeros(n_hosts, dtype=np.int64)
        self._evicted: set = set()
        self.n_records = 0

    def record(self, step_times: Sequence[float]) -> List[Verdict]:
        times = np.asarray(step_times, dtype=np.float64)
        if times.shape != (self.n_hosts,):
            raise ValueError(
                f"expected {self.n_hosts} step times, got shape {times.shape}"
            )
        self.n_records += 1
        verdicts = []
        for h in range(self.n_hosts):
            others = [
                times[i]
                for i in range(self.n_hosts)
                if i != h and i not in self._evicted
            ]
            slow = bool(
                others and times[h] > self.deadline_factor * float(np.median(others))
            )
            self._strikes[h] = self._strikes[h] + 1 if slow else 0
            if self._strikes[h] >= self.strikes_to_evict:
                self._evicted.add(h)
            verdicts.append(
                Verdict(
                    host=h,
                    slow=slow,
                    strikes=int(self._strikes[h]),
                    evict=h in self._evicted,
                )
            )
        return verdicts

    def evictees(self) -> List[int]:
        """Hosts flagged for eviction, ascending."""
        return sorted(self._evicted)


@dataclasses.dataclass(frozen=True)
class ShardSlot:
    """One place a shard can live: ``id`` is the slot's position in the
    first pool (what eviction excludes), ``device`` the torch device its
    tensors are on (several slots may share one)."""

    id: int
    device: torch.device


def _no_gpu() -> RuntimeError:
    return RuntimeError(
        "no CUDA device is available; pass devices=['cpu'] * n to shard on "
        "the CPU"
    )


def _device(d) -> torch.device:
    """``d`` as a torch device, a CUDA one with its index filled in;
    raises for a CUDA device without a GPU."""
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise _no_gpu()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_slots(devices: Sequence) -> List[ShardSlot]:
    """``devices`` as shard slots: slots stay as they are, anything else
    (a ``torch.device`` or its name) becomes the slot of its position."""
    return [
        d if isinstance(d, ShardSlot) else ShardSlot(id=i, device=_device(d))
        for i, d in enumerate(devices)
    ]


def visible_cuda_devices() -> List[torch.device]:
    """Every CUDA device of this process; raises without a GPU (the port
    never picks the CPU on its own)."""
    if not torch.cuda.is_available():
        raise _no_gpu()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class ElasticMesh:
    """Rebuilds the mesh from the currently-live shard slots.

    Every ``remesh()`` bumps ``epoch``, so a caller knows its per-mesh
    state (a sharded index) must be rebuilt.
    """

    def __init__(self):
        self.epoch = 0
        self.mesh: Optional[Tuple[ShardSlot, ...]] = None
        self._excluded: set = set()
        self._pool: Optional[List[ShardSlot]] = None

    def exclude_device(self, device_id: int) -> None:
        """Drop one shard slot (by its ``id``) from future meshes — the
        other slots on the same torch device stay."""
        self._excluded.add(int(device_id))

    def remesh(self, devices: Optional[Sequence] = None) -> Tuple[ShardSlot, ...]:
        """The mesh of every live, non-excluded slot, in pool order.
        ``devices`` (slots, torch devices or device names) becomes the
        pool; without it the last remesh's pool is reused, or every
        visible CUDA device on the first call, so eviction followed by a
        bare ``remesh()`` shrinks the previous world."""
        if devices is not None:
            pool = as_slots(list(devices))
        elif self._pool is not None:
            pool = list(self._pool)
        else:
            pool = as_slots(visible_cuda_devices())
        self._pool = list(pool)
        live = tuple(s for s in pool if s.id not in self._excluded)
        if not live:
            raise NoDevicesError(
                f"all {len(self._pool)} pooled devices are excluded — "
                "no mesh can be built; serve on the host path"
            )
        self.mesh = live
        self.epoch += 1
        return self.mesh
