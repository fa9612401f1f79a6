"""Fault tolerance for sharded serving: straggler detection and elastic
re-meshing over shard slots.

* :class:`StragglerMonitor` — per-host step-time tracking against the
  median of the other hosts; ``strikes_to_evict`` *consecutive* misses of
  the ``deadline_factor × median`` deadline flags the host for eviction
  (consecutive, so transient hiccups don't evict anyone).
* :func:`plan_mesh_shape` — the largest ``(data, model)`` or
  ``(pod, data, model)`` shape that fits the live slots at a fixed model
  degree.
* :class:`ElasticMesh` — rebuilds the mesh from the live shard slots at
  that shape and counts re-mesh epochs.

A torch device does not name a shard: on one GPU every shard of a serving
mesh is ``cuda:0``, and in CPU runs every shard is ``cpu``.  The pool
therefore holds :class:`ShardSlot` entries — a slot's ``id`` is its
position in the first pool, its ``device`` where its tensors live — and
:meth:`ElasticMesh.exclude_device` excludes one slot, never every slot that
shares its device, and :meth:`ElasticMesh.exclude_host` every slot of one
process (a slot's ``process_index``, 0 in one process).  A mesh is a
:class:`SlotMesh`: the surviving slots in row-major order over named axes.
It is a tuple of those slots, so the search path, which shards rows over
every slot of ``ElasticMesh()``'s ``(n, 1)`` mesh, reads it as the tuple of
surviving slots, one shard each.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "Verdict",
    "StragglerMonitor",
    "ShardSlot",
    "SlotMesh",
    "plan_mesh_shape",
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
    tensors are on (several slots may share one), ``process_index`` the
    process that drives it (what :meth:`ElasticMesh.exclude_host`
    excludes; 0 in one process)."""

    id: int
    device: torch.device
    process_index: int = 0


class SlotMesh(tuple):
    """Shard slots on named axes: the tuple of the slots in row-major
    order, with ``axis_names`` (``("data", "model")`` or ``("pod",
    "data", "model")``: ``model``, where present, is the last axis, so a
    slot's model index is its position modulo the axis), ``shape`` (axis
    name -> size, as a jax mesh's) and ``devices`` (the slots as an array
    of that shape).  Two meshes are equal when their slots and their axes
    are."""

    def __new__(cls, slots: Sequence[ShardSlot], shape: Sequence[int],
                axis_names: Sequence[str]):
        self = super().__new__(cls, slots)
        self.dims = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        if len(self.dims) != len(self.axis_names) or math.prod(self.dims) != len(self):
            raise ValueError(f"{len(self)} slots do not fill a mesh of shape {self.dims} "
                             f"over axes {self.axis_names}")
        if "model" in self.axis_names[:-1]:
            raise ValueError(f"'model' must be the last axis, not of {self.axis_names}")
        return self

    def __eq__(self, other):
        if isinstance(other, SlotMesh) and (self.dims, self.axis_names) != (
                other.dims, other.axis_names):
            return False
        return tuple.__eq__(self, other)

    def __ne__(self, other):
        return not self == other

    __hash__ = tuple.__hash__

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}: {n}" for a, n in zip(self.axis_names, self.dims))
        return f"SlotMesh({axes}; slots {[s.id for s in self]})"

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def devices(self) -> np.ndarray:
        grid = np.empty(len(self), dtype=object)
        grid[:] = list(self)
        return grid.reshape(self.dims)


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


def plan_mesh_shape(
    n_devices: int,
    model_parallel: int,
    prefer_pods: Optional[int] = None,
) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest mesh shape fitting ``n_devices`` at a fixed model degree.

    The data axis absorbs device loss (``n // model_parallel`` rows); the
    model axis never shrinks — a model shard holds state no other host
    has.  With ``prefer_pods`` the result carries a leading pod axis when
    at least one full data row fits per pod.
    """
    if model_parallel < 1:
        raise ValueError("model_parallel must be >= 1")
    if n_devices < model_parallel:
        raise ValueError(
            f"{n_devices} devices cannot hold one model-parallel group of "
            f"{model_parallel}"
        )
    if prefer_pods and prefer_pods > 1:
        data = n_devices // (prefer_pods * model_parallel)
        if data >= 1:
            return (prefer_pods, data, model_parallel), ("pod", "data", "model")
    return (n_devices // model_parallel, model_parallel), ("data", "model")


class ElasticMesh:
    """Rebuilds the mesh from the currently-live shard slots, at the
    shape :func:`plan_mesh_shape` gives for ``model_parallel`` and
    ``prefer_pods``; the slots past that shape stay out of it.

    Every ``remesh()`` bumps ``epoch``, so a caller knows its per-mesh
    state (a sharded index, a model's placed experts) must be rebuilt.
    """

    def __init__(self, model_parallel: int = 1, prefer_pods: Optional[int] = None):
        self.model_parallel = int(model_parallel)
        self.prefer_pods = prefer_pods
        self.epoch = 0
        self.mesh: Optional[SlotMesh] = None
        self._excluded_hosts: set = set()
        self._excluded: set = set()
        self._pool: Optional[List[ShardSlot]] = None

    def exclude_host(self, process_index: int) -> None:
        """Drop every slot of one process (e.g. a StragglerMonitor
        evictee) from future meshes."""
        self._excluded_hosts.add(int(process_index))

    def exclude_device(self, device_id: int) -> None:
        """Drop one shard slot (by its ``id``) from future meshes — the
        other slots on the same torch device stay."""
        self._excluded.add(int(device_id))

    def remesh(self, devices: Optional[Sequence] = None) -> SlotMesh:
        """The largest mesh of live, non-excluded slots, in pool order.
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
        live = [s for s in pool
                if s.id not in self._excluded and s.process_index not in self._excluded_hosts]
        if not live:
            raise NoDevicesError(
                f"all {len(self._pool)} pooled devices are excluded — "
                "no mesh can be built; serve on the host path"
            )
        shape, axes = plan_mesh_shape(len(live), self.model_parallel, self.prefer_pods)
        self.mesh = SlotMesh(live[:math.prod(shape)], shape, axes)
        self.epoch += 1
        return self.mesh
