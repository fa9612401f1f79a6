"""Placement over a serving mesh of shard slots.

The JAX package's sharding rules are ``PartitionSpec`` trees over a jax
mesh; the port places tensors per slot instead (row s of a sharded array
lives on slot s's device as its own tensor; a KV cache shard is a view of
the cache or a tensor on its slot's device), so only what the serving
paths need has a counterpart here:

* the ambient mesh (:func:`set_mesh` / :func:`get_active_mesh`): a module
  global, the JAX package's fallback for jax versions without a native
  ambient mesh; the LM layers read it to pick their mesh paths;
* the axis helpers :func:`batch_axes`, :func:`data_spec`,
  :func:`axes_size`;
* :class:`CacheShard`, one slot's batch rows and positions of a KV
  cache (the mesh decode's layout is ``layers.decode_shards``);
* :func:`shard_rows` and :func:`device_count`.

A mesh is a :class:`repro_torch.dist.fault_tolerance.SlotMesh` (slots on
named axes) or, where only rows are sharded, a plain sequence of shard
slots or devices, one shard each.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

__all__ = [
    "set_mesh",
    "get_active_mesh",
    "batch_axes",
    "data_spec",
    "axes_size",
    "CacheShard",
    "shard_rows",
    "device_count",
]


_ACTIVE_MESH = None


def set_mesh(mesh):
    """Make ``mesh`` (a ``SlotMesh``) the ambient mesh the model's mesh
    paths see; ``None`` clears it.  Returns ``mesh``."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    return mesh


def get_active_mesh():
    """The ambient mesh, or None when no mesh has been set."""
    return _ACTIVE_MESH


def batch_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes: every mesh axis except ``model``."""
    return tuple(a for a in mesh.axis_names if a != "model")


def data_spec(mesh):
    """The data axes as one entry: None, an axis name, or a tuple of them."""
    dp = batch_axes(mesh)
    if not dp:
        return None
    return dp if len(dp) > 1 else dp[0]


def axes_size(mesh, entry) -> int:
    """Product of the sizes of the mesh axes named by ``entry`` (None, an
    axis name, or a tuple of them)."""
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(int(mesh.shape[a]) for a in names)


class CacheShard(NamedTuple):
    """Where one slot's part of a KV cache lies: batch rows
    ``[row0, row1)`` and positions ``[pos0, pos1)``."""

    slot: object
    row0: int
    row1: int
    pos0: int
    pos1: int


def shard_rows(n_rows: int, mesh) -> int:
    """Rows of padding needed to split ``n_rows`` evenly over the data
    axes of a ``SlotMesh``, or over the shards of a plain sequence."""
    if hasattr(mesh, "axis_names"):
        return (-n_rows) % max(axes_size(mesh, data_spec(mesh)), 1)
    return (-n_rows) % max(device_count(mesh), 1)


def device_count(mesh) -> int:
    """Slots of ``mesh`` (shards of a plain sequence)."""
    return len(mesh)
