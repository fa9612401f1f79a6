"""Row sharding over a serving mesh of shard slots.

The JAX package's sharding rules are ``PartitionSpec`` trees over a jax
mesh; the port places tensors per shard instead (row s of a sharded
array lives on slot s's device as its own tensor), so only the two
helpers the serving path needs have a counterpart here.  A mesh is a
sequence of shard slots or devices, one shard each.
"""

from __future__ import annotations

__all__ = ["shard_rows", "device_count"]


def shard_rows(n_rows: int, mesh) -> int:
    """Rows of padding needed to split ``n_rows`` evenly over the shards."""
    return (-n_rows) % max(device_count(mesh), 1)


def device_count(mesh) -> int:
    """Shards of ``mesh``."""
    return len(mesh)
