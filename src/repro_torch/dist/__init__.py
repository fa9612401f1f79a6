"""Distribution layer of the port.

* ``cluster_dist`` — row-sharded SeCluD K-means (one round per shard,
                     counts summed) and the ``kmeans_fn`` adapter that
                     drops it into ``multilevel_cluster`` /
                     ``topdown_cluster``.

Import the submodule directly (``from repro_torch.dist import
cluster_dist``).
"""

__all__ = ["cluster_dist"]
