"""Graph substrate: synthetic graphs, CSR adjacency, neighbor sampling —
the port's own copy of ``repro.data.graphs`` (pure numpy, the same calls
in the same order), so the same seeds give the same arrays bit for bit.

* ``synth_graph``      — power-law (preferential-attachment-ish) graph with
                         topic-correlated features/labels, CSR adjacency.
* ``NeighborSampler``  — the layered fanout sampler ``minibatch_lg``
                         trains on: k-hop uniform sampling from CSR,
                         merged into a fixed-shape padded subgraph.
* ``batch_molecules``  — block-diagonal batching of many small graphs.

All host-side numpy (samplers run on the host feeding the device step),
all deterministic in their seeds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["GraphData", "synth_graph", "NeighborSampler", "batch_molecules"]


@dataclasses.dataclass
class GraphData:
    """CSR graph with features/labels. Edges are directed src -> dst."""

    indptr: np.ndarray  # (N+1,)
    indices: np.ndarray  # (E,) neighbor ids (incoming sources per dst)
    feats: np.ndarray  # (N, F) float32
    labels: np.ndarray  # (N,) int32
    n_classes: int

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        return len(self.indices)

    def edge_list(self) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) arrays; indices holds sources grouped by dst."""
        dst = np.repeat(np.arange(self.n_nodes, dtype=np.int32), np.diff(self.indptr))
        return self.indices.astype(np.int32), dst


def synth_graph(
    n_nodes: int,
    avg_degree: int,
    d_feat: int,
    n_classes: int,
    seed: int = 0,
    power: float = 1.2,
) -> GraphData:
    """Power-law in-degree graph; features = class centroid + noise."""
    rng = np.random.default_rng(seed)
    n_edges = n_nodes * avg_degree
    # Power-law target popularity.
    pop = (np.arange(1, n_nodes + 1) ** -power)
    pop /= pop.sum()
    dst = rng.choice(n_nodes, size=n_edges, p=pop)
    src = rng.integers(0, n_nodes, size=n_edges)
    # Group by dst -> CSR.
    order = np.argsort(dst, kind="stable")
    dst_s, src_s = dst[order], src[order]
    counts = np.bincount(dst_s, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])

    labels = rng.integers(0, n_classes, size=n_nodes).astype(np.int32)
    centroids = rng.standard_normal((n_classes, d_feat)).astype(np.float32)
    feats = centroids[labels] + 0.5 * rng.standard_normal((n_nodes, d_feat)).astype(
        np.float32
    )
    return GraphData(
        indptr=indptr,
        indices=src_s.astype(np.int32),
        feats=feats,
        labels=labels,
        n_classes=n_classes,
    )


class NeighborSampler:
    """Layered uniform neighbor sampling (GraphSAGE-style).

    ``sample(seeds)`` returns a fixed-shape padded subgraph:
      * feats   (N_pad, F)
      * edges   (E_pad, 2) int32 local (src, dst), padded with (0, N_pad-1)
                self-edges into a dummy node
      * edge_mask (E_pad,)
      * seed_pos (B,) local indices of the seeds
      * labels  (B,)
    The union subgraph is run through ALL model layers (subgraph
    convolution) — fixed shapes, jit-friendly.
    """

    def __init__(self, graph: GraphData, fanouts: Tuple[int, ...], seed: int = 0):
        self.g = graph
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)

    def budget(self, batch: int) -> Tuple[int, int]:
        """(N_pad, E_pad) upper bounds for a seed batch."""
        n = batch
        e = 0
        frontier = batch
        for f in self.fanouts:
            e += frontier * f
            frontier *= f
            n += frontier
        return n + 1, e  # +1 dummy node

    def sample(self, seeds: np.ndarray) -> dict:
        g = self.g
        seeds = np.asarray(seeds, dtype=np.int64)
        n_pad, e_pad = self.budget(len(seeds))

        nodes = list(seeds)
        local = {int(v): i for i, v in enumerate(seeds)}
        edges = []
        frontier = seeds
        for f in self.fanouts:
            nxt = []
            for v in frontier:
                lo, hi = g.indptr[v], g.indptr[v + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = self.rng.integers(lo, hi, size=f)  # with replacement
                for e in take:
                    u = int(g.indices[e])
                    if u not in local:
                        local[u] = len(nodes)
                        nodes.append(u)
                    nxt.append(u)
                    edges.append((local[u], local[int(v)]))
            frontier = np.asarray(nxt, dtype=np.int64) if nxt else np.empty(0, np.int64)

        nodes_arr = np.asarray(nodes, dtype=np.int64)
        feats = np.zeros((n_pad, g.feats.shape[1]), np.float32)
        feats[: len(nodes_arr)] = g.feats[nodes_arr]
        e_arr = np.full((e_pad, 2), n_pad - 1, dtype=np.int32)
        mask = np.zeros((e_pad,), np.float32)
        if edges:
            e_np = np.asarray(edges, dtype=np.int32)[:e_pad]
            e_arr[: len(e_np)] = e_np
            mask[: len(e_np)] = 1.0
        return {
            "feats": feats,
            "edges": e_arr,
            "edge_mask": mask,
            "seed_pos": np.arange(len(seeds), dtype=np.int32),
            "labels": g.labels[seeds].astype(np.int32),
            "n_real_nodes": len(nodes_arr),
        }


def batch_molecules(
    n_graphs: int,
    nodes_per_graph: int,
    edges_per_graph: int,
    d_feat: int,
    n_classes: int,
    seed: int = 0,
) -> dict:
    """Block-diagonal batch of small random graphs with graph labels."""
    rng = np.random.default_rng(seed)
    n = n_graphs * nodes_per_graph
    feats = rng.standard_normal((n, d_feat)).astype(np.float32)
    src = []
    dst = []
    for gidx in range(n_graphs):
        base = gidx * nodes_per_graph
        s = rng.integers(0, nodes_per_graph, size=edges_per_graph) + base
        d = rng.integers(0, nodes_per_graph, size=edges_per_graph) + base
        src.append(s)
        dst.append(d)
    graph_id = np.repeat(np.arange(n_graphs, dtype=np.int32), nodes_per_graph)
    labels = rng.integers(0, n_classes, size=n_graphs).astype(np.int32)
    return {
        "feats": feats,
        "edges": np.stack(
            [np.concatenate(src), np.concatenate(dst)], axis=1
        ).astype(np.int32),
        "edge_mask": np.ones((n_graphs * edges_per_graph,), np.float32),
        "graph_id": graph_id,
        "labels": labels,
    }
