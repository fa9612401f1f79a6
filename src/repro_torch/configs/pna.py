"""pna [arXiv:2004.05718]: 4-layer PNA, d_hidden=75, aggregators
mean/max/min/std, scalers identity/amplification/attenuation.

The four graph shapes carry their own data geometry:
  * full_graph_sm — Cora-like:        2,708 nodes / 10,556 edges / 1,433 feats
  * minibatch_lg  — Reddit-like:    232,965 nodes / 114.6M edges, 1,024-seed
                    batches with fanout (15, 10) via the real neighbor sampler
  * ogb_products  — 2,449,029 nodes / 61.9M edges / 100 feats, full batch
  * molecule      — 30-node / 64-edge graphs, batch 128, graph readout
"""

import dataclasses

from repro_torch.configs.base import ArchSpec, Cell
from repro_torch.models.pna import PNAConfig

CFG = PNAConfig(
    name="pna", n_layers=4, d_hidden=75, d_feat=1433, n_classes=47,
    delta=2.5, readout="node",
)

SMOKE = dataclasses.replace(CFG, d_feat=32, d_hidden=16, n_classes=4)


def spec() -> ArchSpec:
    cells = {
        "full_graph_sm": Cell(
            kind="train", batch=1,
            extra={"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
                   "n_classes": 7},
        ),
        "minibatch_lg": Cell(
            kind="train_minibatch", batch=1024,
            extra={"n_nodes": 232965, "n_edges": 114_615_892, "d_feat": 602,
                   "fanouts": (15, 10), "n_classes": 41},
        ),
        "ogb_products": Cell(
            kind="train", batch=1,
            extra={"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100,
                   "n_classes": 47},
        ),
        "molecule": Cell(
            kind="train", batch=128,
            extra={"nodes_per_graph": 30, "edges_per_graph": 64, "d_feat": 32,
                   "n_classes": 16, "readout": "graph"},
        ),
    }
    return ArchSpec(name="pna", family="gnn", cfg=CFG, smoke_cfg=SMOKE, cells=cells)
