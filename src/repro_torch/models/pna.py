"""PNA — Principal Neighbourhood Aggregation (Corso et al., arXiv:2004.05718),
the port of ``repro.models.pna`` (training by :func:`loss_fn`).

Multi-aggregator message passing: each layer aggregates the messages
``relu(h W_src [src] + h W_dst [dst])`` of each node's incoming edges with
{mean, max, min, std} × degree scalers {identity, amplification,
attenuation} (12 combinations), concatenates, projects and adds an
``rms_norm`` residual.  The aggregation runs through
:func:`repro_torch.kernels.segment_aggregate.ops.segment_aggregate`: the
hand-written kernel pair on the card, split by edges over the edges
sorted by destination (:func:`with_csr` sorts a batch's edges once), the
plain version on the CPU.  The degree scalers, the graph readout's mean
pool and the cross-entropy stay PyTorch ops (small, per node); the
products are ``torch.matmul``.

How the port differs: the JAX package's layers are one stacked pytree
under ``jax.lax.scan``; here they are a ``ModuleList`` (``convert`` maps
the stack).  Under autograd each layer is recomputed in the backward
(``torch.utils.checkpoint``): at ogb_products one layer's activations
(the (N, 12·d) concatenation alone is 8.8 GB) would otherwise be kept
for all four.  The recompute gives the same values (the forward kernel's
sums are in a fixed order).

Supports the four shapes of ``configs/pna.py``: full-batch node
classification (``label_mask``), sampled subgraphs (``seed_pos``,
``data.graphs.NeighborSampler``) and batched small graphs with a graph
readout (``graph_id``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device_engine import resolve_device
from repro_torch.kernels.segment_aggregate.ops import EdgeCSR, edge_csr, segment_aggregate
from repro_torch.models.layers import Dense, frozen_param, rms_norm

__all__ = ["PNA", "PNAConfig", "csr_of", "init", "loss_fn", "matmul_flops", "with_csr"]

EPS = 1e-5
CSR_KEYS = ("csr_src", "csr_dst", "csr_w", "csr_indptr")


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str
    n_layers: int = 4
    d_feat: int = 64
    d_hidden: int = 75
    n_classes: int = 16
    delta: float = 2.5  # mean log-degree of the training graphs
    readout: str = "node"  # node | graph
    dtype: str = "float32"

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def n_params(self) -> int:
        d = self.d_hidden
        per_layer = 2 * d * d + 12 * d * d + d * d + 2 * d
        return self.d_feat * d + self.n_layers * per_layer + d * self.n_classes


def with_csr(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``batch`` with its edges sorted by destination (a stable sort on
    their device) under ``csr_src``, ``csr_dst``, ``csr_w`` and
    ``csr_indptr``: done once a batch (a full graph once a run)."""
    n = batch["feats"].shape[0]
    edges = batch["edges"]
    csr = edge_csr(edges[:, 0], edges[:, 1], batch["edge_mask"], n)
    return {**batch, **dict(zip(CSR_KEYS, csr))}


def csr_of(batch: Dict[str, torch.Tensor]) -> EdgeCSR:
    """The batch's sorted edges (:func:`with_csr`'s, else sorted now)."""
    if CSR_KEYS[0] not in batch:
        batch = with_csr(batch)
    return EdgeCSR(*(batch[k] for k in CSR_KEYS))


class PNALayer(nn.Module):
    def __init__(self, cfg: PNAConfig, device):
        super().__init__()
        d, dt = cfg.d_hidden, cfg.adtype
        self.delta = cfg.delta
        self.w_src = Dense(d, d, False, dt, device)
        self.w_dst = Dense(d, d, False, dt, device)
        self.w_out = Dense(12 * d, d, True, dt, device)
        self.norm = frozen_param((d,), torch.float32, device)

    def forward(self, h, src, dst, w, indptr):
        csr = EdgeCSR(src, dst, w, indptr)
        mean, mx, mn, std, deg = segment_aggregate(self.w_src(h), self.w_dst(h), csr)
        aggs = torch.cat([mean, mx, mn, std], dim=-1)  # (N, 4d)
        logd = torch.log(deg + 1.0)[:, None]
        amp = logd / self.delta
        att = self.delta / torch.clamp_min(logd, EPS)
        scaled = torch.cat([aggs, aggs * amp, aggs * att], dim=-1)  # (N, 12d)
        return rms_norm(h + self.w_out(scaled), self.norm)


class PNA(nn.Module):
    """Encoder (d_feat → d_hidden, relu), ``n_layers`` PNA layers, decoder
    (d_hidden → n_classes).  Zeros until :func:`init` or
    ``convert.pna_from_numpy`` fills it."""

    def __init__(self, cfg: PNAConfig, device):
        super().__init__()
        self.cfg = cfg
        dt = cfg.adtype
        self.encode = Dense(cfg.d_feat, cfg.d_hidden, True, dt, device)
        self.layers = nn.ModuleList(PNALayer(cfg, device) for _ in range(cfg.n_layers))
        self.decode = Dense(cfg.d_hidden, cfg.n_classes, True, dt, device)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Logits: (N, C) for the node readout, (G, C) for the graph
        readout (G = the number of labels)."""
        cfg = self.cfg
        h = torch.relu(self.encode(batch["feats"].to(cfg.adtype)))
        csr = tuple(csr_of(batch))
        remat = torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters())
        for layer in self.layers:
            h = checkpoint(layer, h, *csr, use_reentrant=False) if remat else layer(h, *csr)
        if cfg.readout == "graph":
            gid = batch["graph_id"].long()
            n_graphs = batch["labels"].shape[0]
            pooled = h.new_zeros((n_graphs, h.shape[1])).index_add(0, gid, h)
            cnt = h.new_zeros((n_graphs,)).index_add(0, gid, torch.ones_like(h[:, 0]))
            h = pooled / torch.clamp_min(cnt, 1.0)[:, None]
        return self.decode(h)


def init(cfg: PNAConfig, generator: torch.Generator, device=None) -> PNA:
    """Random weights as the JAX ``init`` draws them (from ``generator``,
    which lives on the device; not the same numbers): every dense kernel
    ~ N(0, 1) · d_in^-1/2, biases and norm scales 0.  ``device``
    defaults to ``cuda`` and raises without a GPU."""
    model = PNA(cfg, resolve_device(device))
    for module in model.modules():
        if isinstance(module, Dense):
            module.reset(generator)
    return model


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per row ``logsumexp − the gold logit``, in float32."""
    logits = logits.float()
    gold = torch.take_along_dim(logits, labels.long()[:, None], dim=-1)[:, 0]
    return torch.logsumexp(logits, dim=-1) - gold


def loss_fn(model: PNA, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Cross-entropy on the seeds (``seed_pos``: a sampled subgraph), the
    labelled nodes (``label_mask``: a full graph) or the graphs (the
    graph readout), as the JAX ``loss_fn``."""
    logits = model(batch)
    labels = batch["labels"]
    if model.cfg.readout != "graph":
        if "seed_pos" in batch:
            logits = logits[batch["seed_pos"].long()]
        if "label_mask" in batch:
            mask = batch["label_mask"].float()
            return (_cross_entropy(logits, labels) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return _cross_entropy(logits, labels).mean()


def matmul_flops(cfg: PNAConfig, n_nodes: int) -> int:
    """The forward's matrix-product FLOPs on a graph (2 per multiply-add):
    the encoder, each layer's three products and the decoder."""
    d = cfg.d_hidden
    per_layer = 2 * n_nodes * (2 * d * d + 12 * d * d)
    return 2 * n_nodes * (cfg.d_feat * d + d * cfg.n_classes) + cfg.n_layers * per_layer

