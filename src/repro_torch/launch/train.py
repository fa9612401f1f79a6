"""Training launcher on one device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b --steps 12 \\
        --ckpt-dir /path/ckpt --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b --config full \\
        --cell train_4k --batch 2 --microbatches 2 --steps 3 --ckpt-dir /path/ckpt

The port of ``repro.launch.train``: the fault-tolerant
:class:`~repro_torch.train.trainer.Trainer` (checkpoint/restart, the
counter-based pipeline) over the arch's ``loss_fn``.  ``--config smoke``
(the default, as the JAX launcher runs) takes the arch's small config and
the JAX launcher's batches: an LM 4 sequences of 32 tokens
(``TokenPipeline``), a recsys arch 32 rows (``RecsysPipeline``; DCN-v2's
history length 4, the others' their own), and its AdamW: lr 1e-3, the
cosine schedule over the run.  ``--config full`` takes the published
widths (AdamW at ``AdamWConfig``'s lr).  ``--cell NAME`` applies the
arch's train cell (``train_4k``: ``remat="full"``, sequences of 4,096
tokens, 256 a batch in 8 (gemma3-4b) or 4 microbatches; ``train_batch``:
65,536 rows) and its optimizer: ``AdamWConfig``'s defaults with bf16
moments for FSDP archs, as ``_lm_cell`` and ``_recsys_cell`` build it;
``--batch`` and ``--microbatches`` cut the cell's batch and its split,
``--layers`` an LM's depth.  The checkpoints go to ``--ckpt-dir`` + ``_``
+ the arch, every ``max(steps // 3, 5)`` steps; a rerun with the same
directory resumes from the latest.  On ``cuda`` (the default) attention
and its gradient run the hand-written kernels; ``--device cpu`` runs
their plain PyTorch versions.

``pna`` trains as the JAX launcher's gnn branch does (no checkpoints, a
loss printed every 5 steps): ``--config smoke`` on a 1,000-node graph at
degree 8 (16 features, 5 classes) with AdamW at lr 5e-3 over the run;
``--config full --cell NAME`` on the cell's data as ``_pna_cell`` shapes
it, with ``AdamWConfig()``: ``full_graph_sm`` and ``ogb_products`` a
``synth_graph`` of the cell's nodes at degree round(edges / nodes), every
node labelled (the edge count is the one departure from the cell, printed
beside it); ``minibatch_lg`` (a ``train_minibatch`` cell) a
``NeighborSampler`` batch of 1,024 seeds at fanouts (15, 10) a step over
a 232,965-node graph at degree 492; ``molecule`` ``batch_molecules(128,
30, 64, 32, 16)``.  ``--nodes`` cuts a cell's graph to fewer nodes (the
same degree), ``--batch`` the seeds or molecules a step.  On ``cuda`` the
aggregation runs the hand-written ``segment_aggregate`` kernels.

    PYTHONPATH=src python -m repro_torch.launch.train --arch pna --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch pna --config full \\
        --cell ogb_products --steps 4
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.data.pipeline import RecsysPipeline, TokenPipeline
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

# The JAX launcher's smoke batches.
SMOKE_SEQ_LEN = 32
SMOKE_LM_BATCH = 4
SMOKE_RECSYS_BATCH = 32
SMOKE_DCN_HIST = 4
SMOKE_LR = 1e-3
# The JAX launcher's gnn branch: synth_graph(1000, 8, 16, 5, seed=0), lr 5e-3.
SMOKE_GRAPH = (1000, 8, 16, 5)
SMOKE_GNN_LR = 5e-3
GRAPH_SEED = 0  # synth_graph's, batch_molecules' and the sampler's seed
WEIGHT_SEED = 0
GRAPH_LOG_EVERY = 5


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--config", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--cell", default=None,
                    help="the arch's train cell (train_4k, train_batch): its overrides, batch, "
                         "sequence length and microbatches")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut an LM's depth to this many layers (default: the config's)")
    ap.add_argument("--batch", type=int, default=None,
                    help="rows a step, or a pna cell's seeds or molecules (default: the cell's)")
    ap.add_argument("--nodes", type=int, default=None,
                    help="cut a pna cell's graph to this many nodes, at the cell's degree")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="sequential microbatches a step (default: the cell's, else 1)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--device", default="cuda")
    return ap


@dataclasses.dataclass
class TrainSetup:
    """What a training run of one arch needs: its config (cell overrides
    and cuts applied), the model's init, its pipeline, the optimizer's and
    the trainer's configs and the microbatch count."""

    spec: object
    cfg: object
    init_model_fn: object
    pipeline: object
    opt_cfg: AdamWConfig
    trainer_cfg: TrainerConfig
    microbatches: int
    loss_fn: object
    device: torch.device


def train_cell(spec, cell_name: Optional[str]):
    """The arch's train cell ``cell_name`` (None: none).  Raises for an
    unknown cell, a skipped one, or one that is not a train cell (``train``
    or ``train_minibatch``)."""
    if cell_name is None:
        return None
    if cell_name not in spec.cells:
        raise KeyError(f"{spec.name} has no cell {cell_name!r}; choose from {sorted(spec.cells)}")
    cell = spec.cells[cell_name]
    if cell.skip:
        raise ValueError(f"{spec.name} skips cell {cell_name!r}: {cell.skip}")
    if cell.kind not in ("train", "train_minibatch"):
        raise ValueError(f"cell {cell_name!r} is a {cell.kind} cell; the launcher trains")
    return cell


def train_setup(args: argparse.Namespace) -> TrainSetup:
    """The run ``args`` describe, built without touching the device's
    memory (the model is made by ``init_model_fn``).  Raises for an arch
    that is not ported, a cell that is not a train cell, a bad cut and, on
    ``cuda``, without a GPU."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.device_engine import resolve_device

    spec = get_arch(args.arch)
    if spec.family == "gnn":
        raise ValueError(f"{spec.name} trains through graph_setup")
    if args.nodes is not None:
        raise ValueError("--nodes cuts a pna cell's graph")
    cfg = spec.smoke_cfg if args.config == "smoke" else spec.cfg
    cell = train_cell(spec, args.cell)
    if cell is not None:
        cfg = dataclasses.replace(cfg, **cell.overrides)
    dev = resolve_device(args.device)
    batch = args.batch or (cell.batch if cell is not None else None)
    micro = args.microbatches or (int(cell.extra.get("microbatches", 1)) if cell else 1)
    if spec.family == "lm":
        from repro_torch.models import transformer as M

        if args.layers is not None:
            if not 1 <= args.layers <= cfg.n_layers:
                raise ValueError(f"--layers {args.layers} outside [1, {cfg.n_layers}]")
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        seq = cell.extra["seq_len"] if cell is not None else SMOKE_SEQ_LEN
        pipeline = TokenPipeline(cfg.vocab, seq_len=seq, batch_per_shard=batch or SMOKE_LM_BATCH)
        moment_dtype = "bfloat16" if spec.fsdp else "float32"
    else:
        from repro_torch.models.recsys import recsys_module

        if args.layers is not None:
            raise ValueError("--layers cuts an LM's depth; a recsys arch has no such cut")
        M = recsys_module(spec.name)
        rows = batch or SMOKE_RECSYS_BATCH
        if spec.name == "dcn-v2":
            pipeline = RecsysPipeline(n_dense=cfg.n_dense, n_fields=cfg.n_sparse,
                                      vocab_size=cfg.vocab_per_field, hist_len=SMOKE_DCN_HIST,
                                      batch_per_shard=rows)
        else:
            seq = getattr(cfg, "seq_len", None) or cfg.hist_len
            pipeline = RecsysPipeline(n_dense=4, n_fields=4, vocab_size=cfg.vocab, hist_len=seq,
                                      batch_per_shard=rows)
        moment_dtype = "float32"
    rows = pipeline.batch_per_shard
    if micro < 1 or rows % micro:
        raise ValueError(f"{micro} microbatches do not divide a batch of {rows}")
    steps = args.steps
    tcfg = TrainerConfig(total_steps=steps, ckpt_every=max(steps // 3, 5), log_every=5,
                         ckpt_dir=f"{args.ckpt_dir}_{spec.name}")
    if cell is not None:  # the cell's optimizer
        opt_cfg = AdamWConfig(moment_dtype=moment_dtype)
    else:  # the JAX launcher's: the schedule over the run
        opt_cfg = AdamWConfig(lr=SMOKE_LR if args.config == "smoke" else AdamWConfig.lr,
                              total_steps=steps, moment_dtype=moment_dtype)
    return TrainSetup(spec, cfg, lambda g: M.init(cfg, g, dev), pipeline, opt_cfg, tcfg, micro,
                      M.loss_fn, dev)


@dataclasses.dataclass
class GraphSetup:
    """A PNA run: its config (the cell's features, classes and readout
    applied), the optimizer's config, the steps, the model's init,
    ``host_batch(step)``, the step's batch as numpy (the sampler's batches
    must be drawn in step order), and ``batch(step)``, that batch on the
    device with its edges sorted (``models.pna.with_csr``; a full graph is
    built, uploaded and sorted once, at the first call), and what the data
    is against the cell's (``info``, filled as the data is built)."""

    cfg: object
    opt_cfg: AdamWConfig
    steps: int
    init_model_fn: Callable
    host_batch: Callable[[int], Dict[str, np.ndarray]]
    batch: Callable[[int], Dict[str, torch.Tensor]]
    device: torch.device
    info: dict


def _graph_batch(g) -> Dict[str, np.ndarray]:
    """A full graph's batch, every node labelled."""
    src, dst = g.edge_list()
    return {"feats": g.feats, "edges": np.stack([src, dst], 1),
            "edge_mask": np.ones(g.n_edges, np.float32), "labels": g.labels,
            "label_mask": np.ones(g.n_nodes, np.float32)}


def graph_setup(args: argparse.Namespace) -> GraphSetup:
    """The PNA run ``args`` describe; builds no data and touches no device
    memory until ``batch`` is first called.  Raises for a cell that is
    not a train cell, a cut PNA does not take and, on ``cuda``, without a
    GPU."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.device_engine import resolve_device
    from repro_torch.data.graphs import NeighborSampler, batch_molecules, synth_graph
    from repro_torch.launch.serve import to_device
    from repro_torch.models import pna

    spec = get_arch(args.arch)
    if args.layers is not None:
        raise ValueError("--layers cuts an LM's depth; PNA's 4 layers stay")
    if args.microbatches not in (None, 1):
        raise ValueError("a PNA step is one batch (_pna_cell): no microbatches")
    cell = train_cell(spec, args.cell)
    dev = resolve_device(args.device)
    base = spec.smoke_cfg if args.config == "smoke" else spec.cfg
    info: dict = {}
    if cell is None:
        if args.config != "smoke":
            raise ValueError("pna's full config trains a cell: pass --cell")
        n, degree, d_feat, n_classes = SMOKE_GRAPH
        cfg = dataclasses.replace(base, d_feat=d_feat, n_classes=n_classes)
        opt_cfg = AdamWConfig(lr=SMOKE_GNN_LR, total_steps=args.steps)

        def build(step):
            return _graph_batch(synth_graph(n, degree, d_feat, n_classes, seed=GRAPH_SEED))
        full = True
    else:
        ex = cell.extra
        cfg = dataclasses.replace(base, d_feat=ex.get("d_feat", base.d_feat),
                                  n_classes=ex.get("n_classes", base.n_classes),
                                  readout=ex.get("readout", "node"))
        opt_cfg = AdamWConfig()  # _pna_cell's
        full = cell.kind == "train"  # a whole graph or a fixed batch of molecules
        if cfg.readout == "graph":
            graphs = args.batch or cell.batch

            def build(step):
                return batch_molecules(graphs, ex["nodes_per_graph"], ex["edges_per_graph"],
                                       cfg.d_feat, cfg.n_classes, seed=GRAPH_SEED)
        else:
            n = args.nodes or ex["n_nodes"]
            degree = round(ex["n_edges"] / ex["n_nodes"])
            info.update(cell_nodes=ex["n_nodes"], cell_edges=ex["n_edges"], nodes=n,
                        degree=degree)
            graph = {}

            def host_graph():
                if "g" not in graph:
                    t0 = time.perf_counter()
                    graph["g"] = synth_graph(n, degree, cfg.d_feat, cfg.n_classes,
                                             seed=GRAPH_SEED)
                    info.update(edges=graph["g"].n_edges, graph_s=time.perf_counter() - t0)
                return graph["g"]

            if full:
                def build(step):
                    return _graph_batch(host_graph())
            else:
                seeds = args.batch or cell.batch
                sampler = {}

                def build(step):
                    g = host_graph()
                    if "s" not in sampler:
                        sampler["s"] = NeighborSampler(g, ex["fanouts"], seed=GRAPH_SEED)
                    chosen = np.random.default_rng([GRAPH_SEED, step]).choice(
                        g.n_nodes, size=seeds, replace=False)
                    sub = sampler["s"].sample(chosen)
                    sub.pop("n_real_nodes")
                    return sub
    cached = {}

    def batch(step: int) -> Dict[str, torch.Tensor]:
        if full and cached:
            return cached["b"]
        out = pna.with_csr(to_device(build(step), dev))
        if full:
            cached["b"] = out
        return out

    return GraphSetup(cfg, opt_cfg, args.steps, lambda gen: pna.init(cfg, gen, dev), build, batch,
                      dev, info)


def train_graph(setup: GraphSetup, model=None, log_fn=print) -> Dict[str, object]:
    """``setup.steps`` steps of ``launch.steps.train_step`` (one batch each)
    on ``model`` (default: ``init_model_fn`` from ``WEIGHT_SEED``), the
    loss logged every ``GRAPH_LOG_EVERY`` steps as the JAX launcher prints
    it.  Returns the history ``[(step, loss)]`` and the model."""
    from repro_torch.launch.steps import train_state, train_step
    from repro_torch.models import pna

    if model is None:
        model = setup.init_model_fn(torch.Generator(device=setup.device).manual_seed(WEIGHT_SEED))
    model.requires_grad_(True)
    state = train_state(model, setup.opt_cfg)
    history = []
    for i in range(setup.steps):
        loss = float(train_step(model, state, setup.batch(i), 1, pna.loss_fn))
        history.append((i + 1, loss))
        if (i + 1) % GRAPH_LOG_EVERY == 0:
            log_fn(f"step {i + 1:4d}  loss {loss:.4f}")
    return {"history": history, "model": model}


def make_trainer(setup: TrainSetup) -> Trainer:
    return Trainer(setup.loss_fn, setup.init_model_fn, setup.pipeline, setup.trainer_cfg,
                   opt_cfg=setup.opt_cfg, device=setup.device, microbatches=setup.microbatches)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = build_parser().parse_args(argv)
    from repro_torch.configs.registry import get_arch

    if get_arch(args.arch).family == "gnn":
        gsetup = graph_setup(args)
        first = gsetup.batch(0)
        e = first["edges"].shape[0]
        cut = (f"; the cell's {gsetup.info['cell_nodes']:,} nodes and "
               f"{gsetup.info['cell_edges']:,} edges" if "cell_edges" in gsetup.info else "")
        print(f"{gsetup.cfg.name} [{args.config}{', ' + args.cell if args.cell else ''}]: "
              f"{gsetup.cfg.n_params() / 1e6:.3f} M parameters, {first['feats'].shape[0]:,} "
              f"nodes and {e:,} edges a step{cut}, {args.steps} steps on {gsetup.device}")
        out = train_graph(gsetup)
        return {"history": out["history"], "ckpt_dir": None}
    setup = train_setup(args)
    trainer = make_trainer(setup)
    print(f"{setup.cfg.name} [{args.config}{', ' + args.cell if args.cell else ''}]: "
          f"{setup.cfg.n_params() / 1e6:.3f} M parameters, batch "
          f"{setup.pipeline.batch_per_shard} in {setup.microbatches} microbatch(es), "
          f"{args.steps} steps on {setup.device}")
    trainer.run()
    print(f"done; checkpoints in {setup.trainer_cfg.ckpt_dir}")
    return {"history": trainer.history, "ckpt_dir": setup.trainer_cfg.ckpt_dir}


if __name__ == "__main__":
    main()
