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
their plain PyTorch versions.  ``pna`` is not ported and raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Dict, Optional, Sequence

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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--config", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--cell", default=None,
                    help="the arch's train cell (train_4k, train_batch): its overrides, batch, "
                         "sequence length and microbatches")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut an LM's depth to this many layers (default: the config's)")
    ap.add_argument("--batch", type=int, default=None, help="rows a step (default: the cell's)")
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
    unknown cell, a skipped one, or one that is not a train cell."""
    if cell_name is None:
        return None
    if cell_name not in spec.cells:
        raise KeyError(f"{spec.name} has no cell {cell_name!r}; choose from {sorted(spec.cells)}")
    cell = spec.cells[cell_name]
    if cell.skip:
        raise ValueError(f"{spec.name} skips cell {cell_name!r}: {cell.skip}")
    if cell.kind != "train":
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


def make_trainer(setup: TrainSetup) -> Trainer:
    return Trainer(setup.loss_fn, setup.init_model_fn, setup.pipeline, setup.trainer_cfg,
                   opt_cfg=setup.opt_cfg, device=setup.device, microbatches=setup.microbatches)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = build_parser().parse_args(argv)
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
