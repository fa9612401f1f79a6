"""Training driver: checkpoint/restart, straggler deadline, deterministic
data — the fault-tolerant loop a cluster runs.  The port of
``repro.train.trainer`` on one device.

The same code drives (a) the CPU example (smoke config, ``device="cpu"``)
and (b) the card (full width): only the config and the device differ.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.device_engine import resolve_device
from repro_torch.data.pipeline import PipelineState
from repro_torch.dist.fault_tolerance import StragglerMonitor
from repro_torch.launch.steps import train_state, train_step
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    log_every: int = 10
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep_last: int = 3
    straggler_deadline_factor: float = 1.5
    seed: int = 0


class Trainer:
    """Generic loop over (loss_fn, pipeline).

    ``loss_fn(model, batch) -> 0-dim tensor``; ``init_model_fn(generator)
    -> nn.Module`` builds the model on ``device`` from a ``torch.Generator``
    there (the loop makes it trainable); the pipeline provides
    ``batch(PipelineState, shard) -> dict of np arrays``.  Each step runs
    :func:`repro_torch.launch.steps.train_step` (``microbatches``
    sequential microbatches, AdamW on float32 masters), under ``mesh``
    (a ``SlotMesh``) where given.  ``device`` defaults to ``cuda`` and
    raises without a GPU.
    """

    def __init__(
        self,
        loss_fn: Callable,
        init_model_fn: Callable[[torch.Generator], torch.nn.Module],
        pipeline,
        cfg: TrainerConfig,
        opt_cfg: Optional[AdamWConfig] = None,
        device=None,
        microbatches: int = 1,
        mesh=None,
    ):
        self.cfg = cfg
        self.opt_cfg = opt_cfg or AdamWConfig(total_steps=cfg.total_steps)
        self.pipeline = pipeline
        self.loss_fn = loss_fn
        self.init_model_fn = init_model_fn
        self.device = resolve_device(device)
        self.microbatches = microbatches
        self.mesh = mesh
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep_last=cfg.keep_last)
        self.monitor = StragglerMonitor(n_hosts=1,
                                        deadline_factor=cfg.straggler_deadline_factor)
        self.history: list = []
        # The live model and optimizer state of a run, for ``on_step``.
        self.model = self.opt = None

    # ------------------------------------------------------------------

    def init_or_restore(self):
        """(model, optimizer state, first step): fresh from ``cfg.seed``, or
        the latest checkpoint's params, moments, step and pipeline step."""
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        model = self.init_model_fn(gen).requires_grad_(True)
        opt = train_state(model, self.opt_cfg)
        start = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            _, restored = self.ckpt.restore(self.state_of(opt, 0), latest)
            opt.load(restored)
            start = int(restored["pipeline_step"])
        return model, opt, start

    @staticmethod
    def state_of(opt, pipeline_step: int) -> dict:
        """What a checkpoint holds: the float32 masters, the AdamW state
        and the pipeline's step."""
        return {"params": opt.params, "opt": opt.opt, "pipeline_step": np.int64(pipeline_step)}

    def run(self, on_step: Optional[Callable] = None):
        model, opt, start = self.init_or_restore()
        self.model, self.opt = model, opt
        pstate = PipelineState(step=start)

        for step in range(start, self.cfg.total_steps):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.pipeline.batch(pstate).items()}
            loss = float(train_step(model, opt, batch, self.microbatches, self.loss_fn,
                                    mesh=self.mesh))
            dt = time.perf_counter() - t0
            self.monitor.record([dt])
            self.history.append((step, loss, dt))
            pstate = pstate.advance()

            if (step + 1) % self.cfg.log_every == 0:
                print(f"step {step + 1:6d}  loss {loss:.4f}  {dt * 1e3:.0f} ms")
            if (step + 1) % self.cfg.ckpt_every == 0:
                self.ckpt.save(step + 1, self.state_of(opt, pstate.step))
            if on_step is not None:
                on_step(step, loss)
        return model, opt
