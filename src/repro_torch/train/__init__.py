"""Training substrate on PyTorch: optimizer, schedules, checkpointing and
the fault-tolerant loop (the port of ``repro.train``).  The train step
itself is :func:`repro_torch.launch.steps.train_step`."""

from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update, cosine_schedule

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "CheckpointManager",
]
