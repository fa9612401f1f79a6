"""AdamW + schedules on PyTorch, the port of ``repro.train.optimizer``.

Moments can be stored in bf16 (``moment_dtype``) — at 480B params the
optimizer state is the memory bottleneck and bf16 moments with fp32
update math is the standard trade (used by the arctic config).
Global-norm clipping included (production default).

Parameters, gradients and moments are dicts of tensors keyed by
parameter name (the JAX package's pytrees); the step count is an int32
0-dim tensor on the parameters' device.  The update is the reference's
arithmetic, in float32, leaf by leaf: the global norm, the clip scale and
the learning rate stay on the device (no ``.item()``).  Unlike the
reference's functional update it writes the parameters and the moments
in place, in chunks of ``UPDATE_CHUNK`` elements, so that a step needs no
second copy of the state (gemma3-4b's fp32 masters and moments alone take
46.5 GB) and its float32 temporaries stay small.  The reference computes
this outside any Pallas kernel; so does the port (torch's elementwise
ops).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule"]

# Elements of one leaf updated at a time (256 MB of float32 temporaries).
UPDATE_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # bf16 for very large models
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then a cosine down to ``min_lr_frac`` · lr; ``step``
    a float32 tensor."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def adamw_init(cfg: AdamWConfig, params: Dict[str, torch.Tensor]) -> dict:
    """Zero moments in ``moment_dtype`` beside each parameter, step 0."""
    dt = getattr(torch, cfg.moment_dtype)
    device = next(iter(params.values())).device
    return {
        "mu": {k: torch.zeros(p.shape, dtype=dt, device=p.device) for k, p in params.items()},
        "nu": {k: torch.zeros(p.shape, dtype=dt, device=p.device) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _chunks(t: torch.Tensor):
    flat = t.view(-1)
    for i in range(0, flat.numel(), UPDATE_CHUNK):
        yield flat[i:i + UPDATE_CHUNK]


@torch.no_grad()
def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ_leaves Σ g²) in float32, a 0-dim device tensor."""
    total = None
    for g in grads.values():
        for c in _chunks(g.contiguous()):
            part = torch.sum(torch.square(c.float()))
            total = part if total is None else total + part
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Dict[str, torch.Tensor], opt_state: dict,
                 params: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], dict]:
    """One AdamW step: ``params`` and ``opt_state``'s moments are written in
    place and returned, with the step advanced.  Gradients may be in any
    float dtype; the update math is float32 and each result is cast back
    to its leaf's dtype."""
    step = opt_state["step"] + 1
    stepf = step.float()
    lr = cosine_schedule(cfg, stepf)

    # Global-norm clip in fp32.
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    mdt = getattr(torch, cfg.moment_dtype)
    mu, nu = opt_state["mu"], opt_state["nu"]
    for name, p in params.items():
        g_all = grads[name].contiguous()
        for p_c, g_c, m_c, v_c in zip(_chunks(p), _chunks(g_all), _chunks(mu[name]),
                                      _chunks(nu[name]), strict=True):
            g = g_c.float() * scale
            m32 = b1 * m_c.float() + (1 - b1) * g
            v32 = b2 * v_c.float() + (1 - b2) * g * g
            mhat = m32 / bc1
            vhat = v32 / bc2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p_c.float()
            p_c.copy_((p_c.float() - lr * delta).to(p.dtype))
            m_c.copy_(m32.to(mdt))
            v_c.copy_(v32.to(mdt))
    opt_state["step"] = step
    return params, opt_state
