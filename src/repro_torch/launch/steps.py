"""Train steps of the port: the ``train`` cells of ``repro.launch.steps``
(``_lm_cell``'s gradient accumulation over sequential microbatches;
``_recsys_cell``'s step is one microbatch) on one device.

The JAX package's step works on a pytree of float32 parameters that the
model casts to its activation dtype on every call.  The port's models
store each weight in the dtype they compute in (``models/layers.py``), so
a :class:`TrainState` keeps the float32 masters beside them: a float32
weight is its own master; a bf16 weight (the LM's dense kernels and
embedding at ``dtype="bfloat16"``) gets a float32 copy, and after each
update the model holds the master rounded to nearest bf16.  The gradient
autograd gives a bf16 weight is the bf16 cotangent the reference's cast
passes to its float32 parameter.  Over several microbatches the
reference sums those cotangents in float32 (``_lm_cell``'s accumulator
takes its float32 parameter's dtype), so :func:`train_step` adds each
bf16 gradient into a float32 sum as soon as autograd has accumulated it
and frees it (a post-accumulate-grad hook): 4 bytes a bf16 parameter
while the step runs, and no bf16 gradient kept between microbatches.

The dry-run's ShapeDtypeStruct/sharding plans (``CellPlan``), the serve
cells and ``_pna_cell`` are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["TrainState", "loss_fn_of", "microbatch", "train_state", "train_step"]


@dataclasses.dataclass
class TrainState:
    """The optimizer side of training: the AdamW config, the float32
    masters by parameter name (``params``), the AdamW state over them
    (``opt``: ``mu``, ``nu``, ``step``) and the model's own trainable
    parameters (``model_params``, the same tensors as the masters where
    those are float32)."""

    cfg: AdamWConfig
    params: Dict[str, torch.Tensor]
    opt: dict
    model_params: Dict[str, torch.Tensor]

    @torch.no_grad()
    def sync_model(self) -> None:
        """Round each float32 master into its bf16 model weight."""
        for name, p in self.model_params.items():
            master = self.params[name]
            if master is not p:
                p.copy_(master)

    @torch.no_grad()
    def load(self, state: dict) -> None:
        """Copy a checkpoint's ``params`` and ``opt`` (``Trainer.state_of``'s
        layout, tensors) in place and sync the model."""
        for name, t in self.params.items():
            t.copy_(state["params"][name])
        for key in ("mu", "nu"):
            for name, t in self.opt[key].items():
                t.copy_(state["opt"][key][name])
        self.opt["step"] = state["opt"]["step"].to(self.opt["step"].device)
        self.sync_model()


def train_state(model: torch.nn.Module, opt_cfg: AdamWConfig) -> TrainState:
    """The :class:`TrainState` of a trainable model: masters copied from its
    weights (float32 weights are their own), zero moments and step 0."""
    model_params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    if not model_params:
        raise ValueError("the model has no trainable parameter: call requires_grad_(True)")
    with torch.no_grad():
        params = {name: p if p.dtype == torch.float32 else p.detach().float()
                  for name, p in model_params.items()}
    return TrainState(opt_cfg, params, adamw_init(opt_cfg, params), model_params)


def loss_fn_of(model: torch.nn.Module) -> Callable:
    """The ``loss_fn(model, batch)`` of the model's family: the LM's
    (``models/transformer.py``) or its recsys module's."""
    from repro_torch.models import transformer
    from repro_torch.models.recsys import recsys_module

    if isinstance(model, transformer.LM):
        return transformer.loss_fn
    return recsys_module(model.cfg.name).loss_fn


def microbatch(batch: Dict[str, torch.Tensor], i: int, micro: int) -> Dict[str, torch.Tensor]:
    """Microbatch ``i`` of ``micro``: rows i, i + micro, i + 2·micro, …
    of every field — the interleaved split of ``_lm_cell`` (its
    ``reshape(b // micro, micro, s).swapaxes(0, 1)``)."""
    return {k: v[i::micro] for k, v in batch.items()}


def train_step(model: torch.nn.Module, opt: TrainState, batch: Dict[str, torch.Tensor],
               microbatches: int = 1, loss_fn: Optional[Callable] = None) -> torch.Tensor:
    """One optimizer step on ``batch``: the loss and its gradient over
    ``microbatches`` sequential microbatches (:func:`microbatch`; the
    gradients summed in float32, then divided by their count, the losses
    averaged), then :func:`~repro_torch.train.optimizer.adamw_update` on
    the masters and the model synced.  With one microbatch it is
    ``_recsys_cell``'s step.  Returns the loss, a 0-dim float32 device
    tensor (no host sync)."""
    loss_fn = loss_fn or loss_fn_of(model)
    for p in opt.model_params.values():
        p.grad = None
    b = next(iter(batch.values())).shape[0]
    if microbatches < 1 or b % microbatches:
        raise ValueError(f"{microbatches} microbatches do not divide a batch of {b}")
    sums: Dict[str, torch.Tensor] = {}  # float32 sums of the non-float32 weights' gradients

    def add_into(name):
        def hook(p):
            g, p.grad = p.grad, None
            if name in sums:
                sums[name].add_(g)
            else:
                sums[name] = g.float()
        return hook

    hooks = [p.register_post_accumulate_grad_hook(add_into(name))
             for name, p in opt.model_params.items() if p.dtype != torch.float32]
    try:
        losses = []
        for i in range(microbatches):
            part = loss_fn(model, microbatch(batch, i, microbatches))
            part.backward()
            losses.append(part.detach())
    finally:
        for h in hooks:
            h.remove()
    loss = torch.stack(losses).mean()
    grads = {}
    with torch.no_grad():
        for name, p in opt.model_params.items():
            g = sums.pop(name, p.grad)
            # A weight the loss does not reach has the reference's zero gradient.
            grads[name] = torch.zeros_like(opt.params[name]) if g is None else g.div_(microbatches)
    adamw_update(opt.cfg, grads, opt.opt, opt.params)
    opt.sync_model()
    for p in opt.model_params.values():
        p.grad = None
    return loss.detach()
