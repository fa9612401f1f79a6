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

``_pna_cell``'s step is this step with one microbatch on PNA's
``loss_fn``; its batches (a full graph, a sampled subgraph, a batch of
molecules) are built by ``launch/train.py::graph_setup``.

**Under a mesh** (``train_step(..., mesh=)``, a ``SlotMesh``) the step
computes the reference's function under the ``CellPlan`` shardings, where
GSPMD leaves the function unchanged but for the expert-parallel MoE,
which the ambient mesh routes through ``_moe_apply_sharded``.  So the
step is the single-device step with ``mesh`` set as the ambient mesh, as
the reference's dry run sets it: every loss runs over its whole
microbatch (mind's (B, B) in-batch logits, bert4rec's masked mean and
PNA's graph stay whole), and each MoE call splits its tokens over the
data axes in blocks of rows, dispatches each block on its data slot's
model slots and averages the blocks' aux losses (the reference's
``pmean``).  Microbatch i holds rows i, i + micro, ... of the batch, so
its data block d is microbatch i of data slot d's block of rows
(``batch_specs``: the leading dim over the data axes), where the
reference's ``P(None, dp, None)`` constraint pins it.
:func:`data_slot_grads` gives each data slot's share of the gradient,
the inputs of an all-reduce such as ``dist.compression``'s.

**Plans** (:func:`build_cell`, the reference's ``CellPlan`` family):
every cell of every arch as a step, its inputs as ``meta`` tensors (the
port's ``ShapeDtypeStruct``), their spec trees (``dist/sharding.py``) and
the donated arguments; ``roofline.analyze_plan`` and ``launch/dryrun.py``
read them.  The port counts every loop iteration when it traces a step,
so the reference's ``probe_plan`` / ``probe_overrides`` / ``cost_scale``
(which exist because XLA's ``cost_analysis`` counts a loop body once)
have no counterpart.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.dist import sharding as sh
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["CellPlan", "TrainState", "build_cell", "data_slot_grads", "loss_fn_of",
           "microbatch", "round_up", "step_grads", "train_state", "train_step"]


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
    """The ``loss_fn(model, batch)`` of the module that defines the
    model's class: the LM's (``models/transformer.py``), PNA's
    (``models/pna.py``) or its recsys module's, whatever its config's
    name."""
    return importlib.import_module(type(model).__module__).loss_fn


def microbatch(batch: Dict[str, torch.Tensor], i: int, micro: int) -> Dict[str, torch.Tensor]:
    """Microbatch ``i`` of ``micro``: rows i, i + micro, i + 2·micro, …
    of every field — the interleaved split of ``_lm_cell`` (its
    ``reshape(b // micro, micro, s).swapaxes(0, 1)``)."""
    return {k: v[i::micro] for k, v in batch.items()}


def step_grads(model: torch.nn.Module, params: Dict[str, torch.Tensor],
               batch: Dict[str, torch.Tensor], microbatches: int = 1,
               loss_fn: Optional[Callable] = None,
               mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and the float32 gradient of :func:`train_step`, no
    update: ``(loss, grads)``, ``grads`` by name of ``params`` (the
    model's trainable parameters), summed over the microbatches and
    divided by their count.  Under ``mesh`` the passes run with it as the
    ambient mesh (module docstring)."""
    loss_fn = loss_fn or loss_fn_of(model)
    b = next(iter(batch.values())).shape[0]
    if microbatches < 1 or b % microbatches:
        raise ValueError(f"{microbatches} microbatches do not divide a batch of {b}")
    for p in params.values():
        p.grad = None
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
             for name, p in params.items() if p.dtype != torch.float32]
    before = sh.get_active_mesh()
    if mesh is not None:
        sh.set_mesh(mesh)
    try:
        losses = []
        for i in range(microbatches):
            part = loss_fn(model, microbatch(batch, i, microbatches))
            part.backward()
            losses.append(part.detach())
    finally:
        sh.set_mesh(before)
        for h in hooks:
            h.remove()
    grads = {}
    with torch.no_grad():
        for name, p in params.items():
            g = sums.pop(name, p.grad)
            p.grad = None
            # A weight the loss does not reach has the reference's zero gradient.
            grads[name] = (torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                           if g is None else g.div_(microbatches))
    return torch.stack(losses).mean(), grads


def data_slot_grads(model: torch.nn.Module, params: Dict[str, torch.Tensor],
                    batch: Dict[str, torch.Tensor], microbatches: int, mesh,
                    loss_fn: Optional[Callable] = None) -> List[Dict[str, torch.Tensor]]:
    """Each data slot's share of a mesh step's gradient, in slot order:
    the inputs of an all-reduce such as
    ``dist.compression.compressed_psum_tree``.  Data slot d takes its
    block of rows (``batch_specs``: the leading dim over the data axes)
    and runs :func:`step_grads` on it under a 1 x M mesh of its own model
    slots, so the MoE dispatches the tokens the mesh step's data shard d
    dispatches; its tree is divided by the slot count.  For a loss that
    is a mean over equal rows (the LMs') the trees sum to the mesh step's
    gradient.  A loss that couples rows (mind's in-batch negatives, PNA's
    graph) has no such split; :func:`train_step` never takes it."""
    from repro_torch.dist.fault_tolerance import SlotMesh

    n_model = int(mesh.shape["model"]) if "model" in mesh.axis_names else 1
    n_data = len(mesh) // n_model
    b = next(iter(batch.values())).shape[0]
    if b % n_data:
        raise ValueError(f"a batch of {b} rows does not split over {n_data} data slots")
    rows = b // n_data
    out = []
    for d in range(n_data):
        sub = SlotMesh(list(mesh)[d * n_model:(d + 1) * n_model], (1, n_model),
                       ("data", "model"))
        block = {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()}
        _, tree = step_grads(model, params, block, microbatches, loss_fn, sub)
        out.append({k: g.div_(n_data) for k, g in tree.items()})
    return out


def train_step(model: torch.nn.Module, opt: TrainState, batch: Dict[str, torch.Tensor],
               microbatches: int = 1, loss_fn: Optional[Callable] = None,
               mesh=None) -> torch.Tensor:
    """One optimizer step on ``batch``: the loss and its gradient over
    ``microbatches`` sequential microbatches (:func:`microbatch`; the
    gradients summed in float32, then divided by their count, the losses
    averaged: :func:`step_grads`, under ``mesh`` where given), then
    :func:`~repro_torch.train.optimizer.adamw_update` on the masters and
    the model synced.  With one microbatch it is ``_recsys_cell``'s step.
    Returns the loss, a 0-dim float32 device tensor (no host sync)."""
    loss, grads = step_grads(model, opt.model_params, batch, microbatches, loss_fn, mesh)
    adamw_update(opt.cfg, grads, opt.opt, opt.params)
    opt.sync_model()
    return loss


# ---------------------------------------------------------------------------
# Plans: one step a (arch, cell), its inputs as meta tensors, its specs
# ---------------------------------------------------------------------------


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _struct(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor: the port's ``ShapeDtypeStruct`` (no memory)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclasses.dataclass
class CellPlan:
    """One (arch, cell) on a mesh: ``step`` takes the positional
    arguments ``in_structs`` describes (``meta`` tensors, or dicts of
    them; a cache is a ``KVCache``) and returns what ``out_structs``
    describes; ``in_specs`` / ``out_specs`` are their spec trees
    (``dist/sharding.py``), ``donate`` the arguments the step may write in
    place (train: the parameters and the optimizer state; prefill and
    decode: the cache).  ``model`` is the ``meta`` model the step runs,
    and ``bind(model, mesh=None)`` the same step on another model of the
    same config (a real one: the step then trains or serves it), under
    ``mesh`` in place of the plan's (a train plan's ``bind`` also takes
    ``microbatches``).  A step runs under its mesh: the train step
    passes it to :func:`train_step`, the others set it as the ambient
    mesh for the call.  ``mesh`` is the plan's mesh, ``microbatches`` a
    train step's split and ``opt_cfg`` its AdamW config (the reference
    cell's)."""

    arch: str
    shape_name: str
    kind: str
    step: Callable
    in_structs: Tuple[Any, ...]
    in_specs: Tuple[Any, ...]
    out_structs: Any
    out_specs: Any
    cfg: Any
    model: Any = None
    bind: Optional[Callable] = None
    mesh: Any = None
    note: str = ""
    donate: Tuple[int, ...] = ()
    microbatches: int = 1
    opt_cfg: Optional[AdamWConfig] = None


def _under(mesh, fn: Callable) -> Callable:
    """``fn`` run without gradients under the ambient ``mesh`` (restored
    after): the serving steps, whose model reads the ambient mesh."""
    def step(*args):
        before = sh.get_active_mesh()
        sh.set_mesh(mesh)
        try:
            with torch.no_grad():
                return fn(*args)
        finally:
            sh.set_mesh(before)
    return step


def _train_plan(spec, shape_name, cell, mesh, cfg, model, opt_cfg, batch_struct, bspecs,
                loss_fn, micro, note=""):
    """A train cell's plan: ``step(params, opt_state, batch)`` runs
    :func:`train_step` under ``mesh`` and returns ``(params, opt_state,
    loss)``; ``opt_state`` holds the float32 masters (``params``; a
    float32 weight is its own) beside AdamW's ``mu``, ``nu`` and
    ``step``."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    masters = {n: p if p.dtype == torch.float32 else _struct(p.shape, torch.float32)
               for n, p in params.items()}
    opt_struct = {"params": masters, **adamw_init(opt_cfg, masters)}
    pspecs = sh.param_specs(model, mesh, fsdp=spec.fsdp)
    ospecs = {"params": dict(pspecs), **sh.opt_state_specs(pspecs)}

    def make_step(m, on=None, microbatches=None):
        def step(params, opt_state, batch):
            state = TrainState(opt_cfg, opt_state["params"],
                               {k: opt_state[k] for k in ("mu", "nu", "step")}, params)
            loss = train_step(m, state, batch, microbatches or micro, loss_fn, mesh=on or mesh)
            return params, {"params": state.params, **state.opt}, loss
        return step

    return CellPlan(
        arch=spec.name, shape_name=shape_name, kind=cell.kind, step=make_step(model),
        in_structs=(params, opt_struct, batch_struct), in_specs=(pspecs, ospecs, bspecs),
        out_structs=(params, opt_struct, _struct((), torch.float32)),
        out_specs=(pspecs, ospecs, ()), cfg=cfg, model=model, bind=make_step, mesh=mesh,
        note=note, donate=(0, 1), microbatches=micro, opt_cfg=opt_cfg)


def _lm_cell(spec, shape_name: str, cell, mesh, extra_overrides: Optional[dict] = None):
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(spec.cfg, **{**cell.overrides, **(extra_overrides or {})})
    model = T.LM(cfg, "meta")
    dp = sh.data_spec(mesh)
    if cell.kind == "train":
        b, s = cell.batch, cell.extra["seq_len"]
        micro = int(cell.extra.get("microbatches", 1))
        opt_cfg = AdamWConfig(moment_dtype="bfloat16" if spec.fsdp else "float32")
        batch_struct = {"tokens": _struct((b, s), torch.int32),
                        "targets": _struct((b, s), torch.int32)}
        bspecs = sh.batch_specs({k: v.shape for k, v in batch_struct.items()}, mesh)
        return _train_plan(spec, shape_name, cell, mesh, cfg, model, opt_cfg, batch_struct,
                           bspecs, T.loss_fn, micro,
                           note=f"microbatches={micro}" if micro > 1 else "")
    if cell.kind not in ("prefill", "decode"):
        raise ValueError(cell.kind)
    pspecs = sh.lm_param_specs(model, mesh, fsdp=spec.fsdp)
    b = cell.batch
    if cell.kind == "prefill":
        s = cell.extra["seq_len"]
        cache = T.init_cache(cfg, b, s, device="meta")
        tok = _struct((b, s), torch.int32)
    else:  # a full cache: the last position's decode (the reference masks the whole buffer)
        s = cell.extra["cache_len"]
        cache = T.init_cache(cfg, b, s, device="meta")
        cache.length = s - 1
        tok = _struct((b, 1), torch.int32)
    cspecs = sh.cache_specs(cache, mesh)
    tspec = sh.validate_spec(mesh, (dp, None), tok.shape)
    run = T.prefill if cell.kind == "prefill" else T.decode_step

    def make_step(m, on=None):
        return _under(on or mesh, lambda params, tokens, cache: run(m, tokens, cache))

    logits = _struct((b, cfg.vocab), torch.float32)
    return CellPlan(
        arch=spec.name, shape_name=shape_name, kind=cell.kind, step=make_step(model),
        in_structs=(dict(model.named_parameters()), tok, cache),
        in_specs=(pspecs, tspec, cspecs), out_structs=(logits, cache),
        out_specs=(sh.validate_spec(mesh, (dp, "model"), logits.shape), cspecs), cfg=cfg,
        model=model, bind=make_step, mesh=mesh, donate=(2,))


def _pna_cell(spec, shape_name: str, cell, mesh, extra_overrides: Optional[dict] = None):
    from repro_torch.data.graphs import NeighborSampler
    from repro_torch.models import pna as M

    ex = cell.extra
    readout = ex.get("readout", "node")
    cfg = dataclasses.replace(spec.cfg, d_feat=ex.get("d_feat", spec.cfg.d_feat),
                              n_classes=ex.get("n_classes", spec.cfg.n_classes),
                              readout=readout, **(extra_overrides or {}))
    model = M.PNA(cfg, "meta")
    dp = sh.data_spec(mesh)
    f32, i32 = torch.float32, torch.int32
    if cell.kind == "train_minibatch":
        class _B:  # the budget without building the graph
            fanouts = ex["fanouts"]

        n_pad, e_pad = NeighborSampler.budget(_B, cell.batch)
        n_pad, e_pad = round_up(n_pad, 512), round_up(e_pad, 512)
        batch_struct = {"feats": _struct((n_pad, ex["d_feat"]), f32),
                        "edges": _struct((e_pad, 2), i32), "edge_mask": _struct((e_pad,), f32),
                        "seed_pos": _struct((cell.batch,), i32),
                        "labels": _struct((cell.batch,), i32)}
        note = f"sampled subgraph: N_pad={n_pad} E_pad={e_pad}"
    elif readout == "graph":
        n_pad = round_up(cell.batch * ex["nodes_per_graph"], 512)
        e_pad = round_up(cell.batch * ex["edges_per_graph"], 512)
        batch_struct = {"feats": _struct((n_pad, ex["d_feat"]), f32),
                        "edges": _struct((e_pad, 2), i32), "edge_mask": _struct((e_pad,), f32),
                        "graph_id": _struct((n_pad,), i32),
                        "labels": _struct((cell.batch,), i32)}
        note = f"batched molecules: N_pad={n_pad} E_pad={e_pad}"
    else:
        n_pad, e_pad = round_up(ex["n_nodes"], 512), round_up(ex["n_edges"], 512)
        batch_struct = {"feats": _struct((n_pad, ex["d_feat"]), f32),
                        "edges": _struct((e_pad, 2), i32), "edge_mask": _struct((e_pad,), f32),
                        "labels": _struct((n_pad,), i32), "label_mask": _struct((n_pad,), f32)}
        note = f"full graph: N_pad={n_pad} E_pad={e_pad}"
    bspecs = sh.batch_specs(  # nodes over the data axes, edges over model
        {k: v.shape for k, v in batch_struct.items()}, mesh,
        field_rules={"feats": (dp, None),
                     "labels": (dp,) if readout == "node" and cell.kind == "train" else (),
                     "label_mask": (dp,), "graph_id": (dp,), "edges": ("model", None),
                     "edge_mask": ("model",), "seed_pos": ()})
    return _train_plan(spec, shape_name, cell, mesh, cfg, model, AdamWConfig(), batch_struct,
                       bspecs, M.loss_fn, 1, note=note)


def _recsys_batch_struct(name: str, cfg, batch: int) -> dict:
    f32, i32 = torch.float32, torch.int32
    if name == "dcn-v2":
        return {"dense": _struct((batch, cfg.n_dense), f32),
                "sparse_ids": _struct((batch, cfg.n_sparse), i32),
                "target_id": _struct((batch,), i32), "label": _struct((batch,), f32)}
    t = cfg.hist_len if name == "mind" else cfg.seq_len
    return {"hist_ids": _struct((batch, t), i32), "hist_mask": _struct((batch, t), f32),
            "target_id": _struct((batch,), i32), "label": _struct((batch,), f32)}


def _recsys_cell(spec, shape_name: str, cell, mesh, extra_overrides: Optional[dict] = None):
    from repro_torch.models.convert import _RECSYS
    from repro_torch.models.recsys import recsys_module

    M = recsys_module(spec.name)
    cfg = dataclasses.replace(spec.cfg, **(extra_overrides or {}))
    model = _RECSYS[spec.name](cfg, "meta")
    dp = sh.data_spec(mesh)
    batch_struct = _recsys_batch_struct(spec.name, cfg, cell.batch)
    if cell.kind == "train":
        bspecs = sh.batch_specs({k: v.shape for k, v in batch_struct.items()}, mesh)
        return _train_plan(spec, shape_name, cell, mesh, cfg, model, AdamWConfig(),
                           batch_struct, bspecs, M.loss_fn, 1)
    pspecs = sh.recsys_param_specs(model, mesh)
    params = dict(model.named_parameters())
    batch_struct.pop("label")
    bspecs = sh.batch_specs({k: v.shape for k, v in batch_struct.items()}, mesh)
    if cell.kind == "serve":
        def make_step(m, on=None):
            return _under(on or mesh, lambda params, batch: m(batch))

        out = _struct((cell.batch,), torch.float32)
        return CellPlan(
            arch=spec.name, shape_name=shape_name, kind="serve", step=make_step(model),
            in_structs=(params, batch_struct), in_specs=(pspecs, bspecs), out_structs=out,
            out_specs=sh.validate_spec(mesh, (dp,), out.shape), cfg=cfg, model=model,
            bind=make_step, mesh=mesh)
    if cell.kind == "retrieval":  # batch 1: the query replicated, the candidates split
        n_cand = cell.extra["n_candidates"]
        bspecs = {k: () for k in bspecs}
        cand = _struct((n_cand,), torch.int32)

        def make_step(m, on=None):
            return _under(on or mesh, lambda params, batch, cand_ids:
                          m.score_candidates(batch, cand_ids))

        out = _struct((cell.batch, n_cand), torch.float32)
        return CellPlan(
            arch=spec.name, shape_name=shape_name, kind="retrieval", step=make_step(model),
            in_structs=(params, batch_struct, cand),
            in_specs=(pspecs, bspecs, sh.validate_spec(mesh, (dp,), cand.shape)),
            out_structs=out, out_specs=sh.validate_spec(mesh, (None, dp), out.shape), cfg=cfg,
            model=model, bind=make_step, mesh=mesh)
    raise ValueError(cell.kind)


def build_cell(spec, shape_name: str, mesh, extra_overrides: Optional[dict] = None) -> CellPlan:
    """The :class:`CellPlan` of ``spec``'s cell ``shape_name`` on ``mesh``
    (a ``SlotMesh``, the production meshes' slots on ``meta``).  Raises for
    a skipped cell."""
    cell = spec.cells[shape_name]
    if cell.skip:
        raise ValueError(f"cell {spec.name}/{shape_name} is skipped: {cell.skip}")
    if spec.family == "lm":
        return _lm_cell(spec, shape_name, cell, mesh, extra_overrides)
    if spec.family == "gnn":
        return _pna_cell(spec, shape_name, cell, mesh, extra_overrides)
    if spec.family == "recsys":
        return _recsys_cell(spec, shape_name, cell, mesh, extra_overrides)
    raise ValueError(spec.family)
