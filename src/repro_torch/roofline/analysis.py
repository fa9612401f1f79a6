"""Three-term roofline of a planned step, the port of
``repro.roofline.analysis``:

    compute    = FLOPs_per_chip            / peak_FLOP/s      [s]
    memory     = bytes_per_chip            / HBM_bw           [s]
    collective = collective_bytes_per_chip / link_bw          [s]

The reference reads the three from XLA's compiled artifact
(``cost_analysis``, ``memory_analysis``, the collectives of the optimized
HLO).  The port compiles nothing, so :func:`analyze_plan` reads them from
a ``launch.steps.CellPlan`` and its mesh:

* **FLOPs.** ``torch.utils.flop_counter.FlopCounterMode`` over one call
  of the plan's step on the ``meta`` device, at one data slot's rows:
  every batch tensor (tokens, a batch dict, a cache, the candidates) cut
  along the data axes of its spec, the parameters whole, under a 1 x M
  mesh of the plan's model axis (so the MoE dispatches over its M model
  slots).  The kernel wrappers take their plain versions on a tensor
  that is not on CUDA, so the trace runs no card.  FlopCounterMode counts
  the products (matmul, bmm, einsum's products; the attention's plain
  version is products too, counted over every (query, key) pair, masked
  or not) and every pass the step makes: the remat's replayed forward,
  the backward.  A train step's microbatches are the same passes on rows
  of the same shape, so the trace runs one microbatch (the slot's rows
  over their count) and multiplies its FLOPs and its model-axis sums by
  the count.  The rule: ``flops_per_chip`` is that count over M, the
  products spread over the model axis as the placement splits their
  weights.
* **Bytes.** The placed arguments and outputs less the donated
  arguments, on the slot that holds the most (the counterpart of
  ``memory_analysis``'s argument + output - alias): a lower bound, with
  no temporaries.  It is also ``peak_memory_per_chip``.
* **Collective bytes**, by the reference's own rule (one operand's bytes
  a collective, ``collective_bytes_from_hlo``), counted from the
  placement and from the trace: for a train step, each parameter not
  split over the data axes one ``all-reduce`` a step of its shard's
  float32 gradient, and each one split over them (FSDP) one
  ``all-gather`` of its shard (its dtype) and one ``reduce-scatter`` of
  its float32 gradient before the split (the shard times the data
  slots) a microbatch (a layer placed by layer: the mean over the
  slots); and each ``model``-axis sum the port's mesh paths perform in
  the trace: ``layers._sum_slots`` (the MoE's, an ``all-reduce`` of one
  slot's output) and ``layers._merge_partials`` (the split-K decode's
  partials gathered: an ``all-gather`` of one shard's).  The activation
  reductions GSPMD would put around the Megatron-split dense products
  are not counted: the port runs those products whole on each slot.

Hardware: :data:`H100` (NVIDIA H100 SXM: 989 TFLOP/s bf16 dense, 3.35
TB/s HBM3, 450 GB/s NVLink a direction, 80 GiB).  A report built from a
card run carries the card's name and power limit (``nvidia-smi
--query-gpu=name,power.limit``) beside it in the caller's output.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

__all__ = [
    "HardwareSpec",
    "H100",
    "RooflineReport",
    "COLLECTIVE_KINDS",
    "analyze_plan",
    "placed_bytes",
    "placed_memory",
    "model_flops",
]

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float  # bf16 dense FLOP/s a chip
    hbm_bw: float  # B/s a chip
    link_bw: float  # B/s a link, one direction
    hbm_bytes: float  # capacity a chip


H100 = HardwareSpec(
    name="nvidia-h100-sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    hbm_bytes=80 * 2**30,
)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_total: float
    peak_memory_per_chip: float
    hw: HardwareSpec = H100

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self) -> float:
        total = self.flops_per_chip * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """The share of the compute roofline the step would reach at its
        dominant term's time: useful compute time over the bound."""
        useful_s = self.model_flops_total / (self.chips * self.hw.peak_flops)
        return useful_s / self.bound_time_s if self.bound_time_s else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh, "chips": self.chips,
            "flops_per_chip": self.flops_per_chip, "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip, "compute_s": self.compute_s,
            "memory_s": self.memory_s, "collective_s": self.collective_s,
            "dominant": self.dominant, "model_flops_total": self.model_flops_total,
            "useful_flop_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_memory_per_chip": self.peak_memory_per_chip,
        }


# ---------------------------------------------------------------------------
# The plan's tensors and their placement
# ---------------------------------------------------------------------------


def _pairs(struct, spec, out: list) -> None:
    """(tensor, spec) of every tensor of an argument and its spec tree."""
    from repro_torch.models.layers import KVCache

    if isinstance(struct, KVCache):
        for f in ("k", "v", "k_scale", "v_scale"):
            if getattr(struct, f) is not None:
                out.append((getattr(struct, f), spec[f]))
    elif isinstance(struct, dict):
        for k, v in struct.items():
            _pairs(v, spec[k], out)
    elif isinstance(struct, torch.Tensor):
        out.append((struct, spec))


def _tensor_pairs(structs, specs) -> list:
    out: list = []
    for struct, spec in zip(structs, specs):
        _pairs(struct, spec, out)
    return out


def _slot_bytes(t: torch.Tensor, spec, mesh) -> list:
    from repro_torch.dist import sharding as sh

    n = 1
    for d in sh.shard_shape(t.shape, spec, mesh):
        n *= d
    return [n * t.element_size() if holds else 0 for holds in sh.layer_holders(spec, mesh)]


def placed_memory(plan, mesh) -> Dict[str, list]:
    """Each slot's bytes (lists in slot order) of the plan's arguments as
    placed by their specs (``argument``: each tensor once, a float32
    weight being its own master), of its outputs (``output``), and of
    the outputs written into a donated argument (``alias``)."""
    outs_struct = plan.out_structs if isinstance(plan.out_structs, tuple) else (plan.out_structs,)
    outs_spec = plan.out_specs if isinstance(plan.out_structs, tuple) else (plan.out_specs,)
    zero = [0] * len(mesh)
    out = {"argument": list(zero), "output": list(zero), "alias": list(zero)}
    seen, donated = set(), set()

    def add(key, t, spec):
        out[key] = [a + b for a, b in zip(out[key], _slot_bytes(t, spec, mesh))]

    for j, (struct, spec) in enumerate(zip(plan.in_structs, plan.in_specs)):
        for t, sp in _tensor_pairs((struct,), (spec,)):
            if id(t) not in seen:
                seen.add(id(t))
                add("argument", t, sp)
                if j in plan.donate:
                    donated.add(id(t))
    seen_out = set()
    for t, sp in _tensor_pairs(outs_struct, outs_spec):
        if id(t) not in seen_out:
            seen_out.add(id(t))
            add("output", t, sp)
            if id(t) in donated:
                add("alias", t, sp)
    return out


def placed_bytes(plan, mesh) -> list:
    """Each slot's placed bytes (slot order): arguments + outputs - the
    outputs aliased to donated arguments (:func:`placed_memory`)."""
    m = placed_memory(plan, mesh)
    return [a + o - al for a, o, al in zip(m["argument"], m["output"], m["alias"])]


def _data_cut(shape, spec, mesh) -> tuple:
    """``shape`` cut along the data axes of each entry of ``spec`` (the
    ``model`` axis left whole): one data slot's part."""
    from repro_torch.dist import sharding as sh

    out = list(shape)
    for d, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        size = sh.axes_size(mesh, tuple(a for a in names if a != "model") or None)
        out[d] //= size
    return tuple(out)


def _cut(struct, spec, mesh):
    """A batch-like argument at one data slot's rows, on ``meta``."""
    from repro_torch.models.layers import KVCache

    if isinstance(struct, KVCache):
        f = {k: None if getattr(struct, k) is None else
             torch.empty(_data_cut(getattr(struct, k).shape, spec[k], mesh),
                         dtype=getattr(struct, k).dtype, device="meta")
             for k in ("k", "v", "k_scale", "v_scale")}
        length = struct.length
        if length:  # a decode's full cache: its last position
            length = f["k"].shape[2] - 1
        return KVCache(f["k"], f["v"], f["k_scale"], f["v_scale"], length)
    if isinstance(struct, dict):
        return {k: _cut(v, spec[k], mesh) for k, v in struct.items()}
    return torch.empty(_data_cut(struct.shape, spec, mesh), dtype=struct.dtype, device="meta")


def _trace_mesh(mesh):
    from repro_torch.dist.fault_tolerance import ShardSlot, SlotMesh

    m = int(mesh.shape["model"]) if "model" in mesh.axis_names else 1
    meta = torch.device("meta")
    return SlotMesh([ShardSlot(i, meta) for i in range(m)], (1, m), ("data", "model"))


def _step_flops(plan, mesh, coll: Dict[str, float]) -> float:
    """The FLOPs of one call of ``plan``'s step at one data slot's rows
    (module docstring), adding the model-axis sums the trace performs to
    ``coll``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import layers as L

    trace = _trace_mesh(mesh)
    args = list(plan.in_structs)
    train = plan.kind in ("train", "train_minibatch")
    micro = plan.microbatches if train else 1
    for j in range(2 if train else 1, len(args)):
        args[j] = _cut(args[j], plan.in_specs[j], mesh)
    if micro > 1:  # one microbatch of the slot's rows
        args[2] = {k: torch.empty((v.shape[0] // micro, *v.shape[1:]), dtype=v.dtype,
                                  device="meta") for k, v in args[2].items()}
    step = plan.bind(plan.model, trace, microbatches=1) if train else plan.bind(plan.model, trace)
    sum_slots, merge = L._sum_slots, L._merge_partials

    def counted_sum(outs, device):
        coll["all-reduce"] += micro * outs[0].numel() * outs[0].element_size()
        return sum_slots(outs, device)

    def counted_merge(parts, dims, dtype, device):
        _, ml, acc = parts[0]
        coll["all-gather"] += ml.numel() * ml.element_size() + acc.numel() * acc.element_size()
        return merge(parts, dims, dtype, device)

    L._sum_slots, L._merge_partials = counted_sum, counted_merge
    try:
        with FlopCounterMode(display=False) as counter:
            step(*args)
    finally:
        L._sum_slots, L._merge_partials = sum_slots, merge
    return float(counter.get_total_flops()) * micro


def _gradient_collectives(plan, mesh, coll: Dict[str, float]) -> None:
    """The data-axis reductions of a train step's gradients (module
    docstring), per chip."""
    from repro_torch.dist import sharding as sh

    dp = sh.data_spec(mesh)
    dp_size = sh.axes_size(mesh, dp)
    if dp_size < 2:
        return
    dp_names = set(dp if isinstance(dp, tuple) else (dp,))
    params, pspecs = plan.in_structs[0], plan.in_specs[0]
    n_slots = len(mesh)
    for name, t in params.items():
        spec = pspecs[name]
        per_slot = _slot_bytes(t, spec, mesh)
        shard_elems = sum(per_slot) / n_slots / t.element_size()
        entries = [e for e in tuple(spec) if e is not None]
        lead = getattr(spec, "layer", None)
        if lead is not None and lead[0] is not None:
            entries.append(lead[0])
        fsdp = any(set(e if isinstance(e, tuple) else (e,)) & dp_names for e in entries)
        if fsdp:
            coll["all-gather"] += plan.microbatches * shard_elems * t.element_size()
            coll["reduce-scatter"] += plan.microbatches * shard_elems * dp_size * 4
        else:
            coll["all-reduce"] += shard_elems * 4


def analyze_plan(plan, mesh=None, hw: HardwareSpec = H100, mesh_name: Optional[str] = None,
                 cell=None) -> RooflineReport:
    """The :class:`RooflineReport` of ``plan`` on ``mesh`` (default: the
    plan's), read as the module docstring states.  ``cell`` defaults to
    the registry's cell of the plan (for :func:`model_flops`)."""
    mesh = plan.mesh if mesh is None else mesh
    if cell is None:
        from repro_torch.configs.registry import get_arch

        cell = get_arch(plan.arch).cells[plan.shape_name]
    n_model = int(mesh.shape["model"]) if "model" in mesh.axis_names else 1
    coll = {k: 0.0 for k in COLLECTIVE_KINDS}
    flops = _step_flops(plan, mesh, coll) / n_model
    if plan.kind in ("train", "train_minibatch"):
        _gradient_collectives(plan, mesh, coll)
    coll = {k: int(v) for k, v in coll.items()}
    coll["total"] = sum(coll.values())
    byts = float(max(placed_bytes(plan, mesh)))
    name = mesh_name or "x".join(str(int(mesh.shape[a])) for a in mesh.axis_names)
    return RooflineReport(
        arch=plan.arch, shape=plan.shape_name, mesh=name, chips=len(mesh),
        flops_per_chip=flops, bytes_per_chip=byts, coll_bytes_per_chip=coll,
        compute_s=flops / hw.peak_flops, memory_s=byts / hw.hbm_bw,
        collective_s=coll["total"] / hw.link_bw, model_flops_total=model_flops(plan, cell),
        peak_memory_per_chip=byts, hw=hw)


# ---------------------------------------------------------------------------
# Model FLOPs (the "useful work" yardstick)
# ---------------------------------------------------------------------------


def _lm_attention_flops(cfg, batch: int, s_q: int, s_k: int, train: bool) -> float:
    """QK and PV products over the layers, a local layer attending to at
    most ``window`` keys; square causal attention halved; training 3x
    (forward and backward)."""
    h, hd = cfg.n_heads, cfg.head_dim
    total = 0.0
    for i in range(cfg.n_layers):
        is_global = cfg.window is None or (cfg.global_every and (i + 1) % cfg.global_every == 0)
        keys = s_k if is_global else min(cfg.window, s_k)
        per = 2.0 * batch * s_q * keys * h * hd * 2  # two products
        if s_q == s_k and is_global:
            per *= 0.5  # causal square
        total += per
    return total * (3.0 if train else 1.0)


def model_flops(plan, cell) -> float:
    """6·N·D (train) / 2·N·D (inference) plus attention's products, with
    each family's N and D: the reference's arithmetic.  ``plan`` needs
    only ``kind``, ``cfg`` and ``arch``."""
    kind, cfg = plan.kind, plan.cfg
    if hasattr(cfg, "n_active_params"):  # LM
        n = cfg.n_active_params()
        if kind == "train":
            s = cell.extra["seq_len"]
            return 6.0 * n * cell.batch * s + _lm_attention_flops(cfg, cell.batch, s, s, True)
        if kind == "prefill":
            s = cell.extra["seq_len"]
            return 2.0 * n * cell.batch * s + _lm_attention_flops(cfg, cell.batch, s, s, False)
        if kind == "decode":
            lk = cell.extra["cache_len"]
            return 2.0 * n * cell.batch + _lm_attention_flops(cfg, cell.batch, 1, lk, False)
    if plan.arch == "pna":
        from repro_torch.data.graphs import NeighborSampler

        dh, ex = cfg.d_hidden, cell.extra
        if kind == "train_minibatch":
            class _B:
                fanouts = ex["fanouts"]

            n_nodes, n_edges = NeighborSampler.budget(_B, cell.batch)
        elif "nodes_per_graph" in ex:
            n_nodes = cell.batch * ex["nodes_per_graph"]
            n_edges = cell.batch * ex["edges_per_graph"]
        else:
            n_nodes, n_edges = ex["n_nodes"], ex["n_edges"]
        fwd = cfg.n_layers * (2 * n_edges * 2 * dh * dh + n_nodes * 12 * dh * dh * 2)
        fwd += 2 * n_nodes * cfg.d_feat * dh
        return 3.0 * fwd if kind.startswith("train") else fwd
    # recsys: the dense compute only (embedding gathers are bytes, not FLOPs)
    dense_params = {
        "dien": lambda c: c.n_params() - c.vocab * c.embed_dim,
        "mind": lambda c: c.n_params() - c.vocab * c.embed_dim,
        "bert4rec": lambda c: c.n_params() - c.vocab * c.embed_dim,
        "dcn-v2": lambda c: c.n_params() - c.n_sparse * c.vocab_per_field * c.embed_dim,
    }[plan.arch](cfg)
    seq = getattr(cfg, "seq_len", getattr(cfg, "hist_len", 1))
    per_ex = dense_params * (seq if plan.arch in ("dien", "bert4rec") else 1)
    if kind == "train":
        return 6.0 * per_ex * cell.batch
    if kind == "serve":
        return 2.0 * per_ex * cell.batch
    if kind == "retrieval":
        emb = getattr(cfg, "embed_dim", 16)
        return 2.0 * per_ex * cell.batch + 2.0 * cell.extra["n_candidates"] * emb
    return 0.0
