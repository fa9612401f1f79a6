"""Sharding rules and placement over a mesh of shard slots.

The JAX package maps every tree it moves onto a mesh (parameters,
optimizer state, batches, KV caches) to ``PartitionSpec``s over the
canonical ``("data", "model")`` mesh (a leading ``"pod"`` axis on
multi-pod meshes).  The port keeps the same rules and writes a spec as a
tuple of entries, one a dimension: ``None`` (not split), an axis name, or
a tuple of axis names; ``()`` is the fully replicated spec (``P()``).
Then :func:`place` puts a tensor on the mesh as one tensor a slot, in
slot order (on one card each shard is a view), and :func:`shard_shape`
gives a slot's shape.

* LM parameters follow the Megatron layout (:func:`lm_param_specs`):
  q/k/v, MLP up/gate and the router column-parallel (output dim over
  ``model``), o and down row-parallel (input dim over ``model``), the
  embedding's vocab dim over ``model``, the experts' dim over ``model``;
  ``fsdp=True`` also splits the largest remaining dim over the data axes
  (ZeRO-3).  PNA and the recsys archs take :func:`_generic_rule`.
* Batches split their leading dim over the data axes
  (:func:`batch_specs`); KV caches follow the split-K decode's layout
  (:func:`cache_specs`).
* Every spec passes :func:`validate_spec`: an entry whose axes do not
  divide its dim becomes ``None``, so one set of rules serves a 1 x 1
  mesh, the 16 x 16 pod and the 2 x 16 x 16 multi-pod mesh.

The rules key on the JAX tree's path (``"layers"``, ``"q"``,
``"kernel"``, ``"moe"``, ...).  Each port parameter takes its path from
``models/convert.py``'s leaf table, so the trees agree by construction,
and the spec trees are keyed by the port's parameter names.  The
reference stacks a model's layers on a leading (L,) axis; the port keeps
one tensor a layer, so a layer's spec is the reference's without its
leading entry (:class:`LayerSpec`).  Where the reference splits that
stacked axis (``validate_spec`` keeps an entry on L when its axes divide
L, and ``_with_fsdp`` may pick L as the largest free dim), the port
cannot split a layer's tensor along it: it places the layer whole, by
layer — layer ``i`` of ``L`` lies on the slots whose coordinate over the
leading entry's axes is ``i // (L / n)`` (``n`` the entry's size), the
same block of layers each slot holds in the reference, and on no other
slot (:func:`layer_holders`).

Also here: the ambient mesh (:func:`set_mesh` / :func:`get_active_mesh`,
a module global that the LM layers read to pick their mesh paths), the
axis helpers, :class:`CacheShard` (one slot's rows and positions of a KV
cache, ``layers.decode_shards``), :func:`shard_rows` and
:func:`device_count`.

A mesh is a :class:`repro_torch.dist.fault_tolerance.SlotMesh` (slots on
named axes) or, where only rows are sharded, a plain sequence of shard
slots or devices, one shard each.  The spec functions read only its
``axis_names`` and ``shape``, so they take a jax mesh as well.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "set_mesh",
    "get_active_mesh",
    "batch_axes",
    "data_spec",
    "axes_size",
    "postings_spec",
    "plan_specs",
    "validate_spec",
    "LayerSpec",
    "lm_param_specs",
    "pna_param_specs",
    "recsys_param_specs",
    "param_specs",
    "opt_state_specs",
    "batch_specs",
    "cache_specs",
    "layer_holders",
    "slot_coords",
    "shard_shape",
    "place",
    "CacheShard",
    "shard_rows",
    "device_count",
]

Spec = Tuple[Any, ...]


_ACTIVE_MESH = None


def set_mesh(mesh):
    """Make ``mesh`` (a ``SlotMesh``) the ambient mesh the model's mesh
    paths see; ``None`` clears it.  Returns ``mesh``."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    return mesh


def get_active_mesh():
    """The ambient mesh, or None when no mesh has been set."""
    return _ACTIVE_MESH


def batch_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes: every mesh axis except ``model``."""
    return tuple(a for a in mesh.axis_names if a != "model")


def data_spec(mesh):
    """The data axes as one entry: None, an axis name, or a tuple of them."""
    dp = batch_axes(mesh)
    if not dp:
        return None
    return dp if len(dp) > 1 else dp[0]


def axes_size(mesh, entry) -> int:
    """Product of the sizes of the mesh axes named by ``entry`` (None, an
    axis name, or a tuple of them)."""
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(int(mesh.shape[a]) for a in names)


def postings_spec(mesh) -> Spec:
    """Spec of the sharded engine's stacked postings (S, W): the shard dim
    over the data axes, each shard's postings row whole."""
    return (data_spec(mesh), None)


def plan_specs(mesh) -> Tuple[Spec, Spec]:
    """Specs of a sharded lowered plan's cells (S, 4, C) and stage
    segments (S, 2, n_stages * group_width): the shard dim over the data
    axes."""
    dp = data_spec(mesh)
    return (dp, None, None), (dp, None, None)


def validate_spec(mesh, spec, shape) -> Spec:
    """``spec`` clamped to ``shape``: an entry whose axes' sizes do not
    divide its dim, that names an axis the mesh lacks, or whose size is 1
    becomes None; trailing Nones are dropped (``()``: replicated).  A
    spec longer than the shape is a rank error and raises."""
    entries = tuple(spec)
    if len(entries) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {tuple(shape)}")
    names = set(mesh.axis_names)
    out = []
    for dim, entry in zip(shape, entries + (None,) * (len(shape) - len(entries))):
        req = entry if isinstance(entry, tuple) else (entry,)
        if entry is None or not set(req) <= names:
            out.append(None)
            continue
        size = axes_size(mesh, entry)
        out.append(entry if size > 1 and dim % size == 0 else None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


class LayerSpec(tuple):
    """The spec of one layer's tensor of a stacked leaf: the reference's
    spec without its leading entry (it compares equal to that tuple), and
    ``layer = (entry, i, L)``: the stacked axis's entry (None: every slot
    holds every layer), the layer's index and the layer count."""

    def __new__(cls, entries, layer):
        self = super().__new__(cls, entries)
        self.layer = layer
        return self

    def __repr__(self) -> str:
        return f"LayerSpec({tuple(self)}, layer={self.layer})"


def _with_fsdp(entries: list, shape, mesh, dp) -> list:
    """ZeRO-3: the largest dim still unsplit that the data axes divide
    goes over them."""
    if dp is None:
        return entries
    size = axes_size(mesh, dp)
    free = [i for i, e in enumerate(entries) if e is None and shape[i] % size == 0
            and shape[i] >= size]
    if free:
        entries[max(free, key=lambda i: shape[i])] = dp
    return entries


_COLUMN_PARALLEL = {"q", "k", "v", "up", "gate", "encode", "router"}
_ROW_PARALLEL = {"o", "down", "decode"}


def _lm_rule(keys: Tuple[str, ...], shape, mesh, fsdp: bool, dp) -> Spec:
    """Megatron placement of one LM leaf; ``keys`` is its dict-key path
    and ``shape`` the reference's (stacked leaves with their (L,) axis)."""
    lead = 1 if "layers" in keys else 0
    name = keys[-1] if keys else ""
    owner = keys[-2] if len(keys) >= 2 else ""
    entries = [None] * len(shape)
    if name == "embed":
        entries[0] = "model"
    elif name == "lm_head":
        entries[-1] = "model"
    elif owner == "moe" and len(shape) - lead >= 2:
        entries[lead] = "model"  # experts over model
    elif owner in _COLUMN_PARALLEL or name in _COLUMN_PARALLEL:
        if name in ("kernel", "bias") or owner in _COLUMN_PARALLEL:
            entries[-1] = "model"
    elif owner in _ROW_PARALLEL or name in _ROW_PARALLEL:
        if len(shape) - lead >= 2:
            entries[-2] = "model"  # the input dim; a bias stays replicated
    if fsdp:
        entries = _with_fsdp(entries, shape, mesh, dp)
    return validate_spec(mesh, entries, shape)


def _generic_rule(keys: Tuple[str, ...], shape, mesh) -> Spec:
    """PNA's and the recsys archs' rule: (vocab, dim) tables split their
    vocab dim, row-parallel kernels their input dim, other kernels their
    output dim over ``model``; vectors replicated."""
    name = keys[-1] if keys else ""
    owner = keys[-2] if len(keys) >= 2 else ""
    entries = [None] * len(shape)
    if any("emb" in k for k in (name, owner)) and len(shape) >= 2:
        entries[-2] = "model"
    elif name in _ROW_PARALLEL or owner in _ROW_PARALLEL:
        if len(shape) >= 2:
            entries[-2] = "model"
    elif len(shape) >= 2:
        entries[-1] = "model"
    return validate_spec(mesh, entries, shape)


def _named_leaves(model) -> List[Tuple[str, Tuple[str, ...], tuple, Optional[int], int]]:
    """(parameter name, dict-key path, the reference's shape, layer index
    or None, layer count) of every leaf of ``model``'s JAX tree, from
    ``models/convert.py``'s leaf table.  List indices (an MLP tower's
    layers) are not keys, as in the reference's ``_path_keys``."""
    from repro_torch.models.convert import _leaves

    names = {id(p): n for n, p in model.named_parameters()}
    leaves = _leaves(model)
    counts: Dict[tuple, int] = {}
    for path, i, _ in leaves:
        if i is not None:
            counts[path] = counts.get(path, 0) + 1
    out = []
    for path, i, t in leaves:
        keys = tuple(str(k) for k in path if not isinstance(k, int))
        n = counts.get(path, 0)
        shape = tuple(t.shape) if i is None else (n,) + tuple(t.shape)
        out.append((names[id(t)], keys, shape, i, n))
    return out


def _tree_specs(model, rule) -> Dict[str, Spec]:
    out = {}
    for name, keys, shape, i, n in _named_leaves(model):
        spec = rule(keys, shape)
        if i is not None:
            spec = LayerSpec(spec[1:], (spec[0] if spec else None, i, n))
        out[name] = spec
    return out


def lm_param_specs(model, mesh, fsdp: bool = False) -> Dict[str, Spec]:
    """Spec by parameter name of an LM (Megatron, and ZeRO-3 with
    ``fsdp``); a layer's leaves are :class:`LayerSpec` objects."""
    dp = data_spec(mesh)
    return _tree_specs(model, lambda keys, shape: _lm_rule(keys, shape, mesh, fsdp, dp))


def pna_param_specs(model, mesh) -> Dict[str, Spec]:
    """Spec by parameter name of PNA (:func:`_generic_rule`)."""
    return _tree_specs(model, lambda keys, shape: _generic_rule(keys, shape, mesh))


def recsys_param_specs(model, mesh) -> Dict[str, Spec]:
    """Spec by parameter name of a recsys model: embedding tables split
    over ``model`` by vocab, towers column-parallel."""
    return _tree_specs(model, lambda keys, shape: _generic_rule(keys, shape, mesh))


def param_specs(model, mesh, fsdp: bool = False) -> Dict[str, Spec]:
    """The spec tree of ``model``'s family."""
    from repro_torch.models.pna import PNA
    from repro_torch.models.transformer import LM

    if isinstance(model, LM):
        return lm_param_specs(model, mesh, fsdp)
    if isinstance(model, PNA):
        return pna_param_specs(model, mesh)
    return recsys_param_specs(model, mesh)


def opt_state_specs(param_specs: Mapping[str, Spec]) -> dict:
    """AdamW state specs: the moments follow the parameters, the step is
    replicated.  The port's float32 masters (``launch.steps.TrainState``)
    follow the parameters too."""
    return {"mu": dict(param_specs), "nu": dict(param_specs), "step": ()}


def batch_specs(shapes: Mapping[str, Sequence[int]], mesh,
                field_rules: Optional[Mapping[str, Spec]] = None) -> Dict[str, Spec]:
    """Specs of a batch dict (field -> shape): the leading dim over the
    data axes unless ``field_rules`` names the field's spec."""
    dp = data_spec(mesh)
    out = {}
    for name, shape in shapes.items():
        rule = (field_rules or {}).get(name)
        if rule is None:
            rule = (dp,) if len(shape) else ()
        out[name] = validate_spec(mesh, rule, tuple(shape))
    return out


def cache_specs(cache, mesh) -> Dict[str, Optional[Spec]]:
    """Specs of a stacked KV cache's fields (``k``, ``v``, ``k_scale``,
    ``v_scale``; an absent int8 scale maps to None), the split-K decode's
    layout: the batch over the data axes and the sequence over ``model``
    where both divide; batch 1 (long context): the sequence over every
    axis; else replicated."""
    dp = data_spec(mesh)
    dp_size = axes_size(mesh, dp)
    model = int(mesh.shape["model"]) if "model" in mesh.axis_names else 1
    axes = tuple(mesh.axis_names)
    all_spec = axes if len(axes) > 1 else (axes[0] if axes else None)

    def one(t):
        if t is None:
            return None
        shape = tuple(t.shape)
        if len(shape) < 4:
            return ()
        b, s = shape[1], shape[2]  # (L, B, S, H[, D])
        if dp_size > 1 and b % dp_size == 0 and model > 1 and s % model == 0:
            b_spec, s_spec = dp, "model"
        elif b == 1 and s % (model * dp_size) == 0 and model * dp_size > 1:
            b_spec, s_spec = None, all_spec
        else:
            return validate_spec(mesh, (), shape)
        return validate_spec(mesh, (None, b_spec, s_spec) + (None,) * (len(shape) - 3), shape)

    return {f: one(getattr(cache, f)) for f in ("k", "v", "k_scale", "v_scale")}


def slot_coords(mesh) -> List[Dict[str, int]]:
    """Each slot's coordinate on every axis, in slot order (row-major)."""
    dims = tuple(int(mesh.shape[a]) for a in mesh.axis_names)
    return [dict(zip(mesh.axis_names, (int(c) for c in np.unravel_index(f, dims))))
            for f in range(math.prod(dims))]


def _entry_index(mesh, coords: Dict[str, int], entry) -> Tuple[int, int]:
    """(block index, block count) of a slot over one spec entry: its
    coordinates over the entry's axes, the first the most significant."""
    idx, size = 0, 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        n = int(mesh.shape[a])
        idx, size = idx * n + coords[a], size * n
    return idx, size


def layer_holders(spec, mesh) -> List[bool]:
    """Whether each slot (in slot order) holds the layer of a
    :class:`LayerSpec`: the slots whose block over the stacked axis's
    entry holds layer ``i``; every slot for a plain spec or an entry of
    None."""
    layer = getattr(spec, "layer", None)
    if layer is None or layer[0] is None:
        return [True] * len(slot_coords(mesh))
    entry, i, n_layers = layer
    out = []
    for coords in slot_coords(mesh):
        idx, size = _entry_index(mesh, coords, entry)
        out.append(i // (n_layers // size) == idx)
    return out


def shard_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """One slot's shape of a tensor of ``shape`` placed by ``spec``
    (``NamedSharding(mesh, P(*spec)).shard_shape``); a layer's tensor is
    whole on the slots that hold it."""
    out = list(shape)
    for d, entry in enumerate(tuple(spec)):
        if entry is not None:
            size = axes_size(mesh, entry)
            if out[d] % size:
                raise ValueError(f"{size} slots do not divide dim {d} of {tuple(shape)}")
            out[d] //= size
    return tuple(out)


def place(t: torch.Tensor, spec, mesh) -> List[Optional[torch.Tensor]]:
    """``t`` placed on ``mesh`` by ``spec``: one tensor a slot, in slot
    order, each that slot's block of every split dim (slices of ``t``: on
    one card, views, nothing copied).  Slots that ``spec`` replicates over
    get the same tensor.  A layer's tensor (:class:`LayerSpec`) is whole
    on the slots that hold its layer (:func:`layer_holders`) and None on
    the others.  Slots on another device than ``t`` get a copy placed
    there."""
    shard_shape(t.shape, spec, mesh)  # raises where the spec does not divide
    holders = layer_holders(spec, mesh)
    slots = list(mesh) if isinstance(mesh, tuple) else [None] * len(holders)
    cache: Dict[tuple, torch.Tensor] = {}
    out = []
    for coords, holds, slot in zip(slot_coords(mesh), holders, slots):
        if not holds:
            out.append(None)
            continue
        key = tuple(_entry_index(mesh, coords, e)[0] if e is not None else 0
                    for e in tuple(spec))
        if key not in cache:
            shard = t
            for d, (entry, idx) in enumerate(zip(tuple(spec), key)):
                if entry is not None:
                    n = t.shape[d] // axes_size(mesh, entry)
                    shard = shard.narrow(d, idx * n, n)
            cache[key] = shard
        shard = cache[key]
        dev = getattr(slot, "device", None)
        if dev is not None and torch.device(dev) != shard.device:
            shard = shard.to(dev)
        out.append(shard)
    return out


class CacheShard(NamedTuple):
    """Where one slot's part of a KV cache lies: batch rows
    ``[row0, row1)`` and positions ``[pos0, pos1)``."""

    slot: object
    row0: int
    row1: int
    pos0: int
    pos1: int


def shard_rows(n_rows: int, mesh) -> int:
    """Rows of padding needed to split ``n_rows`` evenly over the data
    axes of a ``SlotMesh``, or over the shards of a plain sequence."""
    if hasattr(mesh, "axis_names"):
        return (-n_rows) % max(axes_size(mesh, data_spec(mesh)), 1)
    return (-n_rows) % max(device_count(mesh), 1)


def device_count(mesh) -> int:
    """Slots of ``mesh`` (shards of a plain sequence)."""
    return len(mesh)
