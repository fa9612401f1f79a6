"""Carry a parameter tree of the JAX package's LM (``repro.models.
transformer.init``) across to the port's :class:`~repro_torch.models.
transformer.LM` (:func:`params_from_numpy`), and one of its recsys models
(``repro.models.recsys.*.init``) across to the port's modules
(:func:`recsys_from_numpy`), and one of PNA (``repro.models.pna.init``)
across to :class:`~repro_torch.models.pna.PNA` (:func:`pna_from_numpy`);
and back (:func:`params_to_numpy`, for the
model's weights or for any tensors keyed by its parameter names, such as
their gradients), with the optimizer state (:func:`opt_state_from_numpy`).

The tree comes as nested dicts of numpy arrays (``jax.tree.map(np.asarray,
params)``), with the layers stacked on a leading axis as the JAX package
keeps them (an MoE layer's router and experts under ``layers["moe"]``,
Arctic's dense FFN beside them under ``layers["mlp"]``; MLP towers as
lists of ``{"kernel", "bias"}``).  Each weight is stored in the dtype in
which the JAX code uses it: dense kernels, experts, biases, the embedding
and the head in the activation dtype (the JAX ``dense``, ``moe_apply`` and
``_head`` cast them on every call), norm scales in float32 (``rms_norm``
computes in float32).  One table, :func:`_leaves`, pairs every leaf of the
tree with the port's tensor, both ways.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device_engine import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.pna import PNA, PNAConfig
from repro_torch.models.recsys.bert4rec import BERT4Rec
from repro_torch.models.recsys.dcnv2 import DCNv2
from repro_torch.models.recsys.dien import DIEN
from repro_torch.models.recsys.mind import MIND
from repro_torch.models.transformer import LM, LMConfig

__all__ = ["opt_state_from_numpy", "params_from_numpy", "params_to_numpy", "pna_from_numpy",
           "recsys_from_numpy"]

# (path in the tree, index on the stacked layer axis or None, the port's tensor)
Leaf = Tuple[tuple, Optional[int], torch.Tensor]


def _dense(path: tuple, dense: L.Dense, i: Optional[int]) -> List[Leaf]:
    out = [(path + ("kernel",), i, dense.kernel)]
    if dense.bias is not None:
        out.append((path + ("bias",), i, dense.bias))
    return out


def _lm_leaves(model: LM) -> List[Leaf]:
    out = [(("embed",), None, model.embed), (("final_norm",), None, model.final_norm)]
    if model.lm_head is not None:
        out.append((("lm_head",), None, model.lm_head))
    for i, blk in enumerate(model.blocks):
        lay = ("layers",)
        out += [(lay + ("attn_norm",), i, blk.attn_norm), (lay + ("ffn_norm",), i, blk.ffn_norm)]
        for name in ("q", "k", "v", "o"):
            out += _dense(lay + ("attn", name), getattr(blk.attn, name), i)
        if blk.attn.q_norm is not None:
            out += [(lay + ("attn", "q_norm"), i, blk.attn.q_norm),
                    (lay + ("attn", "k_norm"), i, blk.attn.k_norm)]
        if blk.moe is not None:
            out += _dense(lay + ("moe", "router"), blk.moe.router, i)
            out += [(lay + ("moe", name), i, getattr(blk.moe, name))
                    for name in ("up", "gate", "down")]
        if blk.mlp is not None:
            out += [leaf for name in ("up", "down", "gate")
                    for leaf in _dense(lay + ("mlp", name), getattr(blk.mlp, name), i)]
    return out


def _tower(path: tuple, tower) -> List[Leaf]:
    return [leaf for j, dense in enumerate(tower.layers) for leaf in _dense(path + (j,), dense, None)]


def _gru(path: tuple, gru) -> List[Leaf]:
    return [(path + (gate, name), None, getattr(getattr(gru, gate), name))
            for gate in ("z", "r", "h") for name in ("wx", "wh", "b")]


def _recsys_leaves(model) -> List[Leaf]:
    if isinstance(model, DIEN):
        return ([(("item_embed",), None, model.item_embed)] + _gru(("gru",), model.gru)
                + [(("att", "kernel"), None, model.att.kernel)] + _gru(("augru",), model.augru)
                + _tower(("mlp",), model.mlp))
    if isinstance(model, MIND):
        return ([(("item_embed",), None, model.item_embed), (("bilinear",), None, model.bilinear)]
                + _tower(("mlp",), model.mlp))
    if isinstance(model, DCNv2):
        return ([(("tables",), None, model.tables), (("cross", "kernel"), None, model.cross_kernel),
                 (("cross", "bias"), None, model.cross_bias)] + _tower(("deep",), model.deep)
                + _dense(("head",), model.head, None))
    out = [(("item_embed",), None, model.item_embed), (("pos_embed",), None, model.pos_embed),
           (("final_norm",), None, model.final_norm)]
    for i, blk in enumerate(model.blocks):
        b = ("blocks",)
        out += [(b + ("attn_norm",), i, blk.attn_norm), (b + ("ffn_norm",), i, blk.ffn_norm)]
        for proj in ("q", "k", "v", "o"):
            out += _dense(b + ("attn", proj), getattr(blk.attn, proj), i)
        for proj in ("up", "down"):
            out += _dense(b + ("mlp", proj), getattr(blk.mlp, proj), i)
    return out


def _pna_leaves(model: PNA) -> List[Leaf]:
    out = _dense(("encode",), model.encode, None) + _dense(("decode",), model.decode, None)
    for i, layer in enumerate(model.layers):
        lay = ("layers",)
        for name in ("w_src", "w_dst", "w_out"):
            out += _dense(lay + (name,), getattr(layer, name), i)
        out.append((lay + ("norm",), i, layer.norm))
    return out


def _leaves(model) -> List[Leaf]:
    """Every leaf of the JAX tree of ``model``'s arch, paired with the
    port's tensor that holds it."""
    if isinstance(model, LM):
        return _lm_leaves(model)
    if isinstance(model, PNA):
        return _pna_leaves(model)
    return _recsys_leaves(model)


def _get(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _tree_paths(tree, prefix=()) -> set:
    if isinstance(tree, Mapping):
        return set().union(*(_tree_paths(v, prefix + (k,)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return set().union(*(_tree_paths(v, prefix + (j,)) for j, v in enumerate(tree)))
    return {prefix}


def _put(dst: torch.Tensor, src) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {src.shape} does not fit {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))


def _load(model, tree: Mapping):
    leaves = _leaves(model)
    want = {path for path, _, _ in leaves}
    have = _tree_paths(tree)
    if want != have:
        raise ValueError(f"the tree's leaves do not match the model's (config's biases, norms "
                         f"or experts): missing {sorted(map(str, want - have))}, extra "
                         f"{sorted(map(str, have - want))}")
    for path, i, dst in leaves:
        src = _get(tree, path)
        _put(dst, src if i is None else src[i])
    return model


def params_from_numpy(tree: Mapping, cfg: LMConfig, device=None) -> LM:
    """The port's model holding the weights of ``tree``.  ``device``
    defaults to ``cuda`` and raises without a GPU."""
    return _load(LM(cfg, resolve_device(device)), tree)


_RECSYS = {"dien": DIEN, "mind": MIND, "dcn-v2": DCNv2, "bert4rec": BERT4Rec}


def recsys_from_numpy(tree: Mapping, name: str, cfg, device=None):
    """The port's recsys model ``name`` (dien, mind, dcn-v2, bert4rec)
    holding the weights of ``tree``, the JAX ``init``'s tree as numpy
    arrays (MLP towers as lists of ``{"kernel", "bias"}``, DCN-v2's
    cross layers and BERT4Rec's blocks stacked on a leading axis).
    ``device`` defaults to ``cuda`` and raises without a GPU."""
    return _load(_RECSYS[name](cfg, resolve_device(device)), tree)


def pna_from_numpy(tree: Mapping, cfg: PNAConfig, device=None) -> PNA:
    """The port's PNA holding the weights of ``tree``, the JAX ``init``'s
    tree as numpy arrays (its layers stacked on a leading axis, as
    ``jax.vmap`` made them).  ``device`` defaults to ``cuda`` and raises
    without a GPU."""
    return _load(PNA(cfg, resolve_device(device)), tree)


def _set(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _lists(tree):
    """Dicts keyed 0 .. n-1 (MLP towers) as lists."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v) for k, v in tree.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[j] for j in range(len(out))]
    return out


def params_to_numpy(model, values: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
    """The inverse of :func:`params_from_numpy` / :func:`recsys_from_numpy`
    / :func:`pna_from_numpy`:
    the JAX tree of ``model``'s arch as float32 numpy arrays, layers
    stacked, filled from the model's weights or from ``values`` (tensors
    keyed by the model's parameter names, e.g. their gradients)."""
    names = {id(p): n for n, p in model.named_parameters()}
    stacks: Dict[tuple, Dict[int, np.ndarray]] = {}
    tree: dict = {}
    for path, i, t in _leaves(model):
        if values is not None:
            t = values[names[id(t)]]
        a = t.detach().float().cpu().numpy()
        if i is None:
            _set(tree, path, a)
        else:
            stacks.setdefault(path, {})[i] = a
    for path, by_layer in stacks.items():
        _set(tree, path, np.stack([by_layer[i] for i in range(len(by_layer))]))
    return _lists(tree)


def opt_state_from_numpy(state, opt_tree: Mapping, model) -> None:
    """Carry the JAX ``adamw_init``/``adamw_update`` state ``opt_tree``
    (``mu`` and ``nu`` trees shaped like the params, ``step``) as numpy
    arrays into ``state`` (a :class:`repro_torch.launch.steps.TrainState`
    of ``model``), in place."""
    names = {id(p): n for n, p in model.named_parameters()}
    with torch.no_grad():
        for key in ("mu", "nu"):
            for path, i, t in _leaves(model):
                src = np.asarray(_get(opt_tree[key], path))
                dst = state.opt[key][names[id(t)]]
                dst.copy_(torch.from_numpy(np.array(src if i is None else src[i],
                                                    dtype=np.float32)))
        state.opt["step"] = torch.tensor(int(np.asarray(opt_tree["step"])), dtype=torch.int32,
                                         device=state.opt["step"].device)
