"""Carry a parameter tree of the JAX package's LM (``repro.models.
transformer.init``) across to the port's :class:`~repro_torch.models.
transformer.LM` (:func:`params_from_numpy`), and one of its recsys models
(``repro.models.recsys.*.init``) across to the port's modules
(:func:`recsys_from_numpy`).

The tree comes as nested dicts of numpy arrays (``jax.tree.map(np.asarray,
params)``), with the layers stacked on a leading axis as the JAX package
keeps them (an MoE layer's router and experts under ``layers["moe"]``,
Arctic's dense FFN beside them under ``layers["mlp"]``).  Each weight is
stored in the dtype in which the JAX code uses it: dense kernels, experts,
biases, the embedding and the head in the activation dtype (the JAX
``dense``, ``moe_apply`` and ``_head`` cast them on every call), norm
scales in float32 (``rms_norm`` computes in float32).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.device_engine import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.recsys.bert4rec import BERT4Rec
from repro_torch.models.recsys.dcnv2 import DCNv2
from repro_torch.models.recsys.dien import DIEN
from repro_torch.models.recsys.mind import MIND
from repro_torch.models.transformer import LM, LMConfig

__all__ = ["params_from_numpy", "recsys_from_numpy"]


def _put(dst: torch.Tensor, src) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {src.shape} does not fit {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))


def _put_dense(dense: L.Dense, tree: Mapping, i: int) -> None:
    _put(dense.kernel, tree["kernel"][i])
    if ("bias" in tree) != (dense.bias is not None):
        raise ValueError("the tree's biases do not match the config's qkv_bias")
    if dense.bias is not None:
        _put(dense.bias, tree["bias"][i])


def params_from_numpy(tree: Mapping, cfg: LMConfig, device=None) -> LM:
    """The port's model holding the weights of ``tree``.  ``device``
    defaults to ``cuda`` and raises without a GPU."""
    model = LM(cfg, resolve_device(device))
    _put(model.embed, tree["embed"])
    _put(model.final_norm, tree["final_norm"])
    if model.lm_head is not None:
        _put(model.lm_head, tree["lm_head"])
    layers = tree["layers"]
    for i, blk in enumerate(model.blocks):
        _put(blk.attn_norm, layers["attn_norm"][i])
        _put(blk.ffn_norm, layers["ffn_norm"][i])
        attn = layers["attn"]
        for name in ("q", "k", "v", "o"):
            _put_dense(getattr(blk.attn, name), attn[name], i)
        if blk.attn.q_norm is not None:
            _put(blk.attn.q_norm, attn["q_norm"][i])
            _put(blk.attn.k_norm, attn["k_norm"][i])
        if blk.moe is not None:
            moe = layers["moe"]
            _put_dense(blk.moe.router, moe["router"], i)
            for name in ("up", "gate", "down"):
                _put(getattr(blk.moe, name), moe[name][i])
        if blk.mlp is not None:
            for name in ("up", "down", "gate"):
                _put_dense(getattr(blk.mlp, name), layers["mlp"][name], i)
    return model


_RECSYS = {"dien": DIEN, "mind": MIND, "dcn-v2": DCNv2, "bert4rec": BERT4Rec}


def _put_tower(tower, layers) -> None:
    if len(layers) != len(tower.layers):
        raise ValueError(f"{len(layers)} tower layers do not fit {len(tower.layers)}")
    for dense, p in zip(tower.layers, layers):
        _put(dense.kernel, p["kernel"])
        _put(dense.bias, p["bias"])


def _put_gru(gru, tree: Mapping) -> None:
    for gate in ("z", "r", "h"):
        for name in ("wx", "wh", "b"):
            _put(getattr(getattr(gru, gate), name), tree[gate][name])


def recsys_from_numpy(tree: Mapping, name: str, cfg, device=None):
    """The port's recsys model ``name`` (dien, mind, dcn-v2, bert4rec)
    holding the weights of ``tree``, the JAX ``init``'s tree as numpy
    arrays (MLP towers as lists of ``{"kernel", "bias"}``, DCN-v2's
    cross layers and BERT4Rec's blocks stacked on a leading axis).
    ``device`` defaults to ``cuda`` and raises without a GPU."""
    model = _RECSYS[name](cfg, resolve_device(device))
    if name == "dien":
        _put(model.item_embed, tree["item_embed"])
        _put_gru(model.gru, tree["gru"])
        _put(model.att.kernel, tree["att"]["kernel"])
        _put_gru(model.augru, tree["augru"])
        _put_tower(model.mlp, tree["mlp"])
    elif name == "mind":
        _put(model.item_embed, tree["item_embed"])
        _put(model.bilinear, tree["bilinear"])
        _put_tower(model.mlp, tree["mlp"])
    elif name == "dcn-v2":
        _put(model.tables, tree["tables"])
        _put(model.cross_kernel, tree["cross"]["kernel"])
        _put(model.cross_bias, tree["cross"]["bias"])
        _put_tower(model.deep, tree["deep"])
        _put(model.head.kernel, tree["head"]["kernel"])
        _put(model.head.bias, tree["head"]["bias"])
    else:
        _put(model.item_embed, tree["item_embed"])
        _put(model.pos_embed, tree["pos_embed"])
        _put(model.final_norm, tree["final_norm"])
        blocks = tree["blocks"]
        for i, blk in enumerate(model.blocks):
            _put(blk.attn_norm, blocks["attn_norm"][i])
            _put(blk.ffn_norm, blocks["ffn_norm"][i])
            for proj in ("q", "k", "v", "o"):
                _put_dense(getattr(blk.attn, proj), blocks["attn"][proj], i)
            for proj in ("up", "down"):
                _put_dense(getattr(blk.mlp, proj), blocks["mlp"][proj], i)
    return model
