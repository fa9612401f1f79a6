"""Carry a parameter tree of the JAX package's LM (``repro.models.
transformer.init``) across to the port's :class:`~repro_torch.models.
transformer.LM`.

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
from repro_torch.models.transformer import LM, LMConfig

__all__ = ["params_from_numpy"]


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
