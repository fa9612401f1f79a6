"""Error-feedback int8 gradient compression and the compressed all-reduce,
the port of ``repro.dist.compression``.

Gradients cross the slowest links of a mesh, so an int8 wire format with
error feedback cuts the all-reduce's bytes 4x at no asymptotic loss:

    v_t   = g_t + e_{t-1}          (fold in what was dropped before)
    q_t   = Q(v_t)                 (symmetric int8, one scale a tensor)
    e_t   = v_t - deq(q_t)         (what this step drops)

so the transmitted signal sums to Σ g_t - e_T: nothing is lost for good
(``deq + e_t == v_t`` holds exactly in float32, and ``|e_t| <= scale/2``).

The port has no collective of its own on one card: a data axis is a list
of per-slot gradient trees (one tree a slot, in slot order), and
:func:`compressed_psum_tree` computes what the reference's computes inside
``shard_map`` over that axis — each leaf's scale the maximum over the
slots (``pmax``), the slots' int8 codes added as int32 in slot order
(``psum``; the wire is int8, the sum must not saturate), times the scale.
With one slot (the reference's ``axis_name=None``) it is the local
quantize/dequantize round trip.

The scale is ``amax / 127`` by a division.  On a CUDA tensor PyTorch may
compute a division by a scalar as a multiply by its reciprocal, as XLA
does under ``jax.jit`` (the int8 KV cache's quantizer showed it), so a
scale on the card can be 1 ulp from the CPU's; the invariants above hold
either way, since each slot's error is formed from its own scale.

A tree is a tensor, or dicts and lists of trees.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

__all__ = ["compress_decompress", "init_error_state", "compressed_psum_tree"]


def _flatten(tree) -> Tuple[List[torch.Tensor], Any]:
    """The tensors of ``tree`` in order (dict keys sorted, as jax flattens
    a dict) and the tree's structure for :func:`_unflatten`."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return [t for p in parts for t in p[0]], ("dict", keys, [p[1] for p in parts])
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        return [t for p in parts for t in p[0]], (type(tree), None, [p[1] for p in parts])
    return [tree], None


def _unflatten(struct, leaves: List[torch.Tensor]):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, keys, subs = s
        if kind == "dict":
            return {k: build(sub) for k, sub in zip(keys, subs)}
        return kind(build(sub) for sub in subs)

    return build(struct)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127`` where ``amax > 0``, else 1: one scale a tensor."""
    return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))


def _codes(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``v`` on the int8 grid of ``scale``: rounded half to even, clipped
    to +-127."""
    return torch.clamp(torch.round(v / scale), -127.0, 127.0).to(torch.int8)


def compress_decompress(x: torch.Tensor, err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback round trip of one tensor: ``(deq, new_err)`` with
    ``deq + new_err == x + err`` exactly in float32."""
    v = x.float() + err.float()
    scale = _scale(v.abs().max())
    deq = _codes(v, scale).float() * scale
    return deq, v - deq


def init_error_state(grads):
    """Zero float32 error-feedback state shaped as a gradient tree (or as
    each tree of a list of per-slot trees)."""
    leaves, struct = _flatten(grads)
    return _unflatten(struct, [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                               for g in leaves])


def compressed_psum_tree(grads: Sequence, err: Sequence) -> Tuple[Any, List]:
    """The compressed all-reduce over a data axis of ``len(grads)`` slots:
    ``grads`` and ``err`` hold one tree a slot, in slot order.  Returns
    ``(total, new_err)``: ``total`` the one tree every slot receives (the
    *sum* over the slots; divide by their count for a mean), ``new_err``
    each slot's own error-feedback state.  The sum is formed on the first
    slot's device."""
    if not grads or len(grads) != len(err):
        raise ValueError(f"{len(grads)} gradient trees for {len(err)} error states")
    flat = [_flatten(g) for g in grads]
    struct = flat[0][1]
    leaves_g = [f[0] for f in flat]
    leaves_e = [_flatten(e)[0] for e in err]
    if any(len(g) != len(leaves_g[0]) or len(e) != len(g) for g, e in zip(leaves_g, leaves_e)):
        raise ValueError("the slots' gradient and error trees differ in their leaves")
    home = leaves_g[0][0].device if leaves_g[0] else None
    totals, new_errs = [], [[] for _ in grads]
    for j in range(len(leaves_g[0])):
        vs = [g[j].float() + e[j].float() for g, e in zip(leaves_g, leaves_e)]
        amax = vs[0].abs().max().to(home)
        for v in vs[1:]:  # pmax over the slots
            amax = torch.maximum(amax, v.abs().max().to(home))
        shared = _scale(amax)
        total = None
        for s, v in enumerate(vs):
            scale = shared.to(v.device)
            q = _codes(v, scale)
            new_errs[s].append(v - q.float() * scale)
            q32 = q.to(torch.int32).to(home)
            total = q32 if total is None else total + q32  # psum, in slot order
        totals.append(total.float() * shared)
    return _unflatten(struct, totals), [_unflatten(struct, e) for e in new_errs]
