"""Sharded, atomic, resumable checkpoints (fault-tolerance substrate), the
port of ``repro.train.checkpoint``.

Layout:  <dir>/ckpt_<step>/          (atomically renamed from .tmp)
             meta.json               step, keys, dtypes, content hashes
             shard_<h>.npz           arrays for host-shard h

Guarantees:
  * atomicity — a checkpoint directory either has its final name and is
    complete (rename is atomic on POSIX) or is ignored;
  * integrity — per-array CRC recorded in meta.json, verified on load;
  * retention — keep_last newest checkpoints, older ones pruned (and
    stale ``.tmp`` directories of crashed saves);
  * resume — ``latest_step`` + ``restore`` rebuild (params, opt_state,
    pipeline_state) exactly; the data pipeline is counter-based so a
    restart replays/skips nothing.

A state is a tree of dicts, lists and tuples whose leaves are tensors,
numpy arrays or numbers; keys join with ``/`` (list items as ``[i]``), as
the reference names its pytree paths.  A tensor is copied to the host
explicitly (``.cpu()``); a bfloat16 tensor, which numpy has no dtype
for, is stored as its int16 bit pattern and recorded as ``bfloat16`` in
``meta.json``.  ``restore`` fills a template of the same structure:
tensor leaves come back as tensors of the template leaf's dtype on its
device, bit for bit; other leaves as the stored numpy arrays.

On a multi-host cluster each host would write its own shard file; one
process writes shard 0.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointManager"]


def _leaves(tree, prefix=()):
    """(path, leaf) pairs of a tree of dicts (keys sorted, as
    ``jax.tree_util`` orders them), lists and tuples."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, prefix + (f"[{i}]",))
    else:
        yield prefix, tree


def _key_str(path) -> str:
    return "/".join(path)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """The host array stored for a leaf, and its dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _crc(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3, host_id: int = 0):
        self.dir = directory
        self.keep_last = keep_last
        self.host_id = host_id
        os.makedirs(directory, exist_ok=True)

    # -- write ----------------------------------------------------------

    def save(self, step: int, state: dict) -> str:
        """state: a tree, e.g. {'params': ..., 'opt': ..., 'pipeline_step':
        int}. Returns the final checkpoint path."""
        final = os.path.join(self.dir, f"ckpt_{step:08d}")
        tmp = final + f".tmp{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        flat, dtypes = {}, {}
        for path, leaf in _leaves(state):
            key = _key_str(path)
            flat[key], dtypes[key] = _host(leaf)
        shard_file = os.path.join(tmp, f"shard_{self.host_id}.npz")
        np.savez(shard_file, **flat)
        meta = {
            "step": step,
            "keys": sorted(flat),
            "crc": {k: _crc(v) for k, v in flat.items()},
            "dtypes": dtypes,
            "shapes": {k: list(v.shape) for k, v in flat.items()},
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._prune()
        return final

    def _prune(self) -> None:
        done = sorted(self._complete())
        for step in done[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"ckpt_{step:08d}"))
        # drop stale tmp dirs (crashed saves)
        for name in os.listdir(self.dir):
            if ".tmp" in name:
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    # -- read -----------------------------------------------------------

    def _complete(self):
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("ckpt_") and ".tmp" not in name:
                if os.path.exists(os.path.join(self.dir, name, "meta.json")):
                    steps.append(int(name.split("_")[1]))
        return steps

    def latest_step(self) -> Optional[int]:
        done = self._complete()
        return max(done) if done else None

    def restore(self, template: Any, step: Optional[int] = None) -> Tuple[int, Any]:
        """Restore into the structure of ``template``. Returns (step,
        state): tensor leaves as tensors of the template leaf's dtype on
        its device, other leaves as numpy arrays."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"ckpt_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        data = {}
        for name in os.listdir(path):
            if name.startswith("shard_") and name.endswith(".npz"):
                with np.load(os.path.join(path, name)) as z:
                    for k in z.files:
                        data[k] = z[k]
        # integrity check
        for k, v in data.items():
            if meta["crc"].get(k) != _crc(v):
                raise IOError(f"checkpoint corruption at key {k}")

        def fill(tree, prefix):
            if isinstance(tree, dict):
                return {k: fill(tree[k], prefix + (str(k),)) for k in tree}
            if isinstance(tree, (list, tuple)):
                return type(tree)(fill(x, prefix + (f"[{i}]",)) for i, x in enumerate(tree))
            k = _key_str(prefix)
            if k not in data:
                raise KeyError(f"checkpoint missing key {k}")
            v = data[k]
            want_shape = tuple(tree.shape) if hasattr(tree, "shape") else ()
            if tuple(v.shape) != want_shape:
                raise ValueError(
                    f"shape mismatch for {k}: ckpt {v.shape} vs template {want_shape}")
            if not isinstance(tree, torch.Tensor):
                return v
            t = torch.from_numpy(np.array(v))  # a writable copy; keeps a 0-dim shape
            if meta["dtypes"].get(k) == "bfloat16":
                t = t.view(torch.bfloat16)
            return t.to(dtype=tree.dtype, device=tree.device)

        return step, fill(template, ())
