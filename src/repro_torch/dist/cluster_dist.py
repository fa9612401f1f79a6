"""Row-sharded SeCluD K-means: the paper's §3.2 parallelization sketch
(documents sharded, counts replicated) over a list of torch devices.

Each shard holds a contiguous row block of the ELL-packed frequent-term
view on its device.  One round is:

  local counts  →  sum of the integer count vectors  →  ψ + δ⁺ tables
  (computed once, on the first device, from the summed counts — they are
  (k, TC), tiny next to the docs)  →  local scores  →  local argmin.

The same device may appear more than once: on one GPU, S shards share
``cuda:0``.  The split is the reference's ``P(dp)`` split, so the
assignment does not depend on the number of shards.

The host drives rounds exactly like ``repro_torch.core.kmeans.kmeans``:
accept a round iff ψ improved, stop below the 1 % relative-improvement
threshold (paper §4), reseed empty clusters from the largest one.

``distributed_kmeans_fn`` adapts this to the ``kmeans(view, k, ...)``
signature so ``multilevel_cluster`` / ``topdown_cluster`` can run their
large levels on the devices and their small recursion leaves on the host
(document-grained mode, which is inherently sequential).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device_engine import resolve_device
from repro_torch.core.kmeans import KMeansResult, kmeans
from repro_torch.core.objective import FrequentTermView, cluster_counts, psi_from_counts
from repro_torch.core.torch_ops import (
    counts_from_ell,
    delta_add_tables_torch,
    ell_pack,
    psi_torch,
    scores_from_ell,
)

__all__ = ["distributed_kmeans", "distributed_kmeans_fn", "make_round_fn"]


def _resolve_devices(devices: Optional[Sequence]) -> List[torch.device]:
    """``[cuda]`` by default (raises without a GPU); every entry through
    :func:`repro_torch.core.device_engine.resolve_device`."""
    if devices is None:
        return [resolve_device(None)]
    resolved = [resolve_device(d) for d in devices]
    if not resolved:
        raise ValueError("devices must name at least one device")
    return resolved


def make_round_fn(devices: Sequence[torch.device], k: int, tc: int, block: int = 512) -> Callable:
    """One round over ``len(devices)`` row shards:
    ``(ell_shards, assign_shards, p_shards) -> (assign_shards', ψ)``.

    Shard ``i`` lives on ``devices[i]``; the new assignment comes back
    shard by shard on the same devices (int32), ψ as a 0-d tensor on
    ``devices[0]``.
    """
    home = devices[0]

    def round_fn(ell_shards, assign_shards, p_shards):
        counts = torch.zeros((k, tc), dtype=torch.int32, device=home)
        for ell_loc, assign_loc in zip(ell_shards, assign_shards, strict=True):
            counts += counts_from_ell(ell_loc, assign_loc, k, tc).to(home)
        psi = psi_torch(counts, p_shards[0])
        tables = delta_add_tables_torch(counts, p_shards[0])
        new_shards = []
        for ell_loc, p_loc in zip(ell_shards, p_shards, strict=True):
            scores = scores_from_ell(ell_loc, tables.to(ell_loc.device), p_loc, block=block)
            new_shards.append(torch.argmin(scores, dim=1).to(torch.int32))
        return new_shards, psi

    return round_fn


def _reseed_empty_random(
    assign: np.ndarray, k: int, rng: np.random.Generator
) -> np.ndarray:
    """Give each empty cluster one document from the largest cluster."""
    sizes = np.bincount(assign, minlength=k)
    for j in np.flatnonzero(sizes == 0):
        donor = int(np.argmax(sizes))
        cand = np.flatnonzero(assign == donor)
        if len(cand) <= 1:
            break
        d = rng.choice(cand)
        assign[d] = j
        sizes[donor] -= 1
        sizes[j] += 1
    return assign


def distributed_kmeans(
    view: FrequentTermView,
    k: int,
    devices: Optional[Sequence] = None,
    init_assign: Optional[np.ndarray] = None,
    max_iters: int = 50,
    min_rel_improvement: float = 0.01,
    seed: int = 0,
    block: int = 512,
    l_pad: Optional[int] = None,
) -> Tuple[np.ndarray, float]:
    """Round-based K-means on the ψ objective, documents split into one
    row shard per entry of ``devices`` (default ``[cuda]``).  Returns
    ``(assign, psi)`` — ψ as reported by the device round *before* the
    last accepted move (same convention as the host driver's history)."""
    assign, psi_dev, _ = _run_rounds(
        view, k, _resolve_devices(devices), init_assign, max_iters,
        min_rel_improvement, seed, block, l_pad,
    )
    return assign, psi_dev


def _run_rounds(
    view: FrequentTermView,
    k: int,
    devices: List[torch.device],
    init_assign: Optional[np.ndarray],
    max_iters: int,
    min_rel_improvement: float,
    seed: int,
    block: int,
    l_pad: Optional[int],
) -> Tuple[np.ndarray, float, list]:
    """(assign, device ψ, host ψ history — one entry per accepted round)."""
    n = view.n_docs
    ell, _ = ell_pack(view, l_pad)
    n_shards = len(devices)
    pad = (-n) % n_shards
    if pad:
        # Padding documents carry only pad slots (rank == tc): they add
        # nothing to any cluster's counts, so their assignment is inert.
        ell = np.concatenate(
            [ell, np.full((pad, ell.shape[1]), view.tc, ell.dtype)]
        )
    p32 = np.asarray(view.p_freq, np.float32)
    rows = (n + pad) // n_shards

    def split(a: np.ndarray) -> List[torch.Tensor]:
        """Row shard ``i`` of ``a`` on ``devices[i]``."""
        return [torch.from_numpy(a[i * rows : (i + 1) * rows]).to(dev)
                for i, dev in enumerate(devices)]

    rng = np.random.default_rng(seed)
    if init_assign is None:
        assign = (rng.permutation(n + pad) % k).astype(np.int32)
    else:
        assign = np.concatenate(
            [np.asarray(init_assign, np.int32), np.zeros(pad, np.int32)]
        )

    round_fn = make_round_fn(devices, k, view.tc, block=block)
    psi = psi_from_counts(cluster_counts(view, assign[:n].astype(np.int64), k), view.p_freq)
    psi_dev = float(psi)
    history = [psi]
    # The corpus and P never change across rounds — upload once.
    ell_shards = split(ell)
    p_shards = [torch.from_numpy(p32).to(dev) for dev in devices]
    for _ in range(max_iters):
        new_shards, psi_round = round_fn(ell_shards, split(assign), p_shards)
        new_assign = torch.cat([s.cpu() for s in new_shards]).numpy()
        new_assign[:n] = _reseed_empty_random(new_assign[:n], k, rng)
        psi_new = psi_from_counts(
            cluster_counts(view, new_assign[:n].astype(np.int64), k), view.p_freq
        )
        if psi_new >= psi * (1.0 - 1e-12):
            break
        improved = (psi - psi_new) / max(psi, 1e-30)
        assign, psi, psi_dev = new_assign, psi_new, float(psi_round)
        history.append(psi)
        if improved < min_rel_improvement:
            break
    return assign[:n].astype(np.int64), psi_dev, history


def distributed_kmeans_fn(
    devices: Optional[Sequence] = None,
    doc_grained_below: int = 2_048,
    block: int = 512,
) -> Callable[..., KMeansResult]:
    """A drop-in ``kmeans_fn`` for ``multilevel_cluster``/``topdown_cluster``:
    large levels run as row shards on ``devices`` (default ``[cuda]``,
    which raises when there is no GPU), small ones on the host (the
    document-grained mode is sequential by construction)."""
    devices = _resolve_devices(devices)

    def fn(
        view: FrequentTermView,
        k: int,
        init_assign: Optional[np.ndarray] = None,
        max_iters: int = 100,
        min_rel_improvement: float = 0.01,
        doc_grained_below: int = doc_grained_below,
        seed: int = 0,
    ) -> KMeansResult:
        if view.n_docs < doc_grained_below:
            return kmeans(
                view, k, init_assign=init_assign, max_iters=max_iters,
                min_rel_improvement=min_rel_improvement,
                doc_grained_below=doc_grained_below, seed=seed,
            )
        assign, _, history = _run_rounds(
            view, k, devices, init_assign, max_iters, min_rel_improvement,
            seed, block, None,
        )
        return KMeansResult(
            assign=assign, psi=history[-1], n_iters=len(history) - 1,
            psi_history=history,
        )

    return fn
