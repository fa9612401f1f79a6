"""Device (PyTorch) versions of the clustering hot ops.

The host driver (kmeans.py) uses numpy/scipy — right for a recursion-heavy
CPU workload.  These tensor equivalents are the device path: they are used
by the distributed clustering implementation
(``repro_torch.dist.cluster_dist``, documents split into row shards,
counts summed — the paper's §3.2 parallelization sketch) and are
cross-validated against the numpy implementations and the JAX package's
``jax_ops`` in tests.  Each function is named after its counterpart there.

Layouts are fixed-shape: documents are ELL-padded to ``L_pad`` frequent
terms (rank = TC means "empty slot"), which is what the row shards and the
CUDA ``cluster_score`` kernel consume.  Tables are (k, tc) here, as in the
reference; the kernel takes them transposed, (TC, K).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.objective import FrequentTermView
from repro_torch.kernels.cluster_score.ops import cluster_scores
from repro_torch.kernels.cluster_score.ref import cluster_scores_ref

__all__ = [
    "ell_pack",
    "counts_from_ell",
    "psi_torch",
    "delta_add_tables_torch",
    "scores_from_ell",
    "kmeans_round_torch",
]


def ell_pack(view: FrequentTermView, l_pad: int | None = None) -> Tuple[np.ndarray, int]:
    """Pack a FrequentTermView into an ELL (n_docs, L_pad) rank matrix.

    Pad slots hold ``tc`` (one-past-last rank). Documents with more than
    L_pad frequent terms keep their L_pad highest-P ones (ranks are sorted
    by P, so the smallest ranks win; truncation is logged by the caller).
    """
    lens = np.diff(view.mat.indptr)
    if l_pad is None:
        l_pad = int(lens.max()) if len(lens) else 1
    n = view.n_docs
    out = np.full((n, l_pad), view.tc, dtype=np.int32)
    indptr, indices = view.mat.indptr, view.mat.indices
    for d in range(n):
        lo, hi = indptr[d], indptr[d + 1]
        ranks = np.sort(indices[lo:hi])[:l_pad]  # keep highest-P (lowest rank)
        out[d, : len(ranks)] = ranks
    return out, l_pad


def counts_from_ell(ell: torch.Tensor, assign: torch.Tensor, k: int, tc: int) -> torch.Tensor:
    """(k, tc) int32 n_j(t) from ELL doc-rank matrix + assignment: one
    integer bincount over ``assign·(tc+1) + rank`` (pads land in the
    dropped column ``tc``), exact in any order."""
    valid = ell < tc
    key = assign.long().unsqueeze(1) * (tc + 1) + torch.where(valid, ell, tc).long()
    flat = torch.bincount(key.reshape(-1), minlength=k * (tc + 1))
    return flat[: k * (tc + 1)].reshape(k, tc + 1)[:, :tc].to(torch.int32)


def _sorted_suffix(counts: torch.Tensor, p: torch.Tensor):
    """Each cluster's counts sorted (stable), P in that order, and the
    inclusive suffix sums of P along it."""
    n_sorted, order = torch.sort(counts, dim=1, stable=True)
    p_sorted = p[order]
    suffix_incl = torch.flip(torch.cumsum(torch.flip(p_sorted, [1]), dim=1), [1])
    return n_sorted, p_sorted, suffix_incl


def psi_torch(counts: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Device ψ — same O(k·TC log TC) sort + suffix-sum as the host version."""
    n_sorted, p_sorted, suffix_incl = _sorted_suffix(counts, p)
    suffix_excl = suffix_incl - p_sorted
    return (p_sorted * n_sorted.to(torch.float32) * suffix_excl).sum()


def delta_add_tables_torch(counts: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """S⁺[j, t] = Σ_{u: n_j(u) > n_j(t)} P_u, batched over clusters."""
    n_sorted, _, suffix_incl = _sorted_suffix(counts, p)
    suffix_pad = torch.cat([suffix_incl, suffix_incl.new_zeros((counts.shape[0], 1))], dim=1)
    idx = torch.searchsorted(n_sorted.contiguous(), counts.contiguous(), right=True)
    return torch.gather(suffix_pad, 1, idx)


def scores_from_ell(
    ell: torch.Tensor, tables: torch.Tensor, p: torch.Tensor, block: int = 4096
) -> torch.Tensor:
    """(n_docs, k) δ⁺ scores from the ELL layout and (k, tc) tables.

    On a CUDA tensor this is one launch of the ``cluster_score`` kernel
    (which takes the tables as (TC, K)); on the CPU the plain version
    gathers ``block`` documents at a time.
    """
    p = p.to(torch.float32)
    if ell.is_cuda:
        return cluster_scores(ell, p, tables.T.contiguous())
    return cluster_scores_ref(ell, p, tables.T, block=block)


def kmeans_round_torch(
    ell: torch.Tensor,
    assign: torch.Tensor,
    p: torch.Tensor,
    k: int,
    tc: int,
    block: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One full round-based K-means iteration on device.

    Returns (new_assign, psi_before). Composes: counts → ψ → δ⁺ tables →
    scores → argmin (the first minimum on ties, as ``jnp.argmin``).
    """
    p = p.to(torch.float32)
    counts = counts_from_ell(ell, assign, k, tc)
    psi = psi_torch(counts, p)
    tables = delta_add_tables_torch(counts, p)
    scores = scores_from_ell(ell, tables, p, block=block)
    return torch.argmin(scores, dim=1).to(torch.int32), psi
