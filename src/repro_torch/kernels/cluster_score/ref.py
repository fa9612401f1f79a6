"""Plain PyTorch version of the K-means δ⁺ scoring gather (the weighted
embedding-bag of ``repro.kernels.cluster_score.ref``).

Contract: ``ell`` (N, L) int32 holds per-document frequent-term ranks;
any slot outside ``[0, TC)`` is a pad and adds nothing, wherever it sits
in the row.  ``p`` (TC,) float32 are the term weights P[t]; ``tables``
(TC, K) float32 are the δ⁺ columns (or an embedding table).  Result
(N, K) float32:

    out[d, :] = Σ_l  p[ell[d, l]] · tables[ell[d, l], :]      (pad → 0)

Duplicate ranks in a row add once per slot.  The rows are taken in
blocks of ``block`` documents, so the gathered (block, L, K) intermediate
stays bounded: unblocked, the path's full size would need 4.7 GB at
K = 8 and 152 GB at K = 256.
"""

from __future__ import annotations

import torch

__all__ = ["cluster_scores_ref"]


def cluster_scores_ref(
    ell: torch.Tensor, p: torch.Tensor, tables: torch.Tensor, block: int = 1024
) -> torch.Tensor:
    n = ell.shape[0]
    tc, k = tables.shape
    out = torch.empty((n, k), dtype=torch.float32, device=ell.device)
    for lo in range(0, n, max(block, 1)):
        blk = ell[lo : lo + block]
        valid = (blk >= 0) & (blk < tc)
        safe = torch.where(valid, blk, 0).long()
        w = torch.where(valid, p[safe], 0.0)  # (B, L)
        out[lo : lo + block] = (w.unsqueeze(2) * tables[safe]).sum(dim=1)
    return out
