"""Public wrappers: cluster δ⁺ scoring and weighted embedding-bag.

A tensor that lies on the CPU takes the plain PyTorch version of
:mod:`repro_torch.kernels.cluster_score.ref`; a CUDA tensor launches the
hand-written kernel of :mod:`repro_torch.kernels.cluster_score.kernel`
or raises.  Nothing falls back from the card to the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.cluster_score.kernel import cluster_scores_cuda
from repro_torch.kernels.cluster_score.ref import cluster_scores_ref

__all__ = ["cluster_scores", "embedding_bag"]


def cluster_scores(ell, p, tables) -> torch.Tensor:
    """(N, K) δ⁺ scores from ELL doc-term ranks (pad = any slot outside
    ``[0, TC)``)."""
    ell = torch.as_tensor(ell, dtype=torch.int32).contiguous()
    p = torch.as_tensor(p, dtype=torch.float32).contiguous()
    tables = torch.as_tensor(tables, dtype=torch.float32).contiguous()
    if ell.is_cuda:
        return cluster_scores_cuda(ell, p, tables)
    return cluster_scores_ref(ell, p, tables)


def embedding_bag(ids, table, weights=None) -> torch.Tensor:
    """EmbeddingBag(sum) with optional per-sample weights: the same
    gather as ``cluster_scores`` with P folded to 1.  The weighted form is
    plain torch, as in the reference."""
    ids = torch.as_tensor(ids, dtype=torch.int32)
    table = torch.as_tensor(table, dtype=torch.float32)
    tc = table.shape[0]
    if weights is None:
        p = torch.ones(tc, dtype=torch.float32, device=table.device)
        return cluster_scores(ids, p, table)
    valid = (ids >= 0) & (ids < tc)
    safe = torch.where(valid, ids, 0).long()
    w = torch.where(valid, torch.as_tensor(weights, dtype=torch.float32), 0.0)
    return (w.unsqueeze(-1) * table[safe]).sum(dim=1)
