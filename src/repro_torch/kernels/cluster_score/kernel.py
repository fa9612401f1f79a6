"""Launcher of the δ⁺ scoring kernels (``csrc/cluster_score.cu``).

The library is built, loaded and counted by
:mod:`repro_torch.kernels.build`.  The launcher checks device, dtype,
contiguity and shape, picks a variant from the shapes alone
(:func:`score_route`), allocates the output with ``torch.empty``,
launches on ``torch.cuda.current_stream()``, raises when the launch
reports a CUDA error, and adds one to ``LAUNCHES["cluster_scores_kernel"]``
per call and one to the variant's own counter (``cluster_scores_staged``
or ``cluster_scores_general``) per launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import LAUNCHES, check, lib, stream_of

__all__ = ["STAGED_K_MAX", "STAGED_TABLE_BYTES", "cluster_scores_cuda", "padded_k",
           "score_route"]

# The staged variant keeps K accumulators a lane in registers (K padded to
# a power of two) and the weighted table (TC, padded K) fp32 in one block's
# shared memory; these bound both.
STAGED_K_MAX = 16
STAGED_TABLE_BYTES = 192 * 1024


def padded_k(k: int) -> int:
    """K rounded up to a power of two: the staged table's row width."""
    return 1 << max(int(k) - 1, 0).bit_length()


def score_route(tc: int, k: int) -> str:
    """The variant a call with a (TC, K) table takes: ``"staged"`` (the
    weighted table in shared memory; every round of TopDown, K <= 8 at
    TC = 3000) or ``"general"`` (larger K or table)."""
    if 1 <= k <= STAGED_K_MAX and tc * padded_k(k) * 4 <= STAGED_TABLE_BYTES:
        return "staged"
    return "general"


def cluster_scores_cuda(ell: torch.Tensor, p: torch.Tensor, tables: torch.Tensor,
                        variant: Optional[str] = None) -> torch.Tensor:
    """(N, K) float32 δ⁺ scores; same contract as
    :func:`repro_torch.kernels.cluster_score.ref.cluster_scores_ref`.
    ``variant`` forces a variant (``"general"`` always fits; ``"staged"``
    only where :func:`score_route` picks it), else the route decides."""
    name = "cluster_scores_kernel"
    device = ell.device
    for t, dtype in ((ell, torch.int32), (p, torch.float32), (tables, torch.float32)):
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    for t in (ell, p, tables):
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name}: every input must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if ell.dim() != 2 or tables.dim() != 2 or p.shape != tables.shape[:1]:
        raise ValueError(f"{name}: ell (N, L), p (TC,) and tables (TC, K) expected")
    n, l_pad = ell.shape
    tc, k = tables.shape
    if tc < 1 or k < 1:
        raise ValueError(f"{name}: TC >= 1 and K >= 1 required, got TC={tc} K={k}")
    route = score_route(tc, k)
    if variant not in (None, route, "general"):
        raise ValueError(f"{name}: the {variant} variant does not take TC={tc} K={k}")
    route = variant or route
    out = torch.empty((n, k), dtype=torch.float32, device=device)
    if n == 0:
        return out
    launch = getattr(lib("cluster_score"), f"cluster_scores_{route}_launch")
    status = launch(ell.data_ptr(), n, l_pad, p.data_ptr(), tables.data_ptr(), tc, k,
                    out.data_ptr(), stream_of(device))
    check(status, name)
    LAUNCHES[name] += 1
    LAUNCHES[f"cluster_scores_{route}"] += 1
    return out
