"""Launcher of the δ⁺ scoring kernel (``csrc/cluster_score.cu``).

The library is built, loaded and counted by
:mod:`repro_torch.kernels.build`.  The launcher checks device, dtype,
contiguity and shape, allocates the output with ``torch.empty``,
launches on ``torch.cuda.current_stream()``, raises when the launch
reports a CUDA error, and adds one to
``LAUNCHES["cluster_scores_kernel"]`` per launch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import LAUNCHES, check, lib, stream_of

__all__ = ["cluster_scores_cuda"]


def cluster_scores_cuda(ell: torch.Tensor, p: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """(N, K) float32 δ⁺ scores; same contract as
    :func:`repro_torch.kernels.cluster_score.ref.cluster_scores_ref`."""
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
    out = torch.empty((n, k), dtype=torch.float32, device=device)
    if n == 0:
        return out
    status = lib("cluster_score").cluster_scores_launch(
        ell.data_ptr(), n, l_pad, p.data_ptr(), tables.data_ptr(), tc, k,
        out.data_ptr(), stream_of(device),
    )
    check(status, name)
    LAUNCHES[name] += 1
    return out
