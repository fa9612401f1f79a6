"""ArchSpec / Cell descriptors shared by every architecture config."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

__all__ = ["Cell", "ArchSpec", "lm_cells", "recsys_cells"]


@dataclasses.dataclass(frozen=True)
class Cell:
    """One (architecture × input shape) dry-run/roofline cell."""

    kind: str  # train | prefill | decode | serve | retrieval | train_minibatch
    batch: int
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    skip: Optional[str] = None  # reason, if this cell is skipped by design


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str  # lm | gnn | recsys
    cfg: Any
    smoke_cfg: Any
    cells: Dict[str, Cell]
    fsdp: bool = False  # shard params over 'data' too (ZeRO-3 style)


def lm_cells(full_attention_only: bool, microbatches: int = 4) -> Dict[str, Cell]:
    """The four LM shapes. ``long_500k`` is skipped for pure full-attention
    architectures per the assignment note (sub-quadratic attention
    required); gemma3's hybrid local:global qualifies and runs it."""
    skip = (
        "pure full-attention arch: 500k-token decode requires sub-quadratic "
        "attention (assignment note; see DESIGN.md §7)"
        if full_attention_only
        else None
    )
    return {
        "train_4k": Cell(
            kind="train", batch=256,
            extra={"seq_len": 4096, "microbatches": microbatches},
            overrides={"remat": "full", "attn_q_chunk": 512},
        ),
        "prefill_32k": Cell(
            kind="prefill", batch=32, extra={"seq_len": 32768},
            overrides={"kv_quant": True, "attn_q_chunk": 2048},
        ),
        "decode_32k": Cell(
            kind="decode", batch=128, extra={"cache_len": 32768},
            overrides={"kv_quant": True},
        ),
        "long_500k": Cell(
            kind="decode", batch=1, extra={"cache_len": 524288},
            overrides={"kv_quant": True}, skip=skip,
        ),
    }


def recsys_cells() -> Dict[str, Cell]:
    return {
        "train_batch": Cell(kind="train", batch=65536),
        "serve_p99": Cell(kind="serve", batch=512),
        "serve_bulk": Cell(kind="serve", batch=262144),
        "retrieval_cand": Cell(
            kind="retrieval", batch=1, extra={"n_candidates": 1_000_000}
        ),
    }
