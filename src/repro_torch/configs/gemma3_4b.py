"""gemma3-4b [hf:google/gemma-3-4b-pt]: 34L GQA(8q/4kv, head 256), 5:1
local:global sliding window (1024), 128k context, 262k vocab, tied
embeddings, QK-norm. The only assigned LM that runs ``long_500k``
(hybrid local:global is sub-quadratic in the local layers; decode reads
are O(window) there and O(L) only in every 6th layer)."""

import dataclasses

from repro_torch.configs.base import ArchSpec, lm_cells
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(
    name="gemma3-4b",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262144,
    qk_norm=True,
    rope_theta=1_000_000.0,
    window=1024,
    global_every=6,  # 5 local : 1 global
    tie_embeddings=True,
    remat="none",
)

SMOKE = dataclasses.replace(
    CFG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, window=8, global_every=3, dtype="float32",
    loss_chunk=16,
)


def spec() -> ArchSpec:
    return ArchSpec(
        name="gemma3-4b",
        family="lm",
        cfg=CFG,
        smoke_cfg=SMOKE,
        cells=lm_cells(full_attention_only=False, microbatches=8),
    )
