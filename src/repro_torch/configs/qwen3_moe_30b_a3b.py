"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 48L GQA(32q/4kv, head 128,
QK-norm), 128-expert top-8 MoE (expert d_ff=768), no shared expert."""

import dataclasses

from repro_torch.configs.base import ArchSpec, lm_cells
from repro_torch.models.transformer import LMConfig, MoESpec

CFG = LMConfig(
    name="qwen3-moe-30b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoESpec(n_experts=128, top_k=8, d_expert=768, capacity_factor=1.25),
    tie_embeddings=False,
    remat="none",
)

SMOKE = dataclasses.replace(
    CFG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab=512, moe=MoESpec(n_experts=8, top_k=2, d_expert=64),
    dtype="float32", loss_chunk=16,
)


def spec() -> ArchSpec:
    return ArchSpec(
        name="qwen3-moe-30b-a3b",
        family="lm",
        cfg=CFG,
        smoke_cfg=SMOKE,
        cells=lm_cells(full_attention_only=True, microbatches=8),
        fsdp=True,  # 30B params: Adam state exceeds 16-way model sharding
    )
