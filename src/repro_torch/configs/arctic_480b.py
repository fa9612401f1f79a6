"""arctic-480b [hf:Snowflake/snowflake-arctic-base]: dense-MoE hybrid —
35L GQA(56q/8kv) with a dense FFN residual in parallel with a 128-expert
top-2 MoE per layer. bf16 optimizer moments + FSDP: at 480B params the
optimizer state, not activations, is the HBM constraint."""

import dataclasses

from repro_torch.configs.base import ArchSpec, lm_cells
from repro_torch.models.transformer import LMConfig, MoESpec

CFG = LMConfig(
    name="arctic-480b",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab=32000,
    moe=MoESpec(
        n_experts=128, top_k=2, d_expert=4864, dense_residual=True,
        capacity_factor=1.25,
    ),
    tie_embeddings=False,
    remat="full",
    param_dtype="bfloat16",  # 480B: f32 params alone would be 7.5 GiB/chip
)

SMOKE = dataclasses.replace(
    CFG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=512,
    moe=MoESpec(n_experts=8, top_k=2, d_expert=96, dense_residual=True),
    dtype="float32", remat="none", loss_chunk=16,
)


def spec() -> ArchSpec:
    return ArchSpec(
        name="arctic-480b",
        family="lm",
        cfg=CFG,
        smoke_cfg=SMOKE,
        cells=lm_cells(full_attention_only=True, microbatches=8),
        fsdp=True,
    )
