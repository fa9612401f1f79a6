"""qwen1.5-4b [hf:Qwen/Qwen1.5-4B]: dense 40L MHA with QKV bias."""

import dataclasses

from repro_torch.configs.base import ArchSpec, lm_cells
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(
    name="qwen1.5-4b",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab=151936,
    qkv_bias=True,
    rope_theta=5_000_000.0,
    tie_embeddings=False,
    remat="none",
)

SMOKE = dataclasses.replace(
    CFG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, dtype="float32", loss_chunk=16,
)


def spec() -> ArchSpec:
    import dataclasses as dc

    cells = lm_cells(full_attention_only=True, microbatches=8)
    # 20 MHA heads don't divide the 16-way model axis -> head-replicated
    # prefill score tiles; a smaller query chunk bounds them.
    c = cells["prefill_32k"]
    cells["prefill_32k"] = dc.replace(
        c, overrides={**c.overrides, "attn_q_chunk": 512}
    )
    return ArchSpec(
        name="qwen1.5-4b",
        family="lm",
        cfg=CFG,
        smoke_cfg=SMOKE,
        cells=cells,
    )
