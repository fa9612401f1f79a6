"""qwen1.5-32b [hf:Qwen/Qwen1.5-32B]: dense 64L GQA(kv=40 = MHA) with QKV bias."""

import dataclasses

from repro_torch.configs.base import ArchSpec, lm_cells
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(
    name="qwen1.5-32b",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    remat="dots",
)

SMOKE = dataclasses.replace(
    CFG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, dtype="float32", remat="none", loss_chunk=16,
)


def spec() -> ArchSpec:
    import dataclasses as dc

    cells = lm_cells(full_attention_only=True, microbatches=8)
    # 40 MHA heads don't divide the 16-way model axis, so XLA keeps the
    # (q_chunk, 32k) prefill score tiles head-replicated; a smaller query
    # chunk bounds them.
    c = cells["prefill_32k"]
    cells["prefill_32k"] = dc.replace(
        c, overrides={**c.overrides, "attn_q_chunk": 512}
    )
    return ArchSpec(
        name="qwen1.5-32b",
        family="lm",
        cfg=CFG,
        smoke_cfg=SMOKE,
        cells=cells,
        fsdp=True,  # 32B params: optimizer state exceeds per-chip HBM
    )
