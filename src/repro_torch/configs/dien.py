"""dien [arXiv:1809.03672]: GRU interest extraction + AUGRU evolution."""

import dataclasses

from repro_torch.configs.base import ArchSpec, recsys_cells
from repro_torch.models.recsys.dien import DIENConfig

CFG = DIENConfig(
    name="dien", vocab=1_000_000, embed_dim=18, seq_len=100, gru_dim=108,
    mlp=(200, 80),
)

SMOKE = dataclasses.replace(CFG, vocab=1000, seq_len=12, gru_dim=24, mlp=(32, 16))


def spec() -> ArchSpec:
    return ArchSpec(
        name="dien", family="recsys", cfg=CFG, smoke_cfg=SMOKE,
        cells=recsys_cells(),
    )
