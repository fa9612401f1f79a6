"""bert4rec [arXiv:1904.06690]: bidirectional 2-block transformer,
masked-item (Cloze) training. Encoder-only: no decode shapes exist in the
recsys set (nothing to skip)."""

import dataclasses

from repro_torch.configs.base import ArchSpec, recsys_cells
from repro_torch.models.recsys.bert4rec import BERT4RecConfig

CFG = BERT4RecConfig(
    name="bert4rec", vocab=1_000_000, embed_dim=64, n_blocks=2, n_heads=2,
    seq_len=200, d_ff=256,
)

SMOKE = dataclasses.replace(CFG, vocab=1000, embed_dim=16, seq_len=16, d_ff=32)


def spec() -> ArchSpec:
    return ArchSpec(
        name="bert4rec", family="recsys", cfg=CFG, smoke_cfg=SMOKE,
        cells=recsys_cells(),
    )
