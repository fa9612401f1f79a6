"""dcn-v2 [arXiv:2008.13535]: 3 full-rank cross layers + 1024-1024-512 MLP."""

import dataclasses

from repro_torch.configs.base import ArchSpec, recsys_cells
from repro_torch.models.recsys.dcnv2 import DCNv2Config

CFG = DCNv2Config(
    name="dcn-v2", n_dense=13, n_sparse=26, vocab_per_field=100_000,
    embed_dim=16, n_cross_layers=3, mlp=(1024, 1024, 512),
)

SMOKE = dataclasses.replace(
    CFG, vocab_per_field=500, n_sparse=6, embed_dim=8, mlp=(64, 32),
)


def spec() -> ArchSpec:
    return ArchSpec(
        name="dcn-v2", family="recsys", cfg=CFG, smoke_cfg=SMOKE,
        cells=recsys_cells(),
    )
