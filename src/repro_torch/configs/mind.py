"""mind [arXiv:1904.08030]: multi-interest capsule routing retrieval."""

import dataclasses

from repro_torch.configs.base import ArchSpec, recsys_cells
from repro_torch.models.recsys.mind import MINDConfig

CFG = MINDConfig(
    name="mind", vocab=1_000_000, embed_dim=64, n_interests=4,
    capsule_iters=3, hist_len=50,
)

SMOKE = dataclasses.replace(CFG, vocab=1000, embed_dim=16, hist_len=10)


def spec() -> ArchSpec:
    return ArchSpec(
        name="mind", family="recsys", cfg=CFG, smoke_cfg=SMOKE,
        cells=recsys_cells(),
    )
