"""RecSys architectures on PyTorch: DIEN, MIND, DCN-v2, BERT4Rec — the
port of ``repro.models.recsys``.

Shared substrate in ``embedding.py`` (tables, gathers, MLP towers).  Every
model module has a config dataclass, an ``nn.Module`` with ``forward``
(the CTR logit or score, (B,)) and ``score_candidates`` (the
``retrieval_cand`` head: the user representation against N candidate
embeddings as one product, (B, N)), and ``init(cfg, generator, device)``,
and ``loss_fn(model, batch)``, the reference's training loss (the model
made trainable with ``requires_grad_(True)``).  The SeCluD pre-filter over
candidate attributes lives in :mod:`repro_torch.serve.retrieval`.
"""

import importlib

__all__ = ["recsys_module"]

_MODULES = {
    "dien": "repro_torch.models.recsys.dien",
    "mind": "repro_torch.models.recsys.mind",
    "dcn-v2": "repro_torch.models.recsys.dcnv2",
    "bert4rec": "repro_torch.models.recsys.bert4rec",
}


def recsys_module(name: str):
    """The model module of arch ``name`` (the JAX ``_recsys_module``)."""
    return importlib.import_module(_MODULES[name])
