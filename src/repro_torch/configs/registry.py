"""--arch registry of the port.  Lazy imports keep ``import
repro_torch.configs`` light.  It knows every arch of the JAX package
(``NOT_PORTED`` lists any the port cannot run yet: none since PNA)."""

import importlib

_MODULES = {
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "qwen1.5-32b": "repro_torch.configs.qwen1_5_32b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "dien": "repro_torch.configs.dien",
    "mind": "repro_torch.configs.mind",
    "dcn-v2": "repro_torch.configs.dcn_v2",
    "bert4rec": "repro_torch.configs.bert4rec",
    "pna": "repro_torch.configs.pna",
}
# The JAX package's archs (``repro.configs.registry``) the port cannot run.
NOT_PORTED = ()

ARCH_NAMES = tuple(_MODULES)


def get_arch(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet; the port runs {ARCH_NAMES}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    return importlib.import_module(_MODULES[name]).spec()
