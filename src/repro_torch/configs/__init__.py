"""Architecture configs (--arch <id>) of the ported LM and recsys
families: the configs of ``repro.configs`` that the port runs, with the
same literature values.  ``registry.get_arch(name)`` returns an ArchSpec."""

from repro_torch.configs.base import ArchSpec, Cell
from repro_torch.configs.registry import ARCH_NAMES, get_arch

__all__ = ["ArchSpec", "Cell", "ARCH_NAMES", "get_arch"]
