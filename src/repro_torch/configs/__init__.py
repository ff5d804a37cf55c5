"""Model configurations ported from ``repro.configs``: the arch registry
(:mod:`.base`), its architectures, and the paper's GPT ladder (:mod:`.gpt`)."""

from repro_torch.configs.base import (
    ALL_ARCH_IDS,
    INPUT_SHAPES,
    ArchSpec,
    InputShape,
    get_arch,
    list_archs,
    register,
)

__all__ = [
    "ALL_ARCH_IDS",
    "INPUT_SHAPES",
    "ArchSpec",
    "InputShape",
    "get_arch",
    "list_archs",
    "register",
]
