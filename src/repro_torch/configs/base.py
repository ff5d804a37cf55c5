"""Architecture registry: ArchSpec = ModelConfig + serving/training metadata.

Port of ``repro/configs/base.py``.  Every ported architecture registers one
:class:`ArchSpec`; the launchers go through ``get_arch(arch_id)`` /
``list_archs()``.  ``ALL_ARCH_IDS`` keeps the reference's ten ids in its
order, and ``get_arch`` builds every one of them.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.common import ModelConfig

__all__ = [
    "ArchSpec",
    "InputShape",
    "INPUT_SHAPES",
    "register",
    "get_arch",
    "list_archs",
    "ALL_ARCH_IDS",
]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    citation: str
    model: ModelConfig
    smoke: ModelConfig  # reduced variant: <=2 layers, d_model<=512, <=4 experts
    optimizer: str = "adamw"  # "adafactor" for the >=100B MoEs
    # long_500k policy: "native" (SSM / SWA), "windowed" (explicit sliding-
    # window serving variant, beyond-paper config), or "skip" (documented)
    long_context: str = "windowed"
    long_window: int = 8_192  # serving window for the "windowed" variant
    notes: str = ""

    @property
    def family(self) -> str:
        return self.model.family

    def supports(self, shape: InputShape) -> bool:
        if shape.name == "long_500k":
            return self.long_context != "skip"
        return True


_REGISTRY: dict[str, ArchSpec] = {}

ALL_ARCH_IDS = [
    "kimi-k2-1t-a32b",
    "llama4-maverick-400b-a17b",
    "seamless-m4t-medium",
    "qwen2.5-14b",
    "internlm2-20b",
    "gemma3-12b",
    "qwen2-vl-2b",
    "jamba-v0.1-52b",
    "qwen1.5-4b",
    "mamba2-780m",
]

_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_") for a in ALL_ARCH_IDS}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _REGISTRY:
        mod = _MODULE_FOR.get(arch_id)
        if mod is None:
            raise KeyError(f"unknown arch {arch_id!r}; known: {ALL_ARCH_IDS}")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[arch_id]


def list_archs() -> list[str]:
    return list(ALL_ARCH_IDS)
