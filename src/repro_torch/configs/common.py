"""Architecture registry — the port of ``repro.configs.common``'s
``ArchSpec``, ``register``, ``get_arch`` and ``list_archs``."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    config: ModelConfig
    smoke: ModelConfig
    source: str = ""
    notes: str = ""


_REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    import repro_torch.configs  # noqa: F401  (registers the configs)
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs():
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


__all__ = ["ArchSpec", "register", "get_arch", "list_archs"]
