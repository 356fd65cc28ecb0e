"""Architecture configs (``repro.configs`` counterpart): one module per
assigned architecture, plain dataclasses copied as they are, so
``registry.reduced_config`` treats every arch as the reference does.
``registry.ARCHS`` maps arch id -> ArchSpec."""

from repro_torch.configs.base import (
    ArchSpec,
    GNNConfig,
    GraphShape,
    LMConfig,
    LMShape,
    MLAConfig,
    MoEConfig,
    RecsysConfig,
    RecsysShape,
)
from repro_torch.configs.registry import ARCHS, get_arch

__all__ = [
    "ArchSpec",
    "GNNConfig",
    "GraphShape",
    "LMConfig",
    "LMShape",
    "MLAConfig",
    "MoEConfig",
    "RecsysConfig",
    "RecsysShape",
    "ARCHS",
    "get_arch",
]
