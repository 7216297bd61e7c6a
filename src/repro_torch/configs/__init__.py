"""Architecture configs (pure Python, the port's own copies).

``get_config(name)`` returns the full published configuration;
``get_smoke_config(name)`` a reduced same-family config for CPU tests.
All ten archs of the JAX package are carried.
"""

from repro_torch.configs.base import (
    ARCHS,
    SHAPES,
    LayerSpec,
    ModelConfig,
    ShapeSpec,
    applicable_shapes,
    get_config,
    get_smoke_config,
    list_archs,
)

__all__ = [
    "ARCHS",
    "SHAPES",
    "LayerSpec",
    "ModelConfig",
    "ShapeSpec",
    "applicable_shapes",
    "get_config",
    "get_smoke_config",
    "list_archs",
]
