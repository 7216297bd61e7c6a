"""Architecture configs (pure Python, the port's own copies).

``get_config(name)`` returns the full published configuration;
``get_smoke_config(name)`` a reduced same-family config for CPU tests.
Every arch but llama4-maverick-400b-a17b is carried; that one raises
``NotImplementedError`` naming its slice.
"""

from repro_torch.configs.base import (
    ARCHS,
    LayerSpec,
    ModelConfig,
    get_config,
    get_smoke_config,
    list_archs,
)

__all__ = [
    "ARCHS",
    "LayerSpec",
    "ModelConfig",
    "get_config",
    "get_smoke_config",
    "list_archs",
]
