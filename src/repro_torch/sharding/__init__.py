"""Sharding rules and the activation-sharding context, in PyTorch."""

from repro_torch.sharding.policies import (
    DEFAULT_RULES,
    batch_sharding,
    cache_sharding,
    params_sharding,
    rules_for,
    spec_for,
)

__all__ = [
    "DEFAULT_RULES",
    "batch_sharding",
    "cache_sharding",
    "params_sharding",
    "rules_for",
    "spec_for",
]
