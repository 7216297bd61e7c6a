"""The LM substrate's models, in PyTorch: every mixer and model feature of
the JAX package's ten archs (attention with a dense MLP or a planned MoE,
rwkv, the hybrid attention + Mamba head, cross-attention, the encoder,
learned positions, early fusion, per-shard MoE dispatch)."""

from repro_torch.models.model import abstract_params, param_axes

__all__ = ["abstract_params", "param_axes"]
