"""JAX pytrees (as numpy arrays) -> the port's model parameters and caches.

The JAX package stacks each pattern position's leaves over the repeats
(``groups/l{i}`` leaves are [R, ...]) and keeps the tail apart; the port
keeps one dict per layer in execution order. The einsum layouts are kept
as they are: ``wq/wk/wv [d, heads, head_dim]``, ``wo [heads, head_dim,
d]``, MLP ``wi/wg [d, ff]`` and ``wo [ff, d]``; an rwkv layer's ``tm``,
``cm``, ``ln_tm`` and ``ln_cm`` trees and its cache (``tm_x``, ``cm_x``,
``state``) keep their names and layouts too, and so do a MoE layer's
``moe`` tree (``router [d, E]`` in f32, ``wi/wg [E, d, ff]``, ``wo [E,
ff, d]``; [R, E, ...] per pattern position in JAX), a hybrid layer's
``ssm`` tree and cache ``state``, a cross layer's ``ln_cross``, ``cross``
and ``cross_gate`` (a [R] leaf per pattern position in JAX, a 0-d tensor
per layer here) and cache ``ck``/``cv``. ``pos_embed`` and
``enc_final_norm`` stay top-level leaves; the encoder's ``l{i}`` dicts
become the list ``params["encoder"]``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _tensors(tree, device, index=None):
    if isinstance(tree, dict):
        return {k: _tensors(v, device, index) for k, v in tree.items()}
    a = np.asarray(tree)
    if index is not None:
        a = np.asarray(a[index])  # a 0-d array, not a scalar, from a [R] leaf
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: exact through f32
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                          torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def _layers(cfg: ModelConfig, tree, device):
    """Per-layer dicts in execution order from ``groups`` and ``tail``."""
    out = []
    for r in range(cfg.pattern_repeats):
        for i in range(len(cfg.pattern)):
            out.append(_tensors(tree["groups"][f"l{i}"], device, r))
    for i in range(len(cfg.tail)):
        out.append(_tensors(tree["tail"][f"l{i}"], device))
    return out


def params_from_numpy(cfg: ModelConfig, tree, device="cuda"):
    """The JAX ``init_params`` pytree (numpy leaves) as the port's params."""
    params = {k: _tensors(tree[k], device)
              for k in ("tok_embed", "final_norm", "lm_head", "pos_embed",
                        "enc_final_norm") if k in tree}
    params["layers"] = _layers(cfg, tree, device)
    if cfg.encoder_layers:
        params["encoder"] = [_tensors(tree["encoder"][f"l{i}"], device)
                             for i in range(cfg.encoder_layers)]
    return params


def cache_from_numpy(cfg: ModelConfig, tree, device="cuda"):
    """A JAX decode cache (numpy leaves) in the port's layout."""
    return {"pos": _tensors(tree["pos"], device),
            "layers": _layers(cfg, tree, device)}


def opt_state_from_numpy(cfg: ModelConfig, ocfg, tree, device="cuda"):
    """A JAX optimizer state (``repro.optim.init_opt_state``'s tree, numpy
    leaves: ``step`` and ``mu`` stacked like the params) as the port's,
    so a JAX run resumes in the port. Each ``mu`` leaf must be the kind
    the port's ``init_opt_state`` gives for ``ocfg`` ({"m", "v"}, or
    {"vr", "vc"} where Adafactor factors the port's leaf)."""
    from torch.utils import _pytree as pytree

    from repro_torch.optim.optimizers import _factored, _is_moment

    mu = params_from_numpy(cfg, tree["mu"], device)
    for st in pytree.tree_leaves(mu, is_leaf=_is_moment):
        factored = "vr" in st
        shape = (tuple(st["vr"].shape) + (st["vc"].shape[-1],) if factored
                 else tuple(st["m"].shape))
        if factored != (ocfg.name == "adafactor" and _factored(shape, ocfg)):
            raise ValueError(f"a {'factored' if factored else 'full'} moment "
                             f"of a leaf of shape {shape} under {ocfg}")
    return {"step": _tensors(tree["step"], device), "mu": mu}
