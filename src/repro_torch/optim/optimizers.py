"""Optimizers on dicts of tensors: AdamW and Adafactor (the port of
``repro.optim``).

A function of (grads, state, params) that returns new ones and builds no
graph (``torch.no_grad()``). The state's dtype is f32 or bf16
(``state_dtype``); its ``mu`` mirrors the params leaf for leaf. The
arithmetic keeps the JAX package's order: the moments and the
bias corrections in f32, ``b ** step`` with the step a 0-d int32 tensor
cast to f32. The global norm sums the leaves in the port's order
(``torch.utils._pytree``), not JAX's sorted one, so it matches to
rounding, not bit for bit. The trees may hold DTensors (a tensor-parallel
trainer's): every op then acts on the whole tensors, and the update
keeps each leaf's placements.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # 'adamw' | 'adafactor'
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    state_dtype: str = "float32"  # 'float32' | 'bfloat16'
    # adafactor
    min_dim_size_to_factor: int = 128


def _factored(shape, cfg: OptConfig) -> bool:
    """Adafactor factors a leaf by its last two dims where both are at
    least ``min_dim_size_to_factor``."""
    return (len(shape) >= 2
            and shape[-1] >= cfg.min_dim_size_to_factor
            and shape[-2] >= cfg.min_dim_size_to_factor)


def _is_moment(v) -> bool:
    return isinstance(v, dict) and (set(v) == {"m", "v"}
                                    or set(v) == {"vr", "vc"})


def _like(tree, ref):
    """``tree`` with its dicts' keys in ``ref``'s order, down to ``ref``'s
    leaves (a tree mapped from JAX has its keys sorted)."""
    if isinstance(ref, dict):
        return {k: _like(tree[k], v) for k, v in ref.items()}
    if isinstance(ref, (list, tuple)):
        return [_like(t, r) for t, r in zip(tree, ref, strict=True)]
    return tree


def init_opt_state(cfg: OptConfig, params):
    """{"step": int32 0-d, "mu": per param leaf {"m", "v"} (AdamW, and
    Adafactor's unfactored leaves) or {"vr", "vc"} (Adafactor's factored
    ones: the row and column means of g²)}, zeros in ``state_dtype`` on
    each param's device."""
    dt = getattr(torch, cfg.state_dtype)

    def leaf(p):
        def z(shape):
            return torch.zeros(shape, dtype=dt, device=p.device)

        if cfg.name == "adafactor" and _factored(p.shape, cfg):
            return {"vr": z(p.shape[:-1]),
                    "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"m": z(p.shape), "v": z(p.shape)}

    leaves = pytree.tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": pytree.tree_map(leaf, params)}


def opt_state_axes(cfg: OptConfig, params_axes, abstract_params):
    """The logical axes of the optimizer state (mirrors the params')."""

    def leaf(axes, p):
        if cfg.name == "adafactor" and _factored(p.shape, cfg):
            return {"vr": axes[:-1], "vc": axes[:-2] + axes[-1:]}
        return {"m": axes, "v": axes}

    flat_p, spec = pytree.tree_flatten(abstract_params)
    flat_a = pytree.tree_leaves(params_axes, is_leaf=lambda v: isinstance(
        v, tuple))
    return {"step": (),
            "mu": pytree.tree_unflatten(
                [leaf(a, p) for a, p in zip(flat_a, flat_p, strict=True)],
                spec)}


def _global_norm(leaves):
    """The norm of all leaves together. A DTensor leaf's sum of squares
    is its whole tensor's, reduced over its shards (``full_tensor``), so
    the norm is the global one on every rank."""
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        sq = torch.sum(torch.square(g.float()))
        if isinstance(sq, DTensor):
            sq = sq.full_tensor()
        total = total + sq
    return torch.sqrt(total)


@torch.no_grad()
def opt_update(cfg: OptConfig, grads, opt_state, params):
    """Returns (new_params, new_opt_state, {"grad_norm"}); the new trees
    have the params' structure (grads and state are matched to it by
    key)."""
    step = opt_state["step"] + 1
    flat_p, spec = pytree.tree_flatten(params)
    flat_g = pytree.tree_leaves(_like(grads, params))
    flat_s = pytree.tree_leaves(_like(opt_state["mu"], params),
                                is_leaf=_is_moment)
    gnorm = _global_norm(flat_g)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    dt = getattr(torch, cfg.state_dtype)
    stepf = step.float()

    def f32(x):
        return torch.full((), x, dtype=torch.float32, device=step.device)

    def leaf(g, st, p):
        g = g.float() * scale
        if "vr" in st:  # adafactor
            g2 = torch.square(g) + 1e-30
            vr = cfg.b2 * st["vr"].float() + (1 - cfg.b2) * g2.mean(-1)
            vc = cfg.b2 * st["vc"].float() + (1 - cfg.b2) * g2.mean(-2)
            rms = vr[..., :, None] * vc[..., None, :] / torch.clamp(
                vr.mean(-1)[..., None, None], min=1e-30)
            upd = g * torch.rsqrt(rms + cfg.eps)
            new_st = {"vr": vr.to(dt), "vc": vc.to(dt)}
        else:
            m = cfg.b1 * st["m"].float() + (1 - cfg.b1) * g
            v = cfg.b2 * st["v"].float() + (1 - cfg.b2) * torch.square(g)
            mhat = m / (1 - torch.pow(f32(cfg.b1), stepf))
            vhat = v / (1 - torch.pow(f32(cfg.b2), stepf))
            upd = mhat / (torch.sqrt(vhat) + cfg.eps)
            new_st = {"m": m.to(dt), "v": v.to(dt)}
        p32 = p.float()
        return (p32 - cfg.lr * (upd + cfg.weight_decay * p32)).to(p.dtype), \
            new_st

    out = [leaf(g, st, p)
           for g, st, p in zip(flat_g, flat_s, flat_p, strict=True)]
    return (pytree.tree_unflatten([o[0] for o in out], spec),
            {"step": step,
             "mu": pytree.tree_unflatten([o[1] for o in out], spec)},
            {"grad_norm": gnorm})
