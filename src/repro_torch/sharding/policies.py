"""Logical-axis -> mesh-axis sharding rules (the port of
``repro.sharding.policies``).

Every parameter and activation carries logical axis names; a *rules*
dict maps each logical axis to mesh axes. ``spec_for`` resolves one
array's ``NamedSharding``, skipping mesh axes that do not divide the
dimension or that an earlier dimension already uses (so kv_heads = 1
replicates instead of failing).

A spec is the tuple of the JAX ``PartitionSpec``'s entries: per tensor
dimension a mesh-axis name, a tuple of names, or None.
``NamedSharding.placements()`` turns it into DTensor placements
(``Shard``/``Replicate`` per mesh dimension) for a ``DeviceMesh``-backed
mesh.

Default policy (single-pod mesh ("data", "model"); multi-pod adds
"pod"):
  - batch over ("pod", "data")          — DP across pods and the data axis
  - embed over "data"                   — FSDP/ZeRO-3 parameter sharding
  - heads/kv_heads/mlp/vocab > "model"  — Megatron tensor parallelism
  - experts over "model"                — expert parallelism (single-owner
                                          experts: the P1 principle)

Per-arch overrides come from ``ModelConfig.sharding_overrides``;
per-shape adjustments (a sequence-parallel KV cache for decode where the
batch cannot fill the data axis) from ``rules_for``.

The port's trees follow its own layout: one dict per layer in execution
order (no leading "layers" axis), lists for ``params["layers"]`` and
``params["encoder"]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.launch.mesh import Mesh, local_devices

DEFAULT_RULES: dict[str, Any] = {
    # parameters
    "vocab": "model",
    "embed": "data",
    "mlp": "model",
    "expert_mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "experts": "model",
    "layers": None,
    "lora": None,
    "ssm_state": None,
    "pos": None,
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "seq_full": None,  # attention operands: always full sequence
    "kv_heads_act": "model",
    "embed_act": None,
    "embed_full": None,  # use-site weight gather (ZeRO-3 expert FFNs)
    "vocab_act": "model",
    "heads_act": "model",
    "tokens_act": ("pod", "data"),
    "cap": "data",  # MoE expert token blocks: shard capacity dim (DP-wise)
    "cache_seq": None,
    "cache_kv": "model",
}


CELL_RULES: dict[str, Any] = {"cells": "cells"}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and one spec entry per tensor dimension."""

    mesh: Mesh
    spec: tuple

    def placements(self) -> tuple:
        """DTensor placements, one per mesh axis: ``Shard(d)`` where
        dimension d's entry names the axis, else ``Replicate()`` (also
        for an axis of size 1: one shard is the whole tensor, and DTensor
        cannot reshape a sharded dimension)."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for axis, n in zip(self.mesh.axis_names, self.mesh.axis_sizes):
            dims = [d for d, e in enumerate(self.spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            out.append(Shard(dims[0]) if dims and n > 1 else Replicate())
        return tuple(out)


def _is_axes(v) -> bool:
    """A leaf of an axes tree: a tuple of names (or None)."""
    return isinstance(v, tuple) and all(isinstance(x, (str, type(None)))
                                        for x in v)


def _shape(leaf) -> tuple:
    """A leaf's shape: a tensor's or array's, or the shape of a ``(shape,
    dtype)`` pair (``models.model.cache_spec``'s leaves)."""
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    shape, _dtype = leaf
    return tuple(shape)


def _is_shape_leaf(v) -> bool:
    return hasattr(v, "shape") or (
        isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], tuple))


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of dicts and lists (``rest`` trees alike)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def cell_mesh(n_devices: int) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` local devices, axis
    ``"cells"`` (``repro_torch.core.sweep.SweepMode.devices`` places its
    cell blocks on them)."""
    devs = local_devices()
    if n_devices > len(devs):
        raise ValueError(f"{n_devices} devices asked, {len(devs)} here")
    return Mesh(("cells",), (n_devices,), tuple(devs[:n_devices]))


def cell_sharding(mesh: Mesh, tree):
    """Leading-axis ``("cells", None, ...)`` sharding for every leaf of
    ``tree`` (rank-0 leaves replicate)."""

    def leaf(x):
        shape = _shape(x)
        axes = ("cells",) + (None,) * max(len(shape) - 1, 0)
        return spec_for(axes[: len(shape)], shape, mesh, CELL_RULES)

    return tree_map(leaf, tree, is_leaf=_is_shape_leaf)


def rules_for(cfg, shape_kind: str, batch: int, mesh: Mesh) -> dict:
    """Resolve the rule set for one (arch x shape x mesh) cell."""
    rules = dict(DEFAULT_RULES)
    rules.update(cfg.sharding_overrides or {})
    if cfg.num_experts:
        # experts claim the model axis; expert_mlp stays unsharded unless
        # experts don't divide the axis (then fall back to mlp TP)
        if cfg.num_experts % mesh.shape.get("model", 1) == 0:
            rules.setdefault("experts", "model")
            rules["expert_mlp"] = None
        else:
            rules["experts"] = None
            rules["expert_mlp"] = "model"
    if shape_kind == "decode":
        dp = math.prod(
            mesh.shape[a] for a in ("pod", "data") if a in mesh.shape
        )
        if batch % dp != 0:
            # long-context decode with tiny batch: shard the KV cache's
            # sequence dim instead (sequence-parallel flash-decode)
            rules["batch"] = None
            rules["cache_seq"] = ("pod", "data", "model")
        elif cfg.num_kv_heads % mesh.shape.get("model", 1) != 0:
            # kv heads can't fill the model axis: flash-decode over a
            # sequence-sharded cache instead of replicating it
            rules["cache_seq"] = "model"
    return rules


def spec_for(axes: tuple, shape: tuple, mesh: Mesh, rules: dict):
    """NamedSharding for one array given its logical axes and shape."""
    used: set[str] = set()
    parts = []
    for name, dim in zip(axes, shape):
        r = rules.get(name)
        cand = r if isinstance(r, (tuple, list)) else ((r,) if r else ())
        cand = tuple(a for a in cand if a in mesh.shape and a not in used)
        # largest prefix of candidate axes that divides the dim
        chosen: tuple[str, ...] = ()
        for i_ in range(len(cand), 0, -1):
            size = math.prod(mesh.shape[a] for a in cand[:i_])
            if dim % size == 0:
                chosen = cand[:i_]
                break
        if chosen:
            parts.append(chosen if len(chosen) > 1 else chosen[0])
            used.update(chosen)
        else:
            parts.append(None)
    return NamedSharding(mesh, tuple(parts))


def tree_sharding(axes_tree, shape_tree, mesh: Mesh, rules: dict):
    """Map matching trees of axis tuples and shaped leaves (tensors,
    ``meta`` tensors, arrays or ``(shape, dtype)`` pairs)."""
    return tree_map(lambda axes, s: spec_for(axes, _shape(s), mesh, rules),
                    axes_tree, shape_tree, is_leaf=_is_axes)


def params_sharding(cfg, mesh: Mesh, rules: dict, abstract_params=None):
    """Sharding tree for the model's params. ``abstract_params`` is any
    tree of shaped leaves in the port's layout; by default the params
    built on the ``meta`` device (``models.model.abstract_params``), so
    no weight is allocated."""
    from repro_torch.models import model as M
    from repro_torch.models import param_axes

    if abstract_params is None:
        abstract_params = M.abstract_params(cfg)
    return tree_sharding(param_axes(cfg), abstract_params, mesh, rules)


def distribute(tree, sharding_tree):
    """Each tensor of ``tree`` as a DTensor placed as its
    ``NamedSharding`` in ``sharding_tree`` (a mesh on a ``DeviceMesh``).
    Every rank holds the same full tensor (the same seed, or the same
    checkpoint), so each keeps its own shard and nothing is sent; a
    ``meta`` tensor stays on ``meta``."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(
        lambda t, sh: distribute_tensor(t, sh.mesh.device_mesh,
                                        sh.placements(), src_data_rank=None),
        tree, sharding_tree)


def batch_sharding(mesh: Mesh, rules: dict, batch_spec):
    """Sharding for token batches / extras: leading dim = batch."""

    def leaf(s):
        shape = _shape(s)
        axes = ("batch",) + ("seq",) * (len(shape) - 1)
        return spec_for(axes, shape, mesh, rules)

    return tree_map(leaf, batch_spec, is_leaf=_is_shape_leaf)


def cache_sharding(cfg, mesh: Mesh, rules: dict, cache_spec_tree):
    """Sharding for the decode cache tree (``models.model.cache_spec``'s
    layout, one dict per layer, no leading layers axis).

    Leaf roles are inferred from rank/shape against the model config —
    k/v: [B, S, kv, hd]; kpos: [B, S]; ssm states and shift buffers
    replicate batch over data only.
    """

    def leaf(s):
        shp = _shape(s)
        if len(shp) == 4 and shp[2] == cfg.num_kv_heads:
            axes = ("batch", "cache_seq", "cache_kv", "head_dim")
        elif len(shp) == 4:  # ssm state [B,H,hd,N] / rwkv [B,H,hd,hd]
            axes = ("batch", "heads", "head_dim", "ssm_state")
        elif len(shp) == 3:  # [B,T,d]
            axes = ("batch", "seq", "embed_act")
        elif len(shp) == 2:
            axes = ("batch", "cache_seq")
        else:
            axes = ("batch",)
        return spec_for(axes, shp, mesh, rules)

    return tree_map(leaf, cache_spec_tree, is_leaf=_is_shape_leaf)
