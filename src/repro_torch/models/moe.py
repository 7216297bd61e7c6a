"""Mixture-of-Experts with planned dispatch (the port of
``repro.models.moe``).

The dispatch plan is computed ahead of any expert compute, in canonical
(expert id, arrival) order, with a static per-expert capacity: each
expert runs one [capacity, d] block, tokens past its capacity are
dropped, and the combine is one scatter-add. The whole plan (top-k,
positions, dispatch table, load) is one launch of kernel B3
(``kernels.moe_dispatch``, hand-written CUDA) where
``use_kernel(kernel_impl, device)`` says so, and otherwise
``plan_dispatch``, B3's plain version. Under autograd the kernel's
``slot_weight`` is differentiable in the router probabilities with the
plain plan's VJP (``kernels.autograd.kernel_call``); the integer plan
stays the kernel's. The router,
the expert products, the gather and the combine are plain PyTorch, as
the JAX package left them to XLA.

Modes:
  'planned' — capacity dispatch in canonical order (the default).
  'dense'   — every expert computes every token, mask-combined (exact, no
              drops); the tests' oracle.

Per-shard dispatch (``dispatch_shards`` G > 1, where G divides the N
tokens): the JAX package plans each data-parallel shard's n = N / G
tokens on its own, at a local capacity of its own (at least 32), and
vmaps the gather, the experts and the combine over the shards. Here the
G plans are one grouped launch of B3, the G shards' slot blocks go
through each expert's FFN as one [G * C, d] block, and one scatter-add
combines them on global token indices. Where G does not divide N it
plans once over all N, as the JAX package does. The aux loss takes the
routed share over all N tokens either way.

Under a mesh (``sharding.ctx``) the plan is made on every rank over all
N tokens, as the JAX package plans over all of them: the probabilities
are gathered, B3 or ``plan_dispatch`` runs on the local (whole) tensor
(``sharding.ctx.local_call``), and the replicated plan feeds each rank's
local experts, whose FFNs run on local shards with their weights
gathered along the embedding. ``weight_gather`` is the JAX package's
use-site constraint to that same layout; like every constraint it
changes no value, and without a context it does nothing.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import use_kernel
from repro_torch.kernels.autograd import kernel_call
from repro_torch.kernels.moe_dispatch.ops import moe_dispatch_plan
from repro_torch.kernels.moe_dispatch.ref import (
    moe_dispatch_plan_grouped_ref,
    moe_dispatch_plan_ref,
    route,
    routed_share,
)
from repro_torch.models import layers as L
from repro_torch.sharding import ctx


def _bank(shape, scale, dtype, device, gen):
    """N(0, scale^2) weights drawn in ``dtype`` itself: an expert bank at
    mixtral's width is 1.6 GB in bf16, and no f32 copy of it is made."""
    w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return w.mul_(scale)


def init_moe(d, ff, num_experts, dtype, device, gen, mlp_kind="swiglu",
             shared_expert=False):
    """The router [d, E] in f32 whatever ``dtype``; ``wi``/``wg`` [E, d,
    ff] and ``wo`` [E, ff, d]; an optional shared expert (an MLP)."""
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    p = {
        "router": L.normal((d, num_experts), s_in, torch.float32, device,
                           gen),
        "wi": _bank((num_experts, d, ff), s_in, dtype, device, gen),
        "wo": _bank((num_experts, ff, d), s_out, dtype, device, gen),
    }
    if mlp_kind in ("swiglu", "geglu"):
        p["wg"] = _bank((num_experts, d, ff), s_in, dtype, device, gen)
    if shared_expert:
        p["shared"] = L.init_mlp(mlp_kind, d, ff, dtype, device, gen)
    return p


def moe_axes(mlp_kind="swiglu", shared_expert=False):
    a = {
        "router": ("embed", "experts"),
        "wi": ("experts", "embed", "expert_mlp"),
        "wo": ("experts", "expert_mlp", "embed"),
    }
    if mlp_kind in ("swiglu", "geglu"):
        a["wg"] = ("experts", "embed", "expert_mlp")
    if shared_expert:
        a["shared"] = L.mlp_axes(mlp_kind)
    return a


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


_W_IN = ("experts", "embed_full", "expert_mlp")
_W_OUT = ("experts", "expert_mlp", "embed_full")


def _expert_ffn(blocks, p, mlp_kind, weight_gather=False):
    """blocks: [E, C, d] -> [E, C, d] through each expert's FFN.
    ``weight_gather`` constrains the expert weights to an unsharded embed
    dimension where they are used (the JAX package's ZeRO-3 gather)."""
    def w(name, axes):
        return ctx.constrain(p[name], axes) if weight_gather else p[name]

    names = ("wi", "wo") + (("wg",) if "wg" in p else ())
    axes = {"wi": _W_IN, "wo": _W_OUT, "wg": _W_IN}
    ws = [w(n, axes[n]) for n in names]
    # under a mesh each rank runs its experts (and its share of their
    # hidden units where the experts do not divide the axis: a partial
    # sum) on its blocks
    return ctx.local_call(
        lambda b, *w_: _ffn(b, dict(zip(names, w_)), mlp_kind),
        (blocks, *ws), (_BLOCKS, *[axes[n] for n in names]), _BLOCKS,
        contracted=("expert_mlp",))


_BLOCKS = ("experts", "cap", "embed_act")


def _ffn(blocks, p, mlp_kind):
    h = torch.bmm(blocks, p["wi"])
    if mlp_kind == "swiglu":
        h = F.silu(torch.bmm(blocks, p["wg"])) * h
    elif mlp_kind == "geglu":
        h = _gelu(torch.bmm(blocks, p["wg"])) * h
    else:
        h = _gelu(h)
    return torch.bmm(h, p["wo"])


def plan_dispatch(router_probs, top_k, capacity):
    """The plain dispatch plan, on any device: B3's plain version (route,
    stable sort, positions, scatters, histogram; the port of
    ``repro.models.moe.plan_dispatch``); for probabilities [G, n, E] one
    plan a group, as ``moe_dispatch_plan`` takes them."""
    if router_probs.dim() == 3:
        return moe_dispatch_plan_grouped_ref(router_probs, top_k, capacity)
    return moe_dispatch_plan_ref(router_probs, top_k, capacity)


def _kernel_plan(router_probs, top_k, capacity):
    """B3's plan (``moe_dispatch_plan``), its ``slot_weight`` carrying
    ``plan_dispatch``'s gradient where autograd needs one."""
    fields = ("slot_token", "slot_weight", "load")
    if router_probs.dim() == 3:
        fields += ("count",)

    def fn(planner):
        def fields_of(p):
            plan = planner(p, top_k=top_k, capacity=capacity)
            return tuple(plan[f] for f in fields)
        return fields_of

    return dict(zip(fields, kernel_call(fn(moe_dispatch_plan),
                                        fn(plan_dispatch), router_probs,
                                        name="moe_dispatch")))


def capacity_for(n_tokens, top_k, num_experts, capacity_factor, floor=128):
    """The planned mode's static per-expert capacity: ``capacity_factor``
    times the mean load, truncated, then rounded up to a multiple of 128
    and at least ``floor``: 128 for one plan, 32 for a shard's plan (0
    rounds up to 0, so a shard's capacity may be 32)."""
    cap = int(capacity_factor * n_tokens * top_k / num_experts)
    return max(floor, (cap + 127) // 128 * 128)


def apply_moe(x, p, *, top_k, capacity_factor, mlp_kind="swiglu",
              mode="planned", dispatch_shards: int = 0,
              weight_gather: bool = False, kernel_impl="auto"):
    """x: [B,S,D] -> ([B,S,D], the Switch load-balance aux loss).

    The planned mode plans over all N = B*S tokens (a decode step's idle
    slots included), or per shard (the module's docstring), through
    kernel B3 or ``plan_dispatch`` (``kernel_impl``, as
    ``repro_torch.kernels.use_kernel`` reads it): one launch either way.
    """
    B, S, D = x.shape
    N = B * S
    E = p["router"].shape[1]
    xf = x.reshape(N, D)
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)

    if mode == "dense":
        w, eidx = route(probs, top_k)
        gate = torch.zeros((N, E), dtype=torch.float32, device=x.device)
        gate.scatter_(1, eidx, w)
        h = torch.einsum("nd,edf->enf", xf, p["wi"])
        if mlp_kind in ("swiglu", "geglu"):
            act = F.silu if mlp_kind == "swiglu" else _gelu
            h = act(torch.einsum("nd,edf->enf", xf, p["wg"])) * h
        else:
            h = _gelu(h)
        y = torch.einsum("enf,efd->end", h, p["wo"])
        out = torch.einsum("end,ne->nd", y, gate.to(y.dtype))
        load = routed_share(eidx, E)
    else:
        plan_fn = (_kernel_plan if use_kernel(kernel_impl, x.device)
                   else plan_dispatch)

        def planner(pr, *, top_k, capacity):
            # every rank plans over all tokens: the plan is replicated
            keys = ("slot_token", "slot_weight", "load") + (
                ("count",) if pr.dim() == 3 else ())

            def fn(pr_):
                plan = plan_fn(pr_, top_k=top_k, capacity=capacity)
                return tuple(plan[k] for k in keys)

            outs = ctx.local_call(fn, (pr,), ((None,) * pr.dim(),),
                                  (None,) * len(keys))
            return dict(zip(keys, outs))
        G = dispatch_shards if dispatch_shards > 1 else 1
        if N % G:
            G = 1  # the JAX package's fallback: one plan over all N
        if G > 1:
            n_loc = N // G
            cap = capacity_for(n_loc, top_k, E, capacity_factor, floor=32)
            plan = planner(probs.view(G, n_loc, E), top_k=top_k,
                           capacity=cap)
            # group-local slot tokens -> global token indices
            st = plan["slot_token"]
            st = torch.where(st >= 0, st + torch.arange(
                0, N, n_loc, dtype=st.dtype, device=st.device)[:, None], -1)

            def by_expert(t):  # [G, E*cap] -> [E, G, cap], flat
                return t.view(G, E, cap).transpose(0, 1).reshape(-1)

            st, w = by_expert(st), by_expert(plan["slot_weight"])
            # the Switch loss's routed share over all N tokens
            load = plan["count"].sum(0).float() / torch.full(
                (), N * top_k, dtype=torch.float32, device=x.device)
        else:
            cap = capacity_for(N, top_k, E, capacity_factor)
            plan = planner(probs, top_k=top_k, capacity=cap)
            st, w = plan["slot_token"], plan["slot_weight"]
            load = plan["load"]  # = the Switch loss's routed share
        # each expert's slots (of every group) as one [G*cap, D] block
        # (the plan's 2-D [E, G*cap] view indexes the tokens directly:
        # DTensor cannot split a flat slot dimension its rows shard)
        valid = st >= 0
        st2, valid2 = st.view(E, G * cap), valid.view(E, G * cap)
        gathered = xf[torch.where(valid2, st2, 0)]
        gathered = torch.where(valid2[..., None], gathered, 0)
        gathered = ctx.constrain(gathered, ("experts", "cap", "embed_act"))
        y = _expert_ffn(gathered, p, mlp_kind, weight_gather)
        y = ctx.constrain(y, ("experts", "cap", "embed_act"))
        # the slots gathered along their capacity before the flat combine
        y = ctx.constrain(y, ("experts", None, "embed_act"))
        y = y.reshape(E * G * cap, D) * w[:, None].to(y.dtype)
        # the combine: empty slots land on the extra row N, sliced off
        out = torch.zeros((N + 1, D), dtype=y.dtype, device=x.device)
        out = out.index_add(0, torch.where(valid, st, N), y)[:N]
        out = ctx.constrain(out, ("tokens_act", "embed_act"))

    if "shared" in p:
        out = out + L.apply_mlp(mlp_kind, xf, p["shared"])

    aux = E * torch.sum(probs.mean(dim=0) * load)
    return out.reshape(B, S, D), aux
