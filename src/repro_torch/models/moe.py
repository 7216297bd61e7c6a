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
(a few numbers a token) are gathered, and B3 or ``plan_dispatch`` runs
on the local (whole) tensor (``sharding.ctx.local_call``). The tokens
themselves are not gathered (``_sharded_slots``): each rank fills the
slots of its own tokens, a reduce-scatter along the capacity puts each
slot on the rank that holds it, each rank's experts run on their blocks
with their weights gathered along the embedding, and each rank adds its
slots' outputs into their tokens' rows, a sum reduced onto the ranks
that hold those tokens (a reduce-scatter, then an all-reduce over the
expert shards; where a rank holds fewer slots than there are tokens,
the outputs are gathered along the capacity instead).
``weight_gather`` is the JAX package's use-site constraint to the
experts' layout; like every constraint it changes no value, and without
a context it does nothing.
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


_TOKENS = ("tokens_act", "embed_act")


def _sharded_slots(xf, st2, w2, p, mlp_kind, weight_gather):
    """The gather, the experts and the combine under a mesh, from the
    replicated plan (``st2``, ``w2``: [E, slots] slot tokens and
    weights): no rank receives a token its slots do not hold, or an
    output of a token it does not hold.

    Dispatch: each rank fills, from its own tokens (the other rows zero),
    the part of the [E, slots, D] blocks that its shards along the mesh
    axes that do not shard the tokens give it; the blocks are the sum of
    these over the token axes, reduced onto their own placements (a
    reduce-scatter along the capacity). Combine: each rank adds its
    slots' weighted outputs into the rows of their tokens, and that sum
    over the ranks is reduced onto the tokens' own placements (a
    reduce-scatter over the token axes, then an all-reduce over the
    expert shards), in the activations' dtype; where a rank's slots
    along the token axes are fewer than the tokens, the outputs are
    gathered along those axes instead and each rank adds in its own
    tokens' slots. A tensor whose local part each rank uses for other
    rows gets a partial-sum gradient along that axis; each reduction's
    backward is a gather of the gradient."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    tok = ctx.placements(xf, _TOKENS)
    xf = xf.redistribute(xf.device_mesh, tok)
    dm = xf.device_mesh
    taxes = {m for m, pl in enumerate(tok) if pl.is_shard(0)}
    E, n_slots = st2.shape
    N, D = xf.shape
    n_loc = N // math.prod(dm.size(m) for m in taxes)
    r0 = ctx.shard_index(xf, _TOKENS, 0) * n_loc
    want = ctx.placements((E, n_slots, D), _BLOCKS)
    # the plan's slots on this rank, for the blocks' shards over every
    # mesh axis (``held``) and over those that do not shard the tokens
    held = [pl if pl.is_shard(0) or pl.is_shard(1) else Replicate()
            for pl in want]
    part = [Replicate() if m in taxes else pl for m, pl in enumerate(held)]

    def partial_where(pl, differs):
        return [Partial() if differs(m) else q for m, q in enumerate(pl)]

    def reduce(t, to):
        # the shards first (reduce-scatters), then the rest (all-reduces)
        t = t.redistribute(dm, [q if p.is_partial() and q.is_shard() else p
                                for p, q in zip(t.placements, to)])
        return t.redistribute(dm, to)

    st_l = st2.redistribute(dm, part).to_local()
    own = (st_l >= r0) & (st_l < r0 + n_loc)
    x_l = xf.to_local(grad_placements=partial_where(
        tok, lambda m: m not in taxes and part[m].is_shard()))
    blk = torch.where(own[..., None], x_l[torch.where(own, st_l - r0, 0)], 0)
    blk = reduce(DTensor.from_local(
        blk, dm, partial_where(part, taxes.__contains__), run_check=False),
        want)
    y = _expert_ffn(blk, p, mlp_kind, weight_gather)
    # the combine gathers the outputs along the token axes where that is
    # fewer rows than the tokens (many experts a rank), else each rank
    # adds its own slots into all N rows, a sum reduce-scattered over them
    gather = taxes if st_l.numel() < N else set()
    pl = [Replicate() if m in gather else q for m, q in enumerate(held)]
    lo, n = (r0, n_loc) if gather else (0, N)
    st_c = st2.redistribute(dm, pl).to_local()
    y_c, w_c = (t.redistribute(dm, pl).to_local(
        grad_placements=partial_where(pl, gather.__contains__))
        for t in (y, w2))
    y_c = y_c * w_c[..., None].to(y_c.dtype)
    # slots of other rows (and empty ones) land on the extra row n
    at = torch.where((st_c >= lo) & (st_c < lo + n), st_c - lo, n)
    out = torch.zeros((n + 1, D), dtype=y_c.dtype, device=y_c.device)
    out = out.index_add(0, at.reshape(-1), y_c.reshape(-1, D))[:n]
    out = DTensor.from_local(out, dm, [
        tok[m] if m in gather else Partial() if q.is_shard() else Replicate()
        for m, q in enumerate(pl)], run_check=False)
    return reduce(out, tok)


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
        if ctx.is_dtensor(xf):
            out = _sharded_slots(xf, st2, w.view(E, G * cap), p, mlp_kind,
                                 weight_gather)
        else:
            gathered = xf[torch.where(valid2, st2, 0)]
            gathered = torch.where(valid2[..., None], gathered, 0)
            y = _expert_ffn(gathered, p, mlp_kind, weight_gather)
            y = y.reshape(E * G * cap, D) * w[:, None].to(y.dtype)
            # the combine: empty slots land on the extra row N, sliced off
            out = torch.zeros((N + 1, D), dtype=y.dtype, device=x.device)
            out = out.index_add(0, torch.where(valid, st, N), y)[:N]

    if "shared" in p:
        out = out + L.apply_mlp(mlp_kind, xf, p["shared"])

    aux = E * torch.sum(probs.mean(dim=0) * load)
    return out.reshape(B, S, D), aux
