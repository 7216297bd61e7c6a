"""Shared building blocks: norms, RoPE, MLPs, attention (all mask kinds).

The port of ``repro.models.layers``, same functions and parameter
layouts (``wq/wk/wv [d, heads, head_dim]``, ``wo [heads, head_dim, d]``,
MLP ``wi/wg [d, ff]``, ``wo [ff, d]``), and the same sharding
constraints (``sharding.ctx.constrain``: a no-op without a context, so on
one card).

Prefill attention goes through kernel B4 (``kernels.flash_attention``,
hand-written CUDA) where ``use_kernel(kernel_impl, device)`` says so, and
otherwise through ``_attend_blocked``, the model's plain formulation.
Under autograd B4's backward is ``_attend_blocked``'s
(``kernels.autograd.kernel_call``). Decode attention, cross-attention,
the MLP, the norms and the projections are plain PyTorch, as the JAX
package left them to XLA. Under a mesh (DTensor params, a sharding
context) the attention, the projections and the MLP run on each rank's
local shards (``sharding.ctx.local_call``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import use_kernel
from repro_torch.kernels.autograd import kernel_call
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.sharding import ctx

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x, w, eps=1e-6):
    x32 = x.float()
    # under a mesh the normalized dimension may be sharded (rwkv's ln_x)
    var = ctx.mean_last(x32 * x32)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x, w, b, eps=1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * w + b


def apply_norm(kind, x, p):
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def init_norm(kind, d, dtype, device):
    p = {"scale": torch.ones(d, dtype=dtype, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros(d, dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim, rotary_frac, theta, device=None):
    rot = int(head_dim * rotary_frac) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=device), exps)
    return inv, rot


def apply_rope(x, positions, theta, rotary_frac=1.0):
    """x: [..., S, H, hd]; positions: [..., S] int."""
    hd = x.shape[-1]
    inv, rot = rope_freqs(hd, rotary_frac, theta, x.device)
    ang = positions[..., :, None].float() * inv  # [..., S, rot/2]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    rotated = torch.cat(
        [x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1
    ).to(x.dtype)
    return torch.cat([rotated, x[..., rot:]], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def normal(shape, scale, dtype, device, gen):
    """N(0, scale^2) weights drawn in f32 from ``gen``, cast to ``dtype``."""
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def norm_axes(kind):
    if kind == "rmsnorm":
        return {"scale": ("embed",)}
    return {"scale": ("embed",), "bias": ("embed",)}


def init_mlp(kind, d, ff, dtype, device, gen):
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    p = {"wi": normal((d, ff), s_in, dtype, device, gen),
         "wo": normal((ff, d), s_out, dtype, device, gen)}
    if kind in ("swiglu", "geglu"):
        p["wg"] = normal((d, ff), s_in, dtype, device, gen)
    return p


def mlp_axes(kind):
    a = {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}
    if kind in ("swiglu", "geglu"):
        a["wg"] = ("embed", "mlp")
    return a


def _mlp_axes_of(x):
    return ("batch", "seq", "embed_act") if x.dim() == 3 else (
        "tokens_act", "embed_act")


def apply_mlp(kind, x, p):
    """The MLP; under a mesh on local shards: its hidden units over the
    rules' ``mlp`` axes (Megatron), the output a partial sum over them,
    reduced once by ``local_call``."""
    names = ("wi", "wo") + (("wg",) if "wg" in p else ())
    axes = {"wi": ("embed_full", "mlp"), "wo": ("mlp", "embed_full"),
            "wg": ("embed_full", "mlp")}
    x_axes = _mlp_axes_of(x)
    return ctx.local_call(
        lambda x_, *w: _mlp(kind, x_, dict(zip(names, w))),
        (x, *[p[n] for n in names]), (x_axes, *[axes[n] for n in names]),
        x_axes[:-1] + (None,), contracted=("mlp",))


def _mlp(kind, x, p):
    h = x @ p["wi"]
    if kind == "swiglu":
        h = F.silu(x @ p["wg"]) * h
    elif kind == "geglu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["wg"], approximate="tanh") * h
    elif kind == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif kind == "relu2":
        h = torch.square(F.relu(h))
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AttnSpec:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    kind: str = "full"  # full | swa | chunked | bidir (the encoder's)
    window: int = 0  # swa window / chunk size
    use_rope: bool = True
    rope_theta: float = 1e4
    partial_rotary: float = 1.0
    qk_norm: bool = False
    q_block: int = 512
    k_block: int = 512


def init_attn(d, spec: AttnSpec, dtype, device, gen):
    hd, nq, nkv = spec.head_dim, spec.num_heads, spec.num_kv_heads
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": normal((d, nq, hd), s, dtype, device, gen),
        "wk": normal((d, nkv, hd), s, dtype, device, gen),
        "wv": normal((d, nkv, hd), s, dtype, device, gen),
        "wo": normal((nq, hd, d), 1.0 / math.sqrt(nq * hd), dtype, device,
                     gen),
    }
    if spec.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(hd, dtype=dtype, device=device)
    return p


def attn_axes(spec: AttnSpec):
    a = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if spec.qk_norm:
        a["q_norm"] = ("head_dim",)
        a["k_norm"] = ("head_dim",)
    return a


_X_AXES = ("batch", "seq", "embed_act")
_W_AXES = ("embed_full", "heads", "head_dim")
_KVW_AXES = ("embed_full", "kv_heads", "head_dim")
_O_AXES = ("batch", "seq", "heads_act", "head_dim")
_WO_AXES = ("heads", "head_dim", "embed_full")


def proj_heads(x, w, w_axes=_W_AXES, x_axes=_X_AXES):
    """x [B,S,D] @ w [D,N,H] -> [B,S,N,H] (``einsum("bsd,dnh->bsnh")``).
    Under a mesh it runs on local shards (``sharding.ctx.local_call``):
    w gathered whole along D (the ZeRO-3 gather), its heads as the rules
    shard them, x's rows as they are; the output is sharded as x's rows
    and w's heads. DTensor's own einsum splits a column-sharded output
    where N does not divide the mesh axis, which it cannot place."""
    return ctx.local_call(
        lambda x_, w_: torch.einsum("bsd,dnh->bsnh", x_, w_),
        (x, w), (x_axes, w_axes), x_axes[:2] + w_axes[1:])


def proj_out(o, w, o_axes=_O_AXES, w_axes=_WO_AXES):
    """o [B,S,N,H] @ w [N,H,D] -> [B,S,D] (``einsum("bsnh,nhd->bsd")``),
    under a mesh on local shards: a partial sum over the mesh axes that
    shard the heads, which ``local_call`` reduces once, in o's dtype."""
    return ctx.local_call(
        lambda o_, w_: torch.einsum("bsnh,nhd->bsd", o_, w_),
        (o, w), (o_axes, w_axes), o_axes[:2] + (None,),
        contracted=o_axes[2:] + w_axes[:2])


def _qkv(x, p, spec: AttnSpec, positions):
    q = proj_heads(x, p["wq"])
    k = proj_heads(x, p["wk"], _KVW_AXES)
    v = proj_heads(x, p["wv"], _KVW_AXES)
    if spec.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if spec.use_rope:
        q = apply_rope(q, positions, spec.rope_theta, spec.partial_rotary)
        k = apply_rope(k, positions, spec.rope_theta, spec.partial_rotary)
    return q, k, v


def _block_mask(kind, q_pos, k_pos, window):
    """bool[qb, kb]: True = attend. q_pos/k_pos absolute positions.

    Any other kind is causal, "bidir" included: the JAX package's mask
    (``repro.models.layers._block_mask``) knows only swa and chunked, so
    its encoder, which asks for "bidir", attends causally, and the port
    computes the same."""
    causal = k_pos[None, :] <= q_pos[:, None]
    if kind == "swa":
        return causal & (q_pos[:, None] - k_pos[None, :] < window)
    if kind == "chunked":
        return causal & (torch.div(q_pos[:, None], window, rounding_mode="floor")
                         == torch.div(k_pos[None, :], window,
                                      rounding_mode="floor"))
    return causal


def _attend_blocked(q, k, v, spec: AttnSpec, q_offset=0):
    """Softmax attention one query block at a time; q: [B,S,Nq,hd],
    k/v: [B,T,Nkv,hd].

    For swa/chunked kinds, each query block only visits the KV slice it
    can reach, so FLOPs ~ S * window. The JAX version halves the block
    until it divides S (a static ``lax.map``); here the last block is
    ragged instead, which computes the same function without shrinking
    the block to 1 for a prime prompt length.
    """
    B, S, NQ, HD = q.shape
    T = k.shape[1]
    NKV = k.shape[2]
    G = NQ // NKV
    scale = 1.0 / math.sqrt(HD)
    qb = min(spec.q_block, S)
    if spec.kind in ("swa", "chunked") and spec.window > 0:
        kv_span = min(T, ((spec.window + qb - 1) // qb + 1) * qb)
    else:
        kv_span = T
    qg = q.reshape(B, S, NKV, G, HD)
    out = []
    for q0 in range(0, S, qb):
        q1 = min(q0 + qb, S)
        q_pos = q_offset + torch.arange(q0, q1, device=q.device)
        start = max(min(q_offset + q1, T) - kv_span, 0)
        ks = k[:, start:start + kv_span]
        vs = v[:, start:start + kv_span]
        k_pos = start + torch.arange(ks.shape[1], device=q.device)
        s = torch.einsum("bqkgh,btkh->bkgqt", qg[:, q0:q1], ks).float() * scale
        m = _block_mask(spec.kind, q_pos, k_pos, spec.window)
        s = torch.where(m[None, None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out.append(torch.einsum("bkgqt,btkh->bqkgh", p.to(q.dtype), vs))
    return torch.cat(out, dim=1).reshape(B, S, NQ, HD)


_Q_AXES = ("batch", "seq_full", "heads_act", "head_dim")
_KV_AXES = ("batch", "seq_full", "kv_heads_act", "head_dim")


def _local_kv(q, k, v, G, h0):
    """The k/v heads that query heads h0 .. h0 + q.shape[2] - 1 read
    (kv head h // G for query head h, G query heads a kv head), with q's
    local heads in equal groups over them: k and v themselves where they
    hold exactly those heads, else a slice of them, else one kv head per
    query head."""
    hq, hk = q.shape[2], k.shape[2]
    if hq == hk * G:
        return k, v
    idx = [(h0 + h) // G for h in range(hq)]
    n = idx[-1] - idx[0] + 1
    if hq % n == 0 and idx == [idx[0] + h // (hq // n) for h in range(hq)]:
        return k[:, :, idx[0]:idx[0] + n], v[:, :, idx[0]:idx[0] + n]
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def self_attention(x, p, spec: AttnSpec, positions=None, q_offset=0,
                   kernel_impl="auto"):
    """Prefill self-attention. x: [B,S,D] -> ([B,S,D], (k, v)).

    ``kernel_impl`` picks kernel B4 or ``_attend_blocked``
    (``repro_torch.kernels.use_kernel``); under autograd B4's gradient is
    ``_attend_blocked``'s. Under a mesh q, k and v are constrained to the
    rules' heads (the JAX package's Megatron boundary) and either one
    runs on this rank's local heads: where the query heads shard and the
    kv heads do not divide the mesh axis, each rank reads the kv heads
    of its own query heads.
    """
    B, S, _ = x.shape
    if positions is None:
        positions = q_offset + torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(x, p, spec, positions)
    q = ctx.constrain(q, _Q_AXES)
    k = ctx.constrain(k, _KV_AXES)
    v = ctx.constrain(v, _KV_AXES)
    kernel = use_kernel(kernel_impl, x.device)
    if kernel and q_offset:
        raise ValueError("flash_attention takes queries from position 0")
    # "bidir" is causal in the model's mask (``_block_mask``), which is
    # B4's "full"
    kind = "full" if spec.kind == "bidir" else spec.kind
    shard = ctx.shard_index(q, _Q_AXES, 2)

    def attend(q_, k_, v_):
        k_, v_ = _local_kv(q_, k_, v_, spec.num_heads // spec.num_kv_heads,
                           shard * q_.shape[2])
        if kernel:
            return kernel_call(
                lambda a, b, c: flash_attention(a, b, c, kind=kind,
                                                window=spec.window),
                lambda a, b, c: _attend_blocked(a, b, c, spec),
                q_.contiguous(), k_.contiguous(), v_.contiguous(),
                name="flash_attention")
        return _attend_blocked(q_, k_, v_, spec, q_offset=q_offset)

    out = ctx.local_call(attend, (q, k, v), (_Q_AXES, _KV_AXES, _KV_AXES),
                         _Q_AXES)
    return proj_out(out, p["wo"]), (k, v)


def decode_rows(qg, k, v, valid, dtype, reduce_max=None, reduce_sum=None):
    """Decode attention over some of a cache's rows, as flash-decode
    splits it over the holders of the rows (one rank's arithmetic).

    qg [b, 1, Nkv, G, hd]: one token's queries in kv-head groups; k, v
    [b, t, Nkv, hd] and valid bool [b, t]: the rows held here. The row
    max and the row sum of ``exp(s - max)`` ([b, Nkv, G, 1, 1], f32) are
    combined with the other holders' by ``reduce_max`` and
    ``reduce_sum`` (None: these rows are all of them). Returns the sum of
    ``softmax · v`` over these rows, [b, 1, Nkv * G, hd] in ``dtype``: a
    partial sum whose sum over the holders is the attention output."""
    b, _, nkv, g, hd = qg.shape
    s = torch.einsum("bqkgh,btkh->bkgqt", qg, k).float() / math.sqrt(hd)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    if reduce_max is not None:
        m = reduce_max(m)
    e = torch.exp(s - m)
    den = e.sum(dim=-1, keepdim=True)
    if reduce_sum is not None:
        den = reduce_sum(den)
    pr = (e / den).to(dtype)
    return torch.einsum("bkgqt,btkh->bqkgh", pr, v).reshape(b, 1, nkv * g,
                                                            hd)


def _decode_write(x, p, spec: AttnSpec, cache_k, cache_v, pos, ring,
                  cache_kpos):
    """``decode_attention``'s first half: this token's k/v (and, with
    ``ring``, its position) written into the caches IN PLACE; returns its
    q [B,1,Nq,hd] and positions [B,1]."""
    B = x.shape[0]
    S = cache_k.shape[1]
    positions = torch.as_tensor(pos, device=x.device).reshape(-1, 1).expand(B, 1)
    q, k, v = _qkv(x, p, spec, positions)
    slot = positions[:, 0] % S if ring else torch.clamp(positions[:, 0], max=S - 1)
    bidx = torch.arange(B, device=x.device)
    if ctx.is_dtensor(cache_k):
        # a DTensor cache (its rows may be sharded) takes the write as a
        # masked select, the same values: DTensor cannot scatter into it
        at = (torch.arange(S, device=x.device)[None, :] == slot[:, None])
        cache_k.copy_(torch.where(at[..., None, None], k, cache_k))
        cache_v.copy_(torch.where(at[..., None, None], v, cache_v))
    else:
        cache_k[bidx, slot] = k[:, 0]
        cache_v[bidx, slot] = v[:, 0]
    if ring:
        if ctx.is_dtensor(cache_kpos):
            cache_kpos.copy_(torch.where(at, positions[:, :1].to(
                cache_kpos.dtype), cache_kpos))
        else:
            cache_kpos[bidx, slot] = positions[:, 0].to(cache_kpos.dtype)
    return q, positions[:, :1]


def _valid_rows(spec: AttnSpec, positions, ring, kpos, row0, t):
    """bool [b, t]: the cache rows the token at ``positions`` [b, 1]
    reads, a linear cache's t rows from ``row0`` or, with ``ring``, a
    ring cache's rows at positions ``kpos`` [b, t] (-1: unwritten)."""
    if ring:
        rows, valid = kpos, kpos >= 0
    else:
        rows = row0 + torch.arange(t, device=positions.device)[None, :]
        valid = rows <= positions
    if spec.kind == "swa" and spec.window:
        valid = valid & (positions - rows < spec.window)
    elif spec.kind == "chunked" and spec.window:
        valid = valid & (torch.div(rows, spec.window, rounding_mode="floor")
                         == torch.div(positions, spec.window,
                                      rounding_mode="floor"))
    return valid


def decode_attention(x, p, spec: AttnSpec, cache_k, cache_v, pos,
                     ring: bool = False, cache_kpos=None):
    """Single-token decode. x: [B,1,D]; cache: [B,S,Nkv,hd]; pos: [B].

    Writes this token's k/v (and, with ``ring=True``, its absolute
    position into ``cache_kpos`` [B,S]) into the caches IN PLACE, then
    attends over them; returns out [B,1,D]. With ``ring=True`` the cache
    length is the attention window and writes wrap; ``cache_kpos`` keeps
    the SWA/chunked masks exact across wraps.
    """
    S = cache_k.shape[1]
    q, positions = _decode_write(x, p, spec, cache_k, cache_v, pos, ring,
                                 cache_kpos)
    NQ, HD = spec.num_heads, spec.head_dim
    NKV = spec.num_kv_heads
    G = NQ // NKV

    def attend(q_, k_, v_, valid_):
        b, hq = q_.shape[0], q_.shape[2]
        k_, v_ = _local_kv(q_, k_, v_, G, shard * hq)
        qg = q_.reshape(b, 1, k_.shape[2], hq // k_.shape[2], HD)
        s = torch.einsum("bqkgh,btkh->bkgqt", qg, k_).float() / math.sqrt(HD)
        s = torch.where(valid_[:, None, None, None, :], s, NEG_INF)
        pr = torch.softmax(s, dim=-1).to(x.dtype)
        return torch.einsum("bkgqt,btkh->bqkgh", pr, v_).reshape(b, 1, hq,
                                                                 HD)

    # under a mesh on each rank's heads, where the cache's rows are whole
    # on every rank; a cache sharded along its rows (``cache_seq``) runs
    # as flash-decode on each rank's rows (``decode_rows``), its one-token
    # q gathered over the heads first: the row max and the row sum of exp
    # reduced once each in f32 (one number a row), the weighted V partial
    # sum once in the activation dtype, as the JAX package's compiled
    # step partitions its softmax; no score leaves its rank
    c_axes = ("batch", "cache_seq", "kv_heads_act", "head_dim")
    cp = ctx.placements(cache_k, c_axes)
    if cp is None or not any(pl.is_shard(1) for pl in cp):
        shard = ctx.shard_index(q, _DQ_AXES, 2)
        valid = _valid_rows(spec, positions, ring, cache_kpos, 0, S)
        out = ctx.local_call(attend, (q, cache_k, cache_v, valid),
                             (_DQ_AXES, c_axes, c_axes,
                              ("batch", "cache_seq")), _DQ_AXES)
    else:
        seq_dims = [m for m, pl in enumerate(cp) if pl.is_shard(1)]
        seq_shard = ctx.shard_index(cache_k, c_axes, 1)

        def attend_rows(q_, k_, v_, positions_, kpos_=None):
            t = k_.shape[1]
            valid_ = _valid_rows(spec, positions_, ring, kpos_,
                                 seq_shard * t, t)
            return decode_rows(
                q_.reshape(q_.shape[0], 1, NKV, G, HD), k_, v_, valid_,
                x.dtype,
                reduce_max=lambda a: ctx.reduce_local(a, "max", seq_dims),
                reduce_sum=lambda a: ctx.reduce_local(a, "sum", seq_dims))

        q_axes = ("batch", "seq", None, "head_dim")
        out = ctx.local_call(
            attend_rows, (q, cache_k, cache_v, positions)
            + ((cache_kpos,) if ring else ()),
            (q_axes, c_axes, c_axes, ("batch", None))
            + ((("batch", "cache_seq"),) if ring else ()),
            q_axes, contracted=("cache_seq",))
    return proj_out(out, p["wo"])


_DQ_AXES = ("batch", None, "heads_act", "head_dim")


def _attend_memory(q, k, v, dtype):
    """Unmasked attention of q [B,S,Nq,hd] over a memory k/v [B,T,Nkv,hd];
    under a mesh on each rank's heads, as ``self_attention``."""
    G = q.shape[2] // k.shape[2]
    shard = ctx.shard_index(q, _Q_AXES, 2)

    def attend(q_, k_, v_):
        B, S, NQ, HD = q_.shape
        k_, v_ = _local_kv(q_, k_, v_, G, shard * NQ)
        NKV = k_.shape[2]
        qg = q_.reshape(B, S, NKV, NQ // NKV, HD)
        s = torch.einsum("bqkgh,btkh->bkgqt", qg, k_).float() / math.sqrt(HD)
        pr = torch.softmax(s, dim=-1).to(dtype)
        return torch.einsum("bkgqt,btkh->bqkgh", pr, v_).reshape(B, S, NQ,
                                                                 HD)

    return ctx.local_call(attend, (q, k, v), (_Q_AXES, _KV_AXES, _KV_AXES),
                          _Q_AXES)


def cross_attention(x, p, spec: AttnSpec, kv_tokens):
    """Cross-attention to a static memory. x: [B,S,D]; kv_tokens: [B,T,D].
    Returns (out [B,S,D], (k, v) [B,T,Nkv,hd])."""
    q = proj_heads(x, p["wq"])
    k = proj_heads(kv_tokens, p["wk"], _KVW_AXES)
    v = proj_heads(kv_tokens, p["wv"], _KVW_AXES)
    if spec.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    out = _attend_memory(q, k, v, x.dtype)
    return proj_out(out, p["wo"]), (k, v)


def cross_attention_cached(x, p, spec: AttnSpec, k, v):
    """Decode-time cross-attention against precomputed k/v [B,T,Nkv,hd]."""
    q = proj_heads(x, p["wq"])
    if spec.qk_norm:
        q = rmsnorm(q, p["q_norm"])
    out = _attend_memory(q, k, v, x.dtype)
    return proj_out(out, p["wo"])
