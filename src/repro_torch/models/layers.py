"""Shared building blocks: norms, RoPE, MLPs, attention (all mask kinds).

The port of ``repro.models.layers``, same functions and parameter
layouts (``wq/wk/wv [d, heads, head_dim]``, ``wo [heads, head_dim, d]``,
MLP ``wi/wg [d, ff]``, ``wo [ff, d]``), with the sharding constraints
dropped (one card has no mesh).

Prefill attention goes through kernel B4 (``kernels.flash_attention``,
hand-written CUDA) where ``use_kernel(kernel_impl, device)`` says so, and
otherwise through ``_attend_blocked``, the model's plain formulation.
Under autograd B4's backward is ``_attend_blocked``'s
(``kernels.autograd.kernel_call``). Decode attention, cross-attention,
the MLP, the norms and the projections are plain PyTorch, as the JAX
package left them to XLA.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import use_kernel
from repro_torch.kernels.autograd import kernel_call
from repro_torch.kernels.flash_attention.ops import flash_attention

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x, w, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
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


def apply_mlp(kind, x, p):
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


def _qkv(x, p, spec: AttnSpec, positions):
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    k = torch.einsum("bsd,dnh->bsnh", x, p["wk"])
    v = torch.einsum("bsd,dnh->bsnh", x, p["wv"])
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


def self_attention(x, p, spec: AttnSpec, positions=None, q_offset=0,
                   kernel_impl="auto"):
    """Prefill self-attention. x: [B,S,D] -> ([B,S,D], (k, v)).

    ``kernel_impl`` picks kernel B4 or ``_attend_blocked``
    (``repro_torch.kernels.use_kernel``); under autograd B4's gradient is
    ``_attend_blocked``'s.
    """
    B, S, _ = x.shape
    if positions is None:
        positions = q_offset + torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(x, p, spec, positions)
    if use_kernel(kernel_impl, x.device):
        if q_offset:
            raise ValueError("flash_attention takes queries from position 0")
        # "bidir" is causal in the model's mask (``_block_mask``), which is
        # B4's "full"
        kind = "full" if spec.kind == "bidir" else spec.kind
        out = kernel_call(
            lambda q_, k_, v_: flash_attention(q_, k_, v_, kind=kind,
                                               window=spec.window),
            lambda q_, k_, v_: _attend_blocked(q_, k_, v_, spec),
            q.contiguous(), k.contiguous(), v.contiguous(),
            name="flash_attention")
    else:
        out = _attend_blocked(q, k, v, spec, q_offset=q_offset)
    return torch.einsum("bsnh,nhd->bsd", out, p["wo"]), (k, v)


def decode_attention(x, p, spec: AttnSpec, cache_k, cache_v, pos,
                     ring: bool = False, cache_kpos=None):
    """Single-token decode. x: [B,1,D]; cache: [B,S,Nkv,hd]; pos: [B].

    Writes this token's k/v (and, with ``ring=True``, its absolute
    position into ``cache_kpos`` [B,S]) into the caches IN PLACE, then
    attends over them; returns out [B,1,D]. With ``ring=True`` the cache
    length is the attention window and writes wrap; ``cache_kpos`` keeps
    the SWA/chunked masks exact across wraps.
    """
    B = x.shape[0]
    S = cache_k.shape[1]
    positions = torch.as_tensor(pos, device=x.device).reshape(-1, 1).expand(B, 1)
    q, k, v = _qkv(x, p, spec, positions)
    slot = positions[:, 0] % S if ring else torch.clamp(positions[:, 0], max=S - 1)
    bidx = torch.arange(B, device=x.device)
    cache_k[bidx, slot] = k[:, 0]
    cache_v[bidx, slot] = v[:, 0]

    NQ, HD = spec.num_heads, spec.head_dim
    NKV = spec.num_kv_heads
    G = NQ // NKV
    qg = q.reshape(B, 1, NKV, G, HD)
    s = torch.einsum("bqkgh,btkh->bkgqt", qg, cache_k).float() / math.sqrt(HD)
    if ring:
        cache_kpos[bidx, slot] = positions[:, 0].to(cache_kpos.dtype)
        valid = cache_kpos >= 0
        if spec.kind == "swa" and spec.window:
            valid &= positions[:, :1] - cache_kpos < spec.window
        elif spec.kind == "chunked" and spec.window:
            valid &= (torch.div(cache_kpos, spec.window, rounding_mode="floor")
                      == torch.div(positions[:, :1], spec.window,
                                   rounding_mode="floor"))
    else:
        k_abs = torch.arange(S, device=x.device)[None, :]
        valid = k_abs <= positions[:, :1]
        if spec.kind == "swa" and spec.window:
            valid &= k_abs > positions[:, :1] - spec.window
        elif spec.kind == "chunked" and spec.window:
            valid &= (torch.div(k_abs, spec.window, rounding_mode="floor")
                      == torch.div(positions[:, :1], spec.window,
                                   rounding_mode="floor"))
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    pr = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bkgqt,btkh->bqkgh", pr, cache_v).reshape(B, 1, NQ, HD)
    return torch.einsum("bsnh,nhd->bsd", out, p["wo"])


def _attend_memory(q, k, v, dtype):
    """Unmasked attention of q [B,S,Nq,hd] over a memory k/v [B,T,Nkv,hd]."""
    B, S, NQ, HD = q.shape
    NKV = k.shape[2]
    qg = q.reshape(B, S, NKV, NQ // NKV, HD)
    s = torch.einsum("bqkgh,btkh->bkgqt", qg, k).float() / math.sqrt(HD)
    pr = torch.softmax(s, dim=-1).to(dtype)
    return torch.einsum("bkgqt,btkh->bqkgh", pr, v).reshape(B, S, NQ, HD)


def cross_attention(x, p, spec: AttnSpec, kv_tokens):
    """Cross-attention to a static memory. x: [B,S,D]; kv_tokens: [B,T,D].
    Returns (out [B,S,D], (k, v) [B,T,Nkv,hd])."""
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    k = torch.einsum("btd,dnh->btnh", kv_tokens, p["wk"])
    v = torch.einsum("btd,dnh->btnh", kv_tokens, p["wv"])
    if spec.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    out = _attend_memory(q, k, v, x.dtype)
    return torch.einsum("bsnh,nhd->bsd", out, p["wo"]), (k, v)


def cross_attention_cached(x, p, spec: AttnSpec, k, v):
    """Decode-time cross-attention against precomputed k/v [B,T,Nkv,hd]."""
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    if spec.qk_norm:
        q = rmsnorm(q, p["q_norm"])
    out = _attend_memory(q, k, v, x.dtype)
    return torch.einsum("bsnh,nhd->bsd", out, p["wo"])
