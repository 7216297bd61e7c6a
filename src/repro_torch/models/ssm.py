"""Attention-free mixers: the RWKV6 time mix and channel mix, and the
Mamba-style selective SSM head of Hymba's hybrid layers (the port of
``repro.models.ssm``).

The time mix is a linear-time recurrence: prefill runs it over the
prompt and decode runs one step of it, carrying a [B,H,hd,hd] state.
Both go through kernel B5 (``kernels.rwkv6_scan``, hand-written CUDA)
where ``use_kernel(kernel_impl, device)`` says so, and otherwise through
its plain version, the loop over time the JAX package runs as a
``lax.scan``. Under autograd B5's backward is the plain version's
(``kernels.autograd.kernel_call``). Under a mesh either one runs on each
rank's local heads (``sharding.ctx.local_call``); the norm over all
heads after it stays a DTensor op, reduced over the shards. The
projections, the decay and the
norms are plain PyTorch, as the JAX package left them to XLA.

The Mamba head has no kernel in the JAX package: it is the same loop over
time on an f32 [B,H,hd,N] state, a ``lax.scan`` there, plain PyTorch here
(in place, or out of place where autograd records it).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import use_kernel
from repro_torch.kernels.autograd import kernel_call, needs_grad
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
from repro_torch.models.layers import (
    normal,
    proj_heads,
    proj_out,
    rmsnorm,
)
from repro_torch.sharding import ctx

# the scan's operands [B,H,S,hd] / [B,H,hd,hd] and the bonus u [H,hd]
_SCAN_AXES = ("batch", "heads_act", None, None)
_U_AXES = ("heads_act", None)


# ---------------------------------------------------------------------------
# RWKV6 ("Finch") time mix with data-dependent decay
# ---------------------------------------------------------------------------
def init_rwkv_timemix(d, n_heads, head_dim, dtype, device, gen, lora_dim=64):
    s = 1.0 / math.sqrt(d)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    def rand(shape, scale):
        return normal(shape, scale, dtype, device, gen)

    return {
        "mix_r": full((d,), 0.5),
        "mix_k": full((d,), 0.5),
        "mix_v": full((d,), 0.5),
        "mix_g": full((d,), 0.5),
        "mix_w": full((d,), 0.5),
        "wr": rand((d, n_heads, head_dim), s),
        "wk": rand((d, n_heads, head_dim), s),
        "wv": rand((d, n_heads, head_dim), s),
        "wg": rand((d, n_heads, head_dim), s),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x A) B))
        "w0": full((n_heads, head_dim), -6.0),
        "wa": rand((d, lora_dim), s),
        "wb": rand((lora_dim, n_heads, head_dim), 1.0 / math.sqrt(lora_dim)),
        "u": rand((n_heads, head_dim), 0.1),
        "wo": rand((n_heads, head_dim, d), 1.0 / math.sqrt(n_heads * head_dim)),
        "ln_x": torch.ones(n_heads * head_dim, dtype=dtype, device=device),
    }


def rwkv_timemix_axes():
    return {
        "mix_r": ("embed",),
        "mix_k": ("embed",),
        "mix_v": ("embed",),
        "mix_g": ("embed",),
        "mix_w": ("embed",),
        "wr": ("embed", "heads", "head_dim"),
        "wk": ("embed", "heads", "head_dim"),
        "wv": ("embed", "heads", "head_dim"),
        "wg": ("embed", "heads", "head_dim"),
        "w0": ("heads", "head_dim"),
        "wa": ("embed", "lora"),
        "wb": ("lora", "heads", "head_dim"),
        "u": ("heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
        "ln_x": ("embed",),
    }


def _shifted(x, x_prev):
    """x shifted one step right in time, ``x_prev`` [B,D] in front."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _rwkv_inputs(x, x_prev, p):
    """Token-shift mixing + projections. x: [B,S,D]; x_prev: [B,D].
    Returns r, k, v, g [B,S,H,hd] in x's type and the decay [B,S,H,hd]
    in f32."""
    shifted = _shifted(x, x_prev)

    def mx(m):
        return x + (shifted - x) * m

    r = proj_heads(mx(p["mix_r"]), p["wr"])
    k = proj_heads(mx(p["mix_k"]), p["wk"])
    v = proj_heads(mx(p["mix_v"]), p["wv"])
    g = proj_heads(mx(p["mix_g"]), p["wg"])
    # the decay LoRA as the JAX package's compiled step splits it: x @ wa
    # on each rank's rows with wa gathered whole (every lora column on
    # every model rank), lo @ wb on the model axis's heads
    lo = torch.tanh(ctx.local_call(
        lambda x_, w_: torch.einsum("bsd,dl->bsl", x_, w_),
        (mx(p["mix_w"]), p["wa"]),
        (("batch", "seq", "embed_act"), ("embed_full", "lora")),
        ("batch", "seq", "lora")))
    # w0 + lora in the model's type, then f32 for exp(-exp(.))
    wdec = torch.exp(-torch.exp(
        (p["w0"][None, None] + proj_heads(lo, p["wb"],
                                          ("lora", "heads", "head_dim"),
                                          ("batch", "seq", "lora")))
        .float()))
    return r, k, v, g, wdec


def rwkv_timemix(x, x_prev, state, p, kernel_impl="auto", state_out=None):
    """RWKV6 WKV recurrence.

    x: [B,S,D]; x_prev: [B,D] (the last token before x); state:
    [B,H,hd,hd] f32 (key x value outer-product state). Returns (out
    [B,S,D], new x_prev [B,D], new state). With ``state_out`` the new
    state is written there (it may be ``state`` itself) and returned.
    ``kernel_impl`` picks kernel B5 or its plain version
    (``repro_torch.kernels.use_kernel``). Under autograd B5's gradient is
    the plain version's, and ``state_out`` raises: the kernel would write
    it behind autograd's back.
    """
    B, S, _ = x.shape
    H, HD = p["u"].shape
    r, k, v, g, wdec = _rwkv_inputs(x, x_prev, p)
    # f32 for the scan, as [B,H,S,hd] views of [B,S,H,hd] tensors
    r, k, v, wdec = (a.float().contiguous().transpose(1, 2)
                     for a in (r, k, v, wdec))
    u = p["u"].float()
    kernel = use_kernel(kernel_impl, x.device)
    if kernel and state_out is not None and needs_grad(r, k, v, wdec, u,
                                                       state):
        raise ValueError("rwkv_timemix: state_out under autograd")

    # a DTensor state (under a mesh) is written after the local scan
    sharded = ctx.is_dtensor(state) or ctx.is_dtensor(r)
    out_to = None if sharded else state_out

    def scan(*a):
        if kernel:
            return kernel_call(
                lambda *b: rwkv6_scan(*b, state_out=out_to),
                rwkv6_scan_ref, *a, name="rwkv6_scan")
        o_, st_ = rwkv6_scan_ref(*a)
        if out_to is not None:
            st_ = out_to.copy_(st_)
        return o_, st_

    o, state = ctx.local_call(scan, (r, k, v, wdec, u, state),
                              (_SCAN_AXES,) * 4 + (_U_AXES, _SCAN_AXES),
                              (_SCAN_AXES, _SCAN_AXES))
    if sharded and state_out is not None:
        state = state_out.copy_(state)
    out = o.transpose(1, 2).reshape(B, S, H * HD)
    # the norm's weight whole (ZeRO-3): DTensor would shard the
    # normalized heads along the weight's own embed sharding
    out = rmsnorm(out, ctx.constrain(p["ln_x"], ("embed_full",))).to(x.dtype)
    out = out * F.silu(g.reshape(B, S, H * HD))
    out = proj_out(out.reshape(B, S, H, HD), p["wo"])
    return out, x[:, -1, :], state


# ---------------------------------------------------------------------------
# RWKV6 channel mix (squared ReLU)
# ---------------------------------------------------------------------------
def init_rwkv_channelmix(d, ff, dtype, device, gen):
    return {
        "mix_k": torch.full((d,), 0.5, dtype=dtype, device=device),
        "wk": normal((d, ff), 1.0 / math.sqrt(d), dtype, device, gen),
        "wv": normal((ff, d), 1.0 / math.sqrt(ff), dtype, device, gen),
    }


def rwkv_channelmix_axes():
    return {"mix_k": ("embed",), "wk": ("embed", "mlp"), "wv": ("mlp", "embed")}


def rwkv_channelmix(x, x_prev, p):
    """x: [B,S,D]; x_prev: [B,D]. Returns (out [B,S,D], new x_prev)."""
    xk = x + (_shifted(x, x_prev) - x) * p["mix_k"]

    def f(x_, wk, wv):
        return torch.square(F.relu(x_ @ wk)) @ wv

    out = ctx.local_call(
        f, (xk, p["wk"], p["wv"]),
        (_X_AXES, ("embed_full", "mlp"), ("mlp", "embed_full")),
        _X_AXES[:2] + (None,), contracted=("mlp",))
    return out, x[:, -1, :]


# ---------------------------------------------------------------------------
# Mamba-style selective SSM head (Hymba's parallel branch)
# ---------------------------------------------------------------------------
def init_mamba_head(d, n_heads, head_dim, state_dim, dtype, device, gen):
    s = 1.0 / math.sqrt(d)

    def rand(shape, scale):
        return normal(shape, scale, dtype, device, gen)

    return {
        "wx": rand((d, n_heads, head_dim), s),
        "wz": rand((d, n_heads, head_dim), s),
        "wB": rand((d, state_dim), s),
        "wC": rand((d, state_dim), s),
        "wdt": rand((d, n_heads), s),
        "dt_bias": torch.zeros(n_heads, dtype=dtype, device=device),
        "A_log": torch.zeros(n_heads, dtype=dtype, device=device),
        "D": torch.ones((n_heads, head_dim), dtype=dtype, device=device),
        "wo": rand((n_heads, head_dim, d), 1.0 / math.sqrt(n_heads * head_dim)),
        "ln": torch.ones(n_heads * head_dim, dtype=dtype, device=device),
    }


def mamba_head_axes():
    return {
        "wx": ("embed", "heads", "head_dim"),
        "wz": ("embed", "heads", "head_dim"),
        "wB": ("embed", "ssm_state"),
        "wC": ("embed", "ssm_state"),
        "wdt": ("embed", "heads"),
        "dt_bias": ("heads",),
        "A_log": ("heads",),
        "D": ("heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
        "ln": ("embed",),
    }


def mamba_head(x, state, p):
    """Selective SSM. x: [B,S,D]; state: [B,H,hd,N] f32 (not modified).

    Returns (out [B,S,D], new state). Each cast sits where the JAX
    package has it: B, C and the softplus of dt (+ ``dt_bias``, in x's
    type) go to f32 after their products in x's type, ``A_log`` to f32
    before its exp; the loop over time runs in f32. Under a mesh the
    projections and the loop run on each rank's heads
    (``sharding.ctx.local_call``); the norm over all heads after them
    stays a DTensor op, reduced over the shards.
    """
    B, S, _ = x.shape
    H, HD = p["D"].shape
    names = ("wx", "wz", "wB", "wC", "wdt", "dt_bias", "A_log", "D")
    y, st = ctx.local_call(
        _mamba_core, (x, state, *[p[n] for n in names]),
        (_X_AXES, _STATE_AXES, *[_MAMBA_AXES[n] for n in names]),
        (("batch", "seq", "heads", "head_dim"), _STATE_AXES))
    y = rmsnorm(y.reshape(B, S, H * HD),
                ctx.constrain(p["ln"], ("embed_full",))).to(x.dtype)
    return proj_out(y.reshape(B, S, H, HD), p["wo"]), st


_X_AXES = ("batch", "seq", "embed_act")
_STATE_AXES = ("batch", "heads_act", None, None)
# the weights gathered whole along the embedding (ZeRO-3), heads sharded
_MAMBA_AXES = {
    "wx": ("embed_full", "heads", "head_dim"),
    "wz": ("embed_full", "heads", "head_dim"),
    "wB": ("embed_full", "ssm_state"),
    "wC": ("embed_full", "ssm_state"),
    "wdt": ("embed_full", "heads"),
    "dt_bias": ("heads",),
    "A_log": ("heads",),
    "D": ("heads", "head_dim"),
}


def _mamba_core(x, state, wx, wz, wB, wC, wdt, dt_bias, A_log, D):
    """The Mamba head up to its norm: (y [B,S,H,hd] f32, new state)."""
    B, S, _ = x.shape
    H, HD = D.shape
    xh = torch.einsum("bsd,dnh->bsnh", x, wx)
    z = torch.einsum("bsd,dnh->bsnh", x, wz)
    Bt = (x @ wB).float()  # [B,S,N]
    Ct = (x @ wC).float()
    dt = F.softplus(x @ wdt + dt_bias).float()  # [B,S,H]
    A = -torch.exp(A_log.float())  # [H]
    decay = torch.exp(dt * A[None, None, :])  # [B,S,H]
    x32 = xh.float()
    inp = dt[..., None] * x32  # [B,S,H,hd]: dt_t * x_t of every step
    st = state.float().clone()
    N = st.shape[-1]
    if needs_grad(inp, decay, Bt, Ct):
        # st = decay_t * st + (dt_t * x_t) outer B_t; y_t = st . C_t: the
        # three kernels a step out of place, for autograd, the inputs
        # split over time once (``unbind``: its backward is one stack,
        # where indexing a step would scatter into the whole input each
        # step)
        ys = []
        for dec_t, inp_t, b_t, c_t in zip(decay.unbind(1), inp.unbind(1),
                                          Bt.unbind(1), Ct.unbind(1)):
            st = torch.addcmul(st * dec_t[:, :, None, None],
                               inp_t[..., None], b_t[:, None, None, :])
            ys.append(torch.bmm(st.view(B, H * HD, N), c_t[:, :, None]))
        ys = torch.stack(ys)
    else:
        # the same three kernels in place: serving's host issues every
        # one, and the out-of-place loop's allocations made hymba-1.5b's
        # prefill about 11% slower on an H100 (PERF.md, section 6)
        rows = st.view(B, H * HD, N)  # y_t = rows . C_t
        ys = torch.empty((S, B, H * HD, 1), dtype=torch.float32,
                         device=x.device)
        for t in range(S):
            st.mul_(decay[:, t, :, None, None])
            st.addcmul_(inp[:, t, :, :, None], Bt[:, t, None, None, :])
            torch.bmm(rows, Ct[:, t, :, None], out=ys[t])
    y = ys[..., 0].transpose(0, 1).reshape(B, S, H, HD)
    y = y + D[None, None].float() * x32
    return y * F.silu(z.float()), st
