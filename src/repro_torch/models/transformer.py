"""Layer blocks and whole-model assembly for every mixer: attention (with
a dense MLP or a MoE FFN), rwkv, and the hybrid attention + Mamba head;
cross-attention layers, learned positions and the encoder (the port of
``repro.models.transformer``).

The JAX package stacks each pattern position's weights over
``pattern_repeats`` and scans them; the port keeps one plain dict of
tensors per layer in ``params["layers"]``, in the scan's order: for each
repeat r the pattern positions l0, l1, ...; then the tail
(``layer_specs``). The encoder's layers are ``params["encoder"]``, a list
in order. Early fusion (llama4-maverick) is ``_embed``'s: the first
``early_fusion_tokens`` rows of the embedded prompt are replaced by
``extras["vision_embeds"]``.

Training (``loss_fn``) rematerialises each layer under
``torch.utils.checkpoint`` where grad mode is on (the JAX package
checkpoints each pattern repeat); under ``torch.no_grad()``, as in
serving, ``forward`` runs the layers as they are.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as S
from repro_torch.sharding import ctx

_RESID = ("batch", "seq", "embed_act")  # the residual stream's axes

# the encoder's layers: attention without RoPE and a dense MLP
ENC_SPEC = LayerSpec(mixer="attn", attn_kind="full", use_rope=False)


def layer_specs(cfg: ModelConfig) -> list[LayerSpec]:
    """Every layer's spec in execution order (the JAX scan's order)."""
    return list(cfg.pattern) * cfg.pattern_repeats + list(cfg.tail)


# ---------------------------------------------------------------------------
# per-layer params
# ---------------------------------------------------------------------------
def attn_spec(cfg: ModelConfig, spec: LayerSpec, bidir=False) -> L.AttnSpec:
    theta = cfg.rope_theta
    if spec.attn_kind == "full" and cfg.rope_theta_global is not None:
        theta = cfg.rope_theta_global
    return L.AttnSpec(
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        kind="bidir" if bidir else spec.attn_kind,
        window=cfg.window,
        use_rope=spec.use_rope and cfg.pos_embedding == "rope",
        rope_theta=theta,
        partial_rotary=cfg.partial_rotary,
        qk_norm=cfg.qk_norm,
    )


def has_self_attention(spec: LayerSpec) -> bool:
    return spec.mixer in ("attn", "hybrid") and spec.attn_kind != "none"


def init_layer(cfg: ModelConfig, spec: LayerSpec, device, gen):
    dt = getattr(torch, cfg.dtype)
    d = cfg.d_model
    if spec.mixer == "rwkv":
        return {
            "ln_tm": L.init_norm(cfg.norm, d, dt, device),
            "tm": S.init_rwkv_timemix(d, cfg.ssm_heads, cfg.head_dim, dt,
                                      device, gen),
            "ln_cm": L.init_norm(cfg.norm, d, dt, device),
            "cm": S.init_rwkv_channelmix(d, cfg.d_ff, dt, device, gen),
        }
    p = {}
    if has_self_attention(spec):
        p["ln_attn"] = L.init_norm(cfg.norm, d, dt, device)
        p["attn"] = L.init_attn(d, attn_spec(cfg, spec), dt, device, gen)
    if spec.mixer == "hybrid":
        p["ssm"] = S.init_mamba_head(d, cfg.ssm_heads or cfg.num_heads,
                                     cfg.head_dim, cfg.ssm_state, dt, device,
                                     gen)
    if spec.has_cross:
        p["ln_cross"] = L.init_norm(cfg.norm, d, dt, device)
        p["cross"] = L.init_attn(d, attn_spec(cfg, spec), dt, device, gen)
        if cfg.gated_cross:  # tanh(0) = 0: a new cross layer starts shut
            p["cross_gate"] = torch.zeros((), dtype=dt, device=device)
    p["ln_mlp"] = L.init_norm(cfg.norm, d, dt, device)
    if spec.is_moe:
        p["moe"] = MOE.init_moe(
            d, cfg.expert_d_ff or cfg.d_ff, cfg.num_experts, dt, device, gen,
            mlp_kind=cfg.mlp, shared_expert=cfg.moe_shared_expert)
    else:
        p["mlp"] = L.init_mlp(cfg.mlp, d, cfg.d_ff, dt, device, gen)
    return p


def layer_axes(cfg: ModelConfig, spec: LayerSpec):
    """One layer's logical axes, leaf for leaf as ``init_layer``'s."""
    if spec.mixer == "rwkv":
        return {
            "ln_tm": L.norm_axes(cfg.norm),
            "tm": S.rwkv_timemix_axes(),
            "ln_cm": L.norm_axes(cfg.norm),
            "cm": S.rwkv_channelmix_axes(),
        }
    a = {}
    if has_self_attention(spec):
        a["ln_attn"] = L.norm_axes(cfg.norm)
        a["attn"] = L.attn_axes(attn_spec(cfg, spec))
    if spec.mixer == "hybrid":
        a["ssm"] = S.mamba_head_axes()
    if spec.has_cross:
        a["ln_cross"] = L.norm_axes(cfg.norm)
        a["cross"] = L.attn_axes(attn_spec(cfg, spec))
        if cfg.gated_cross:
            a["cross_gate"] = ()
    a["ln_mlp"] = L.norm_axes(cfg.norm)
    if spec.is_moe:
        a["moe"] = MOE.moe_axes(cfg.mlp, cfg.moe_shared_expert)
    else:
        a["mlp"] = L.mlp_axes(cfg.mlp)
    return a


def ssm_state_shape(cfg: ModelConfig, batch: int) -> tuple:
    """A hybrid layer's Mamba state: [B, H, hd, N]."""
    return (batch, cfg.ssm_heads or cfg.num_heads, cfg.head_dim,
            cfg.ssm_state)


# ---------------------------------------------------------------------------
# layer application (full sequence: prefill)
# ---------------------------------------------------------------------------
def _mlp_or_moe(x, p, cfg, spec, kernel_impl="auto"):
    """The FFN half of an attention layer: (out, aux); ``kernel_impl``
    picks kernel B3 for a MoE layer's dispatch plan."""
    h = L.apply_norm(cfg.norm, x, p["ln_mlp"])
    if spec.is_moe:
        return MOE.apply_moe(
            h, p["moe"], top_k=cfg.experts_per_token,
            capacity_factor=cfg.capacity_factor, mlp_kind=cfg.mlp,
            mode=cfg.moe_mode, dispatch_shards=cfg.moe_dispatch_shards,
            weight_gather=cfg.moe_weight_gather, kernel_impl=kernel_impl)
    return L.apply_mlp(cfg.mlp, h, p["mlp"]), 0.0


def rwkv_layer(x, p, cfg, tm_x, cm_x, state, *, kernel_impl="auto",
               state_out=None):
    """An rwkv layer (time mix, then channel mix) over x [B,S,D] from the
    token-shift rows ``tm_x``/``cm_x`` [B,D] and the time mix's state.
    Returns (x, {"tm_x", "cm_x", "state"} after x); ``state_out`` as in
    ``ssm.rwkv_timemix``."""
    h = L.apply_norm(cfg.norm, x, p["ln_tm"])
    o, tmx, st = S.rwkv_timemix(h, tm_x, state, p["tm"],
                                kernel_impl=kernel_impl, state_out=state_out)
    x = x + o
    h = L.apply_norm(cfg.norm, x, p["ln_cm"])
    o, cmx = S.rwkv_channelmix(h, cm_x, p["cm"])
    return x + o, {"tm_x": tmx, "cm_x": cmx, "state": st}


def gated(o, p):
    """A cross layer's output through its gate, ``tanh(cross_gate) * o``,
    where the config gates (llama-3.2-vision; whisper does not)."""
    if "cross_gate" in p:
        return torch.tanh(p["cross_gate"]) * o
    return o


def apply_layer(x, p, cfg, spec, *, cross_tokens=None, want_cache=False,
                kernel_impl="auto"):
    """One layer over the whole sequence, from an empty cache. Returns (x,
    aux, cache entry or None); the entry holds a self-attention layer's k
    and v [B,S,Nkv,hd], a hybrid layer's Mamba ``state``, a cross layer's
    ``ck``/``cv`` [B,T,Nkv,hd] over ``cross_tokens`` [B,T,D], and an rwkv
    layer's ``tm_x``, ``cm_x`` and ``state``."""
    if spec.mixer == "rwkv":
        B = x.shape[0]
        z = torch.zeros((B, cfg.d_model), dtype=x.dtype, device=x.device)
        st0 = torch.zeros((B, cfg.ssm_heads, cfg.head_dim, cfg.head_dim),
                          dtype=torch.float32, device=x.device)
        x, newc = rwkv_layer(x, p, cfg, z, z, st0, kernel_impl=kernel_impl)
        return x, 0.0, (newc if want_cache else None)
    newc = {}
    if has_self_attention(spec):
        h = L.apply_norm(cfg.norm, x, p["ln_attn"])
        o, (newc["k"], newc["v"]) = L.self_attention(
            h, p["attn"], attn_spec(cfg, spec), kernel_impl=kernel_impl)
        if spec.mixer == "hybrid":
            st0 = torch.zeros(ssm_state_shape(cfg, x.shape[0]),
                              dtype=torch.float32, device=x.device)
            o2, newc["state"] = S.mamba_head(h, st0, p["ssm"])
            o = 0.5 * (o + o2)
        x = x + o
    if spec.has_cross:
        h = L.apply_norm(cfg.norm, x, p["ln_cross"])
        o, (newc["ck"], newc["cv"]) = L.cross_attention(
            h, p["cross"], attn_spec(cfg, spec), cross_tokens)
        x = x + gated(o, p)
    o, aux = _mlp_or_moe(x, p, cfg, spec, kernel_impl)
    return x + o, aux, (newc if want_cache else None)


# ---------------------------------------------------------------------------
# whole-model params
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random weights from ``seed`` on ``device`` (a ``torch.Generator``
    there), with the JAX package's shapes and scales; the numbers differ
    from JAX's (``models.convert.params_from_numpy`` takes those). Each
    tensor is drawn and cast alone, so the peak is the weights and one
    tensor's f32 draw. On the ``meta`` device nothing is drawn or
    allocated: the shapes alone (``model.abstract_params``)."""
    device = torch.device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    d = cfg.d_model
    params = {
        "tok_embed": L.normal((cfg.vocab_size, d), 0.02, dt, device, gen),
        "final_norm": L.init_norm(cfg.norm, d, dt, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.normal((d, cfg.vocab_size), 1.0 / math.sqrt(d),
                                     dt, device, gen)
    if cfg.pos_embedding == "learned":
        params["pos_embed"] = L.normal((cfg.max_seq, d), 0.02, dt, device,
                                       gen)
    params["layers"] = [init_layer(cfg, spec, device, gen)
                        for spec in layer_specs(cfg)]
    if cfg.encoder_layers:  # whisper's encoder (its conv frontend a stub)
        params["encoder"] = [init_layer(cfg, ENC_SPEC, device, gen)
                             for _ in range(cfg.encoder_layers)]
        params["enc_final_norm"] = L.init_norm(cfg.norm, d, dt, device)
    return params


def param_axes(cfg: ModelConfig):
    """The logical axes of ``init_params``'s tree, leaf for leaf: one
    dict a layer in ``params["layers"]`` (no leading "layers" axis: the
    port does not stack layers), ``cross_gate`` a 0-d leaf with axes
    ()."""
    axes = {
        "tok_embed": ("vocab", "embed"),
        "final_norm": L.norm_axes(cfg.norm),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    if cfg.pos_embedding == "learned":
        axes["pos_embed"] = ("pos", "embed")
    axes["layers"] = [layer_axes(cfg, spec) for spec in layer_specs(cfg)]
    if cfg.encoder_layers:
        axes["encoder"] = [layer_axes(cfg, ENC_SPEC)
                           for _ in range(cfg.encoder_layers)]
        axes["enc_final_norm"] = L.norm_axes(cfg.norm)
    return axes


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------
def _embed(params, cfg, tokens, extras):
    """The token embeddings [B,S,D]; with early fusion the first
    ``early_fusion_tokens`` rows replaced by ``extras["vision_embeds"]``
    [B,nf,D] (cast to the activations' dtype), as the JAX package does:
    a prompt shorter than nf grows to nf rows. Then learned positions."""
    x = params["tok_embed"][tokens]
    if cfg.early_fusion_tokens and "vision_embeds" in extras:
        nf = cfg.early_fusion_tokens
        x = torch.cat([extras["vision_embeds"].to(x.dtype), x[:, nf:]],
                      dim=1)
    if cfg.pos_embedding == "learned":
        x = x + params["pos_embed"][:x.shape[1]][None]
    return x


def _cross_tokens(params, cfg, extras, kernel_impl="auto"):
    """The cross layers' memory [B,T,D]: the encoder over
    ``extras["audio_frames"]`` (whisper), else ``extras["vision_embeds"]``
    (llama-3.2-vision; llama4-maverick's early-fusion prefix too, which
    no layer of its reads as cross memory), else None."""
    if cfg.audio_frames and "audio_frames" in extras:
        return run_encoder(params, cfg, extras["audio_frames"], kernel_impl)
    return extras.get("vision_embeds")


def run_encoder(params, cfg, frames, kernel_impl="auto"):
    """Whisper's encoder over precomputed (stub) conv-frontend frames
    [B,T,D]: a sinusoidal table computed in f32 and cast once, then
    ``encoder_layers`` attention + MLP layers ("bidir", which the JAX
    package's mask makes causal: ``layers._block_mask``), then
    ``enc_final_norm``."""
    d = cfg.d_model
    T = frames.shape[1]
    half = torch.arange(0, d, 2, device=frames.device)
    pos = (torch.arange(T, device=frames.device)[:, None].float()
           / torch.pow(torch.tensor(10000.0, device=frames.device),
                       half[None, :].float() / d))
    pe = torch.cat([torch.sin(pos), torch.cos(pos)], dim=-1)[:, :d]
    x = frames + pe[None].to(frames.dtype)
    spec = attn_spec(cfg, ENC_SPEC, bidir=True)
    for p in params["encoder"]:
        h = L.apply_norm(cfg.norm, x, p["ln_attn"])
        o, _ = L.self_attention(h, p["attn"], spec, kernel_impl=kernel_impl)
        x = x + o
        o, _ = _mlp_or_moe(x, p, cfg, ENC_SPEC)
        x = x + o
    return L.apply_norm(cfg.norm, x, params["enc_final_norm"])


def _lm_head(params, cfg, x):
    """The logits; under a mesh on local shards, the vocab sharded as the
    rules shard it (``sharding.ctx.local_call``)."""
    out = _RESID[:-1] + ("vocab",)
    if cfg.tie_embeddings:
        return ctx.local_call(
            lambda x_, w: torch.einsum("bsd,vd->bsv", x_, w),
            (x, params["tok_embed"]), (_RESID, ("vocab", "embed_full")), out)
    return ctx.local_call(lambda x_, w: x_ @ w, (x, params["lm_head"]),
                          (_RESID, ("embed_full", "vocab")), out)


_MM = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
_BMM = {torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default}
# jax.checkpoint_policies' nothing_saveable, checkpoint_dots and
# checkpoint_dots_with_no_batch_dims, as the matmuls each one saves
REMAT_SAVES = {"nothing": frozenset(), "dots": frozenset(_MM | _BMM),
               "dots_no_batch": frozenset(_MM)}


def _remat_context(saves):
    def policy(_ctx, op, *_args, **_kw):
        return (CheckpointPolicy.MUST_SAVE if op in saves
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def forward(params, cfg: ModelConfig, tokens, extras=None, *,
            remat: bool = True, remat_policy: str = "nothing",
            kernel_impl="auto"):
    """Full-sequence forward. Returns (hidden [B,S,D], aux_loss).

    With ``remat`` and grad mode on, each layer runs under
    ``torch.utils.checkpoint``: ``remat_policy`` "nothing" keeps only
    its input, "dots" also every matmul's output, "dots_no_batch" those
    of the matmuls without a batch dimension (the projections, not the
    attention scores). The values are the same either way."""
    saves = REMAT_SAVES[remat_policy]
    extras = extras or {}
    x = ctx.constrain(_embed(params, cfg, tokens, extras), _RESID)
    cross = _cross_tokens(params, cfg, extras, kernel_impl)
    aux_total = 0.0

    def run(x, p, spec):
        x, a, _ = apply_layer(x, p, cfg, spec, cross_tokens=cross,
                              kernel_impl=kernel_impl)
        return ctx.constrain(x, _RESID), a

    context = ({"context_fn": functools.partial(_remat_context, saves)}
               if saves else {})
    for p, spec in zip(params["layers"], layer_specs(cfg)):
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(run, x, p, spec, use_reentrant=False,
                              **context)
        else:
            x, a = run(x, p, spec)
        aux_total = aux_total + a
    x = L.apply_norm(cfg.norm, x, params["final_norm"])
    return x, aux_total


def _token_ce(params, cfg, x, targets):
    """Each position's f32 cross entropy [B,s], x [B,s,D] against targets
    [B,s]: logsumexp minus the gold logit. Under a mesh both are taken
    on the vocab shards (``sharding.ctx.logsumexp_last``, ``take_last``):
    the logits are never gathered."""
    x = ctx.constrain(x, _RESID)
    logits = ctx.constrain(_lm_head(params, cfg, x).float(),
                           ("batch", "seq", "vocab_act"))
    lse = ctx.logsumexp_last(logits)
    return lse - ctx.take_last(logits, targets)


def loss_fn(params, cfg: ModelConfig, batch, *, remat=True,
            remat_policy="nothing", loss_chunk: int = 0, kernel_impl="auto"):
    """Causal-LM cross entropy (+ 0.01 x the MoE aux loss). batch:
    ``tokens``, ``targets`` [B,S] and optional ``extras``. Returns
    (loss, {"ce", "aux"}). Where ``loss_chunk`` divides S and is less
    than S, the logits are taken ``loss_chunk`` positions at a time, each
    chunk under ``torch.utils.checkpoint``, so [B,S,V] is never alive at
    once."""
    x, aux = forward(params, cfg, batch["tokens"], batch.get("extras"),
                     remat=remat, remat_policy=remat_policy,
                     kernel_impl=kernel_impl)
    targets = batch["targets"]
    B, S_, _ = x.shape
    if loss_chunk and S_ % loss_chunk == 0 and S_ > loss_chunk:
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, S_, loss_chunk):
            xc, tc = x[:, c0:c0 + loss_chunk], targets[:, c0:c0 + loss_chunk]
            if torch.is_grad_enabled():
                ce = checkpoint(_token_ce, params, cfg, xc, tc,
                                use_reentrant=False)
            else:
                ce = _token_ce(params, cfg, xc, tc)
            total = total + torch.sum(ce)
        loss = total / (B * S_)
    else:
        loss = torch.mean(_token_ce(params, cfg, x, targets))
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}
