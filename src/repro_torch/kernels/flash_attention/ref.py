"""Plain PyTorch version of the flash_attention kernel.

The port of the JAX oracle ``flash_attention_ref`` in the model's layout
(q [B,S,Hq,d], k/v [B,T,Hkv,d]), with the GQA broadcast of the TPU
wrapper: query head h reads KV head h // (Hq // Hkv). Masks from
absolute positions, queries and keys both from 0: causal; ``swa`` adds
q - k < window; ``chunked`` adds q // window == k // window (window 0
leaves the causal mask). Scale 1/sqrt(d), softmax in f32, the weights
cast to the input type before P·V.

The scores are taken in f32, as the kernel takes them; the JAX oracle
rounds them to the input type first (the tests hold the two within the
bf16 tolerance). A row with no visible key averages every V row, as the
TPU kernel does.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def mask_fn(kind, q_pos, k_pos, window):
    m = k_pos[None, :] <= q_pos[:, None]
    if kind == "swa" and window:
        m &= q_pos[:, None] - k_pos[None, :] < window
    elif kind == "chunked" and window:
        m &= (torch.div(q_pos[:, None], window, rounding_mode="floor")
              == torch.div(k_pos[None, :], window, rounding_mode="floor"))
    return m


def flash_attention_ref(q, k, v, *, kind="full", window=0):
    """q [B,S,Hq,d], k/v [B,T,Hkv,d] -> [B,S,Hq,d] in q's type."""
    B, S, HQ, D = q.shape
    T, HKV = k.shape[1], k.shape[2]
    G = HQ // HKV
    qh = q.reshape(B, S, HKV, G, D).permute(0, 2, 3, 1, 4)  # [B,Hkv,G,S,d]
    kh = k.permute(0, 2, 1, 3)[:, :, None]  # [B,Hkv,1,T,d]
    vh = v.permute(0, 2, 1, 3)[:, :, None]
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / math.sqrt(D)
    m = mask_fn(kind, torch.arange(S, device=q.device),
                torch.arange(T, device=q.device), window)
    s = torch.where(m, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    o = torch.matmul(p.to(q.dtype), vh)  # [B,Hkv,G,S,d]
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, HQ, D)
