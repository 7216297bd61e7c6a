"""Plain PyTorch version of the rwkv6_scan kernel.

The port of the JAX oracle ``rwkv6_scan_ref``: a loop over time in f32.
Per batch·head, with r, k, v, w [B,H,S,hd] (w the per-step decay in
(0, 1)), u [H,hd] the bonus and the state [B,H,hd,hd] (key x value):

  o_t = r_t . (S + u * (k_t v_t^T))
  S  <- diag(w_t) S + k_t v_t^T

Returns (o [B,H,S,hd], the final state [B,H,hd,hd]), both f32.
"""

from __future__ import annotations

import torch


def rwkv6_scan_ref(r, k, v, w, u, state0):
    r, k, v, w = (a.float() for a in (r, k, v, w))
    u = u.float()
    st = state0.float()
    outs = []
    for t in range(r.shape[2]):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, :, t],
                                 st + u[None, :, :, None] * kv))
        st = w[:, :, t, :, None] * st + kv
    return torch.stack(outs, dim=2), st
