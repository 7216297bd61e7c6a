"""Plain PyTorch version of the rwkv6_scan kernel.

The port of the JAX oracle ``rwkv6_scan_ref``: a loop over time in f32.
Per batch·head, with r, k, v, w [B,H,S,hd] (w the per-step decay in
(0, 1)), u [H,hd] the bonus and the state [B,H,hd,hd] (key x value):

  o_t = r_t . (S + u * (k_t v_t^T))
  S  <- diag(w_t) S + k_t v_t^T

Returns (o [B,H,S,hd], the final state [B,H,hd,hd]), both f32.

Under autograd (training's backward of B5) the loop is what costs, in
host launches: the inputs are split over time once a chunk of CHUNK
steps (``unbind``, whose backward is one ``stack``, where indexing one
step would scatter into a zero tensor of the whole input every step),
and the chunk's ``k v^T`` and ``u * k v^T``, which need no state, are
taken in one product each ([B,H,CHUNK,hd,hd], a bounded size). Each
element is the oracle's product, so the values are the oracle's.
"""

from __future__ import annotations

import torch


CHUNK = 64  # time steps whose k v^T are taken at once


def rwkv6_scan_ref(r, k, v, w, u, state0):
    r, k, v, w = (a.float() for a in (r, k, v, w))
    u = u.float()[None, :, None, :, None]
    st = state0.float()
    outs = []
    for c in range(0, r.shape[2], CHUNK):
        rc, kc, vc, wc = (a[:, :, c:c + CHUNK] for a in (r, k, v, w))
        kv = kc[..., :, None] * vc[..., None, :]  # [B,H,CHUNK,hd,hd]
        ukv = u * kv
        for rt, wt, kvt, ukvt in zip(rc.unbind(2), wc.unbind(2),
                                     kv.unbind(2), ukv.unbind(2)):
            outs.append(torch.einsum("bhk,bhkv->bhv", rt, st + ukvt))
            st = wt[..., :, None] * st + kvt
    return torch.stack(outs, dim=2), st
