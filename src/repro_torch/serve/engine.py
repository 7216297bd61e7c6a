"""Batched serving engine: planned continuous batching over a static cache
(the port of ``repro.serve.engine``).

Stage separation (P1): the *planner* (AdmissionPlanner, host) and the
*executor* (prefill and decode on the device) share no mutable state;
the planner hands the executor an explicit plan (slot ids, token
buffers). The decode step runs over the whole slot batch with per-slot
activity masked on the host, so shapes never change as requests come
and go. The cache is updated in place: a prefilled request's cache is
copied into its slot's rows (k/v, and a hybrid layer's Mamba state and a
cross layer's ``ck``/``cv`` where the arch has them), and each decode
step writes one position (an attention layer), its slot's Mamba state (a
hybrid layer) or its slot's token-shift rows and state (an rwkv layer).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.serve.scheduler import AdmissionPlanner, Request


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_slots: int = 4
    cache_len: int = 256
    eos_token: int = 1
    greedy: bool = True


class ServingEngine:
    """``params`` live on ``device`` (the card unless the caller says
    ``"cpu"``); ``kernel_impl`` picks the kernels
    (``repro_torch.kernels.use_kernel``): B4 for prefill attention, B5 for
    an rwkv layer's prefill and decode, B3 for a MoE layer's dispatch
    plan in prefill and decode. ``stats`` counts prefills and
    decode steps and their host-clock seconds, each ending in the read of
    its tokens (a device sync)."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params, *,
                 device="cuda", kernel_impl="auto"):
        self.device = torch.device(device)
        if params["tok_embed"].device.type != self.device.type:
            raise ValueError(f"params on {params['tok_embed'].device}, "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.scfg = scfg
        self.params = params
        self.kernel_impl = kernel_impl
        self.planner = AdmissionPlanner(scfg.batch_slots, scfg.cache_len)
        self.cache = M.init_cache(cfg, scfg.batch_slots, scfg.cache_len,
                                  self.device)
        self.tokens = np.zeros((scfg.batch_slots, 1), np.int32)
        self.active = np.zeros((scfg.batch_slots,), bool)
        self.stats = dict(prefills=0, prefill_s=0.0, decode_steps=0,
                          decode_s=0.0)

    # -- plan: admit requests, prefill their prompts into their slots ----
    def _admit(self, extras=None):
        for req in self.planner.plan():
            t0 = time.perf_counter()
            prompt = torch.as_tensor(req.prompt[None, :], dtype=torch.long,
                                     device=self.device)
            logits, cache1 = M.prefill(self.params, self.cfg, prompt, extras,
                                       cache_len=self.scfg.cache_len,
                                       kernel_impl=self.kernel_impl)
            # greedy: the first maximum, as jnp.argmax
            first = torch.argmax(logits[0, -1])
            _splice_cache(self.cache, cache1, req.slot, len(req.prompt))
            tok = int(first)
            self.stats["prefills"] += 1
            self.stats["prefill_s"] += time.perf_counter() - t0
            req.output.append(tok)
            req.generated = 1
            self.tokens[req.slot, 0] = tok
            self.active[req.slot] = True

    def run(self, requests: list[Request], extras=None) -> list[Request]:
        """Serve ``requests`` to their ends. ``extras`` (tensors or arrays,
        batch 1: ``vision_embeds`` or ``audio_frames``) go with every
        request's prefill, as in the JAX engine."""
        if extras:
            extras = {k: torch.as_tensor(v, device=self.device)
                      for k, v in extras.items()}
        for r in requests:
            self.planner.submit(r)
        out = []
        while self.planner.has_work:
            self._admit(extras)
            if not self.active.any():
                break
            t0 = time.perf_counter()
            logits, self.cache = M.decode_step(
                self.params, self.cfg, self.cache,
                torch.as_tensor(self.tokens, dtype=torch.long,
                                device=self.device),
                kernel_impl=self.kernel_impl)
            nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
            self.stats["decode_steps"] += 1
            self.stats["decode_s"] += time.perf_counter() - t0
            for slot in np.nonzero(self.active)[0]:
                req = self.planner.active.get(int(slot))
                if req is None:
                    continue
                tok = int(nxt[slot])
                req.output.append(tok)
                req.generated += 1
                self.tokens[slot, 0] = tok
                full = len(req.prompt) + req.generated >= self.scfg.cache_len
                if (
                    req.generated >= req.max_new_tokens
                    or tok == self.scfg.eos_token
                    or full
                ):
                    self.active[slot] = False
                    self.planner.release(int(slot))
                    out.append(req)
        return out


def _splice_cache(batch_cache, one_cache, slot, prompt_len):
    """Copy a single-request prefill cache into batch slot ``slot``'s rows
    of ``batch_cache``, in place."""
    for bc, oc in zip(batch_cache["layers"], one_cache["layers"]):
        for name, t in bc.items():
            t[slot] = oc[name][0]
    batch_cache["pos"][slot] = prompt_len
