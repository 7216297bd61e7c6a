#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

  1. build   — compile every CUDA kernel of the paths from this checkout,
               all at once (``nvcc`` for sm_90a, one process per source,
               into build/repro_torch_kernels/; B4 is two libraries, the
               tensor-core kernel for bf16 and the CUDA-core one for f32;
               B1's, B2's and B5's earlier designs are built beside
               them); every B1, B2, B4 and B5 instance's registers,
               spills (none allowed) and shared memory, and B4's HGMMA
               count, are printed in phase 2;
  2. kernels — hold each kernel bit-equal (integers, tolerance 0) to its
               plain PyTorch version on the card, and time both (CUDA
               graph replays): lock_grant's fused form (the whole ORTHRUS
               grant decision in one launch) on the round of a real
               full-width run (T*K = 2,560) and on random rounds (T*K =
               12 .. 4,096; above that the engine's chain around the
               sorted form), its sorted form and earlier design on that
               round's sorted entries and on random sorted inputs at
               N = 1 .. 2^20; dep_wavefront's row form (the batch
               engine's stage 4 in one launch) on the readiness check of
               each full-width batch cell below (E = T*P = 768, 2,048,
               128, 40), also against the dense check, and on random rows
               (T up to 3,000), its grouped-edge form and earlier design
               on those edges and on random grouped inputs at E = 1 ..
               2^20, plus its whole wrapper against the dense oracle. In
               turns: each new form against its earlier design, each
               fused launch against the eager chain it replaces (graph
               replay and host-issued), an empty launch (the floor);
  3. goldens — replay all 17 cells of tests/golden/ on the card,
               bit-exactly (the overload cells' metrics included). Here
               and in phases 4-10 ``run_simulation`` runs every cell
               through its cached chunk runner: one replay of a captured
               CUDA graph per dispatch (K = 1 round), one read of ``r``
               per replay; a kernel's launches count per replay what its
               capture recorded;
  4. main path, slice 1 — YCSB at the paper's width (10 M records, 64
               hot, 8,192 txns; SIM_CUT's depth) through
               ``run_simulation``: orthrus (16 CC
               + 64 exec lanes, window 4) through lock_grant, the same
               cell on the plain path (identical fingerprint required),
               and deadlock_free on 80 exec lanes; step profiles, the
               kernel and plain paths of orthrus in turns;
  5. main path, slice 2 — the batch-planned engine at the paper's width:
               dgcc and quecc (16 planner + 64 exec lanes, window 4),
               quecc with fragments and inter-batch pipelining (fig14's
               16-hot multi-partition cell, 8 + 32 lanes) and scheduled
               (fig18's cell, 40 lanes), each through dep_wavefront and
               on the plain path (identical fingerprints, metrics
               included); dep_wavefront launches = steps on every kernel
               run; step profiles of dgcc's two paths in turns and of
               quecc_frag_pipe;
  6. main path, slice 3 — gemma3-1b serving at its published width (26
               layers, d_model 1,152, vocab 262,144, bf16, random weights
               from SEED) through ``ServingEngine``: 8 slots of 4,096
               positions, 16 requests with prompts of 600-3,000 tokens and
               32 new tokens each, on the kernel path (flash_attention
               launches = 26 per prefilled request) and on the plain path
               (none); first-token logits of the two paths held to
               FIRST_LOGIT_TOL; tokens/s, prefill ms per request, decode ms
               per step and the device busy share (torch.profiler);
  7. main path, slice 4 — rwkv6-1.6b serving at its published width (24
               layers, d_model 2,048, 32 heads of 64, vocab 65,536, bf16,
               random weights from SEED) through ``ServingEngine``, the
               cell of slice 3: the kernel path serves all 16 requests
               (rwkv6_scan launches = 24 per prefill and per decode step,
               no flash_attention), the plain path the first
               RWKV_PLAIN_REQUESTS of them (its loop over time issues
               about 7 kernels per step per layer); their first-token
               logits held to RWKV_FIRST_LOGIT_TOL, beside how far the
               kernel path's logits move when the scan's outputs move
               by RWKV_NUDGE; the same readings and profile as slice 3;
  8. main path, slice 5 — mixtral-8x22b serving at its published width,
               cut in depth only (MIXTRAL_CUT: 8 of its 56 identical
               layers; d_model 6,144, 48 query heads over 8 KV heads of
               128, 8 experts top-2 of d_ff 16,384, vocab 32,768, bf16,
               random weights from SEED) through ``ServingEngine``, the
               cell of slice 3, all 16 requests on both paths: on the
               kernel path moe_dispatch launches once per layer of every
               prefill and decode step and flash_attention once per layer
               of every prefill; at each request's first token the kernel
               path's logits bit-identical with the plain plan in B3's
               place, and the plain path with the kernel path's plans
               (the routing held fixed) within FIRST_LOGIT_TOL of them;
               the free-running plain path's difference printed beside
               the share of (token, layer) top-2 choices on which the two
               paths agree and the share of routed entries each layer
               drops at capacity; the same readings and profile as
               slice 3, and a profile of the plain path;
  9. main path, slice 7 — the paper's dynamic-2PL baselines at Fig 4's
               widest cells (twopl_waitdie, twopl_waitfor and
               twopl_dreadlocks on 80 exec lanes, YCSB at the paper's
               width) and the partitioned store at Fig 6's dual-partition
               cell (64 lanes, 64 partitions, no hot set), at SIM_CUT's
               depth, each through ``run_simulation`` with each run's
               fingerprint; every 2PL cell aborts on deadlock, the
               partitioned store never; twopl_waitfor's fingerprint
               (metrics included) is the same on release_path="dense"
               (the in-tree oracle, full width) and with event leaping
               off; no kernel runs on this path (the reference's grant
               and deadlock stages are plain jnp); step profiles of
               twopl_waitdie, twopl_dreadlocks and deadlock_free in
               turns, whose difference is the deadlock stage's cost;
 10. main path, slice 7: open arrival — open epoch arrival and the
               overload layer at the figures' width (YCSB, 10 M records,
               8,192 txns, 16 hot; the lock-table cells at SIM_CUT's
               depth) through ``run_simulation``: fig16's
               past-the-knee planned dgcc (4 CC + 32 exec, window 2, 2
               planner lanes, a 64-txn epoch every 200 rounds) and
               fig15's one-planner-lane quecc with fragments (16 CC + 32
               exec, 256-txn epochs every 200 rounds), each through
               dep_wavefront and on the plain path (identical
               fingerprints, dep_wavefront launches = steps, the planner
               saturated: plan_qdelay > 0); fig17's 40-lane
               deadlock_free under deadline shedding (epochs every 200
               rounds, deadline 1,000; rerun with leaping off, identical,
               every round a step), under a bounded backlog of 64 (the
               backlog after the last round within it, the host oracle;
               each queue sample within it plus one epoch), under 4x
               bursts at interval 800
               (a whole burst period after warmup), and its closed-loop
               wait-die with exponential backoff (hot 64: deadlock
               aborts, backoff rounds issued); orthrus at the golden
               size under open arrival, deadline shedding, a retry
               budget of 3 and exp backoff on both paths (identical;
               lock_grant launches = steps); step profiles of the
               deadline-shed cell against closed-loop deadlock_free, and
               of the planned dgcc's two paths, in turns;
 11. main path, slice 7: K-fused dispatch — ``rounds_per_dispatch`` at
               the paper's width: each of K_CELLS (orthrus on the kernel
               and the plain path, deadlock_free, dgcc, quecc,
               quecc_frag_pipe and scheduled on the kernel path, the three
               dynamic-2PL schemes, the partitioned store, fig17's
               deadline-shed cell; the lock-table cells at SIM_K11's 256
               rounds, the batch cells at SIM_K11_BATCH's 512, about an
               eighth of their depth in phases 4-10) run three ways: the
               eager loop at K = 1 (``sweep.simulate_eager``, the
               oracle), the graph at K = 1 and at K = 8; orthrus and
               twopl_waitdie also at K = 5 (a cache hit on K = 8's
               runner) and K = 32. Every fingerprint identical (metrics
               and counters incl.); lock_grant and dep_wavefront launch
               K x replays, steps_executed of them active. One cached
               orthrus runner through two open-arrival cells that differ
               only in the epoch interval (200, 400, then 200 again), each
               giving a fresh eager run's fingerprint. For each cell and
               K: whole-run wall ms a step, host syncs a step,
               dispatches, the share of inactive inner steps, the capture
               time; then per-step windows in turns (wall ms, CUDA
               kernels = the graph's kernel nodes under replay, device ms,
               busy share); the runner cache and the card's memory.
 12. main path, slice 8: the multi-cell sweep — ``sweep.run_cells`` at
               the paper's width: Fig 13's contention axis (its 8
               protocols at 40 lanes, the message-based ones 8 + 32 at
               window 4, x hot sets 1,024, 64 and 16: 24 cells,
               SIM_SWEEP's depth) per cell through ``run_simulation``
               and as groups under SERIAL_MODE and SweepMode(1, 2, early exit): a group
               of C cells is one CUDA graph with a branch per cell (a
               side stream each), one replay and one read of the [C]
               ``r`` vector per dispatch of every cell. Every fingerprint
               equal to its single-cell run (metrics and counters incl.),
               ``group_cells`` the group's size; B1 and B2 launch C x K
               a replay of a group (inactive branches incl.), K a replay
               of a one-cell runner. Each group's size and capture time;
               the sweep's wall as cells/s against per-cell runs in turns
               (warm caches); the orthrus and dgcc groups' span, device
               ms and busy share a replay beside one of their cells' K =
               1 graph; the reference's sweep subset (twopl_waitdie 40
               lanes, dgcc 8 + 32, x the three hot sets) with a finite
               commit target, the stop boundary of each cell, two
               distinct stops in one group required; the 17 goldens twice
               in one call, bit-exact; the runner cache and the card's
               peak memory.
 13. main path, slice 9: the other archs' serving — stablelm-1.6b,
               starcoder2-3b, qwen3-32b, hymba-1.5b (its Mamba head
               beside swa attention), whisper-tiny (its encoder over
               1,500 random frames and cross-attention) and
               llama-3.2-vision-11b (its gated cross-attention layers
               over 1,024 random vision embeddings, the gates set to
               CROSS_GATE_OPEN on both paths), each at its published
               width with random weights from SEED, one at a time on a
               card the earlier models have left, through
               ``ServingEngine.run(requests, extras)`` (SLICE9_CELLS: 8
               slots of 4,096, 8 requests, hymba's 2, 16 new tokens a
               request) on the kernel
               path and on the plain path: flash_attention launches
               once per self-attention layer of every prefill (the
               encoder's included) and never on the plain path; each
               request's first token the argmax of its prefill's logits;
               first-token logits held to FIRST_LOGIT_TOL (hymba's to
               SLICE9_LOGIT_TOL, beside the same check in float32) and
               printed beside how far they move when only B4's outputs
               move by one bf16 unit; tokens/s, prefill ms per request
               and decode ms per step. At qwen3-32b's and hymba-1.5b's
               new shapes B4 is held to its plain version on every layer
               of a real prefill and timed in turns at layer 0 beside
               its plain version, SDPA and the bound; the device busy
               share of both on the kernel path.
 14. main path, slice 10: the legacy layout and the latency oracle — at
               the paper's width (LEGACY_CELLS: orthrus 16 + 64 at window
               4, deadlock_free and the three dynamic-2PL schemes on 80
               lanes, the partitioned store on Fig 6's cell, dgcc and
               quecc 16 + 64 at window 4; the lock-table cells SIM_K's
               1,000 rounds, the batch cells SIM_K_BATCH's 2,000) each
               cell through ``run_simulation`` on the K = 1 graph twice:
               under ``state_layout="legacy"`` (the frozen pre-packed
               engine, ``engine_legacy``: no kernel, its own step code)
               and on the packed engine's kernel path. Each legacy
               fingerprint equals the packed one (metrics aside: the
               legacy layout has none); B1 and B2 launch no time in a
               legacy run and once a step in a packed one; legacy
               orthrus at K = 8 equals its K = 1 run. Step profiles of
               orthrus and dgcc, legacy against packed in turns (eager
               and graph K = 1), with the packed rewrite's ratio a step.
               Then the latency oracle (``tools/torch_trace_export.py``)
               on ORACLE_CELLS (1,000 rounds, no warmup): the cell
               replayed densely on the card (one graph replay a round),
               each commit's exact latency from slot transitions against
               an arrival worked out independently (closed loop: the
               admission round; open arrival: (tid // 64) * 200); the
               events count the commits, the bucketed exact latencies
               equal ``run_simulation``'s ``lat_hist``, its p50, p99 and
               p999 the bucket edges of the exact rank statistics; one
               Chrome trace per cell written under chiprun_out/.
 15. main path, slice 11: llama4-maverick and per-shard MoE dispatch —
               the simulator's cached runners freed first; B4 held and
               timed (against SDPA with a boolean mask) on a chunked
               layer at llama4's heads (40 query heads over 8 KV heads
               of 128, bf16) at S = 9,000 on random inputs, where the
               8,192-token chunk binds; then llama4-maverick-400b-a17b
               at its published width, cut in depth only (LLAMA4_CUT:
               one of its 12 pattern repeats, 4 layers = 3 chunked-local
               + 1 global NoPE, MoE of 128 experts top-1 and a shared
               expert on 2; d_model 5,120, vocab 202,048; 70.08 GB of
               bf16 weights, ``check_fits`` before any allocation), with
               random weights and a random 64-row early-fusion prefix
               from SEED. B4 held on every layer of a real 3,000-token
               prefill and timed at its chunked layer 0 and its NoPE
               layer; B3's fused plan held on the MoE layers of that
               prefill and of a real decode step at 8 slots and timed
               against the plain plan, and its grouped form (G plans in
               one launch) held bit for bit at G = 1, 2, 4, 8 on the
               prefill's probabilities and at G = 4 on the decode
               step's, timed against G one-plan launches and the plain
               version beside the bound. Served through
               ``ServingEngine.run(requests, extras)`` (phase 6's 16
               prompts, 16 new tokens): all on the kernel path, the first
               LLAMA4_PLAIN_REQUESTS on the plain path; B3 launched once
               per MoE layer of every prefill and decode step and B4 once
               per self-attention layer of every prefill, neither on the
               plain path; first-token logits as phase 8 holds mixtral's
               (B3 swapped for the plain plan bit-identical; the plain
               path with the kernel path's plans within FIRST_LOGIT_TOL,
               beside one bf16 unit of B4's outputs; the free-running
               difference beside the top-1 agreement share). Then the
               same weights with ``moe_dispatch_shards`` = 4: 8 requests
               on both paths, the same launch counts, the prefills that
               took the grouped plan and those that fell back, decode at
               capacity 32, first-token logits against the unsharded
               kernel path's within FIRST_LOGIT_TOL where no routed entry
               was dropped. Tokens/s, prefill ms per request, decode ms
               per step, the busy share of the first 2 kernel-path
               requests and the peak card memory beside its estimate.
 16. main path, slice 12: distributed ORTHRUS — ``core.distributed``'s
               one-device form (the ``cc`` axis a leading tensor
               dimension, the all-to-all a transpose, one launch of B1's
               sorted form a round for every shard, the rounds as
               replays of an 8-round CUDA graph, ``ROUNDS_PER_REPLAY``):
               tests/test_sharding.py's 8-shard cell on the kernel and
               the plain path, per-shard
               commits exactly the JAX reference's DIST_TEST_COMMITS;
               fig13's orthrus split as 16 CC shards x 4 exec lanes over
               YCSB at the paper's width (625,000 keys a shard, 10 keys a
               txn, msg_cap 16), each lane re-running one of the
               workload's first 64 txns, with 64 hot keys (all on shard
               0) and uniform: at DIST_CPU_ROUNDS both paths equal the
               port's CPU run, at DIST_ROUNDS the two paths are identical
               and B1 launches once a round; rounds/s, commits a round,
               CUDA kernels, device ms and B1's ms a round
               (torch.profiler, over graph replays only) and the busy
               share of those replays' span (CUDA events around the same
               replays), the unprofiled span beside it; B1's sorted form held
               and timed in turns against its plain version at the
               round's N = 4,096 beside the bound; the process form
               (``all_to_all_single`` over NCCL at world size 1, a file
               store under build/) equal to the one-device form at n_cc 1.
 17. main path, slice 13: training — ``launch.train.build_trainer`` on
               one card (TRAIN_CELLS: gemma3-1b at its published config,
               AdamW with f32 state, 8 steps of 4 x 2,048 tokens;
               rwkv6-1.6b, AdamW, 3 steps of 2 x 256 (2 on the plain
               path); mixtral-8x22b at its published width cut to 2
               layers, Adafactor, 2 steps of 2 x 1,024), bf16 params, per-layer remat "nothing",
               batches from the port's ``TokenPipeline``, each on the
               kernel path (B4, B5 and B3 forward and in the remat
               recompute, their backwards their plain versions' through
               ``kernels.autograd``) and the plain path from the same
               weights: step 0's grads finite and non-zero on every leaf
               (each expert's too), the attention projections', routers'
               and rwkv time mix's, kind by kind, within TRAIN_GRAD_NUDGES
               x how far one bf16 unit of B4's and B5's outputs moves
               that kind (a bound below TRAIN_GRAD_POWER) of the plain
               path's, step 0's losses within TRAIN_LOSS_TOL; gemma3-1b
               checkpointed before its last step and that step resumed
               in a fresh trainer within TRAIN_RESUME_TOL; launches
               exactly twice a layer a kernel-path step; step ms,
               tokens/s, peak memory, the kernel path's step 0
               profiled (busy share, plain-backward device shares);
               each Function at a real layer's shape: its
               forward (the kernel's) held to the plain version's with
               phase 2's tolerances, its backward against autograd
               through the plain version.
 18. main path, slice 14: the DTensor trainer, GPipe and the roofline —
               (a) phase 17's cells through ``build_trainer`` on a
               ``DeviceMesh`` over NCCL at world size 1 (data 1, model
               1): params and optimizer state DTensors, the sharding
               context live, B3, B4 and B5 launched on local shards
               (``sharding.ctx.local_call``); step 0's loss and watched
               grads held to phase 17's (bit-equal, or within phase 17's
               bound of each kind), the DTensor step's ms beside phase
               17's; (b) GPipe in the one-device form at full width:
               gemma3-1b's 24 grouped layers as 4 stages of 6, 4
               microbatches of 1 x 2,048 tokens, bf16, kernel path,
               forward and backward: outputs bit-equal to the layers run
               one microbatch at a time, param grads within
               PIPE_GRAD_RTOL, B4 launched 96 times in the forward; (c)
               each training cell traced on ``meta`` and priced at the
               H100's peaks (``launch.roofline``): its compute and
               memory lower bounds beside its measured ms a step.
 19. main path, slice 16: decode over a sequence-sharded cache on one
               card — gemma3-1b at full width (26 layers, 1 KV head,
               bf16, batch 1), its 32,768-row cache filled by a real
               32,767-token prefill on the kernel path (B4 once a
               layer), then one decode step twice: through the unsplit
               ``decode_attention``, and with every layer's cache cut
               into SEQ_DECODE_BLOCKS row blocks, each block through
               ``layers.decode_rows`` (the arithmetic one rank runs on
               its rows under a mesh) and the blocks combined by the
               max, sum and bf16 sum the collectives perform; the
               logits within FIRST_LOGIT_TOL, both step times. The
               collectives themselves need several cards.
 20. main path, slice 17: the examples — examples/torch_*.py called
               in-process on the card at their own sizes, each kernel's
               count set to 0 just before an example and read just after:
               the quickstart (2PL wait-die, deadlock-free and ORTHRUS on
               4,096 YCSB txns over 1 M records, 6,000 rounds: B1 once
               an orthrus step, its fingerprint equal on the plain path;
               B3's top-1 plan of 64 tokens over 4 experts at 16 slots
               equal to ``plan_dispatch``'s, empty slots included); the
               contention demo at its REPRO_DEMO_FAST budget (22 cells:
               B2 once a step of its 13 dgcc and quecc cells, each equal
               on the plain path, metrics included); serve_lm (SMOKE
               mixtral-8x22b, 10 requests through 4 slots: B4 once a
               layer a prefill at head_dim 16, B3 once a layer a prefill
               and a decode step; then in float32 from the same weights
               the kernel and the plain path's tokens equal, a differing
               token allowed only where the two paths' logits there are
               within SLICE9_F32_TOL); train_lm (SMOKE gemma3-1b, 300
               steps of 8 x 64: B4 twice a layer a step, the state
               resumed halfway bit-equal leaf for leaf to the state saved
               at that step, the loss falling). Each example's wall time,
               launches and the card's name and power limit.

Phase 2 also holds flash_attention to its plain version (f32 3e-5;
bf16 2e-2 or one unit in the output's last place, whichever is larger)
on the q/k/v of every layer of a real full-width 2,048-token gemma3-1b
prefill and on random inputs at gemma's shape (S = 7 .. 4,096, every
kind) and test_kernels.py's. bf16 runs the tensor-core kernel
(flash_attention_tc.cu: a producer warp feeds a two-stage K/V ring in
shared memory with TMA; one consumer warpgroup per query head, two heads
of a KV head to a block where the launch is work-bound, run S = Q.K^T
and O += P.V on wgmma with P from registers), f32 the CUDA-core one. At
gemma's global and swa layers and mixtral's layer 0 it times, in one
call and in turns, the kernel, the same kernel at one and at two heads a
block, the earlier CUDA-core design (``ops._flash_attention_simt``),
the plain version and F.scaled_dot_product_attention (the yardstick),
beside the bound, and the head packing over prompt lengths; and
rwkv6_scan (register tiles of the state, the output sums reduced once
per chunk) and its earlier design (``ops._rwkv6_scan_chain``) to the
plain version (RWKV_TOL) on all 24 layers of a real full-width
3,000-token rwkv6-1.6b prefill, on the 24 layers of a real decode step
at 8 slots, on random inputs (S = 1 .. 1,000, B·H = 1 .. 256, every
supported head_dim) and on test_kernels.py's shapes; it times the two in
turns at the prefill layer, at the decode step with the L2 cache warm
and cold (the 24 layers' states in sequence, twice the L2) and over
prompt lengths of 600-3,000 tokens, beside the plain version and the
bound, and sweeps the kernel's built tiles at both shapes. It holds
flash_attention at mixtral's layout (6 query heads per KV head of 128)
on every layer of a real full-width MIXTRAL_CHECK_SEQ-token
mixtral-8x22b prefill too. It holds moe_dispatch's fused plan (top-k,
positions, dispatch table and load in one launch) bit-equal to the plain
plan on the router probabilities of every layer of that prefill and of
a real decode step at 8 slots, and on random ones (N = 1 .. 65,536, E
4, 8 and 128, top 1 and 2, rows with ties, capacities that drop and that
do not), its grouped form (per-shard dispatch: G plans in one launch)
bit-equal to each group's plain plan on that prefill's layers in G = 1,
2, 4, 8 shards and on random groups with ties, and its sorted form
bit-equal to its plain version on those
layers' sorted expert ids and on random sorted ids with a -1 tail (N =
1 .. 2^20); in turns, it times the fused launch against the eager chain
around the sorted form and the plain plan, and counts the CUDA kernels
of a plan on each.

The serving profiles read the device time from the profiler's raw events
(``device_activity``), which sum to what ``key_averages()`` sums.

Each path sets the kernels' launch counts to 0 just before it and reads
them just after. Then it prints the kernels' JSON line, the card's name
and power limit, and, last, ``{"ok": true, "device": {...}}``. It needs
one CUDA card and imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
GOLDEN_CELLS = ("orthrus", "deadlock_free", "deadlock_free_tpcc_ollp",
                "dgcc", "quecc", "scheduled", "dgcc_frag", "quecc_frag",
                "quecc_frag_pipe", "twopl_waitdie", "twopl_waitfor",
                "twopl_dreadlocks", "partitioned_store",
                "dgcc_planner_sat", "scheduled_planner_sat",
                "deadlock_free_overload", "deadlock_free_overload_shed")
# the goldens whose fingerprint pins the metrics layer too
GOLDEN_METRICS_CELLS = ("deadlock_free_overload",
                        "deadlock_free_overload_shed")
# the fingerprint's optional counters: planner lanes and the overload
# layer, where the run carries them
FINGERPRINT_OPT_KEYS = ("plan_busy", "plan_qdelay", "epoch_ctr",
                        "pol_rejected", "pol_shed", "pol_timedout",
                        "pol_tb_adm", "pol_sacrificed", "pol_backoff_rounds")

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # non-tensor-core rate; int32 adds and compares

# The paper's width (benchmarks/figures.py): YCSB at 10 M records, 80 cores
YCSB_FULL = dict(kind="ycsb", num_txns=8192, num_records=10_000_000,
                 num_hot=64, seed=0)
# Depth cuts for the script's time limit (a slow host issues a kernel in
# 25 us): the batch cells run 4,000 rounds, the lock-table cells, which
# step every round or two at 40-80 lanes (5-13 ms a step), 2,000; widths
# stay
SIM_FULL = dict(max_rounds=4000, warmup_rounds=1000, chunk_rounds=1000,
                target_commits=10**9)
SIM_CUT = dict(max_rounds=2000, warmup_rounds=500, chunk_rounds=500,
               target_commits=10**9)
ORTHRUS_FULL = dict(protocol="orthrus", n_cc=16, n_exec=64, window=4)
DF_FULL = dict(protocol="deadlock_free", n_exec=80)
# The batch-planned cells (benchmarks/figures.py): fig13's 80-core split
# of dgcc and quecc on YCSB_FULL; fig14's 16-hot multi-partition cell
# with fragments and inter-batch pipelining; fig18's scheduled cell
DGCC_FULL = dict(protocol="dgcc", n_cc=16, n_exec=64, window=4)
QUECC_FULL = dict(protocol="quecc", n_cc=16, n_exec=64, window=4)
YCSB_FIG14 = dict(YCSB_FULL, num_hot=16, multipart_frac=1.0,
                  num_partitions=16)
QUECC_FRAG_PIPE_FULL = dict(protocol="quecc", n_cc=8, n_exec=32, window=4,
                            fragment_exec=True, inter_batch_pipeline=True)
YCSB_FIG18 = dict(YCSB_FULL, hot_per_txn=1)
SCHEDULED_FULL = dict(protocol="scheduled", n_exec=40)
# gemma3-1b serving (slice 3): weights and prompts from SEED
SEED = 0
SERVE_SLOTS, SERVE_CACHE_LEN = 8, 4096
SERVE_REQUESTS, SERVE_PROMPT_LENS, SERVE_NEW_TOKENS = 16, (600, 3000), 32
# largest |logit| difference allowed between the kernel and the plain
# path at a request's first token: both paths round to bf16 (8 bits of
# mantissa) at every op of 26 layers, they differ in where the attention
# scores are rounded, and the logits have a spread of about 0.7
FIRST_LOGIT_TOL = 0.25
# kernel vs plain version: tests/test_kernels.py's tolerances; in bf16 an
# output of magnitude >= 4 may also differ by one unit in its last place
# (0.03125 there): the two round p and the sum at different points
FA_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
BF16_OPS_PER_S = 989e12  # tensor cores, dense
# rwkv6-1.6b serving (slice 4): the cell of slice 3. The plain path's
# loop over time issues about 7 kernels per step per layer (seconds of
# host launches per prompt of 1,800 tokens), so it serves the first
# RWKV_PLAIN_REQUESTS requests only: a cut in requests, not in width
RWKV_PLAIN_REQUESTS = 2
RWKV_CHECK_SEQ = 3000  # the real prefill B5 is held on
# kernel vs plain version: tests/test_kernels.py's absolute 2e-4 at its
# input scales (about 0.1-0.2). On real activations the state sums
# thousands of outer products with decays near 1 (w0 = -6: w about
# 0.9975) and grows far past that scale; both run in f32 and differ in
# the order of the sums, so the error there scales with the values:
# 2e-4 or RWKV_REL_TOL of the reference's largest |value|, whichever is
# larger
RWKV_TOL = 2e-4
RWKV_REL_TOL = 1e-5
# largest |logit| difference allowed between the kernel and the plain
# path at a request's first token: gemma's FIRST_LOGIT_TOL. The two run
# the same bf16 ops and differ only in the order of the f32 sums inside
# the recurrence (about 1e-6 relative), but where that flips a bf16
# rounding of the time mix's output, the change runs through every layer
# above it: on these prompts the logits (largest |5|, bf16 units of
# 0.03125 there) differ by a few units. scan_rounding_sensitivity
# prints how far they move on the kernel path alone when only the scan's
# outputs move by one part in 10^6, the yardstick for this tolerance
RWKV_FIRST_LOGIT_TOL = FIRST_LOGIT_TOL
RWKV_NUDGE = 1e-6
# mixtral-8x22b serving (slice 5): the published width, cut in depth only
# to 8 of its 56 identical layers (40.9 GB of bf16 weights; the whole
# model's 281 GB do not fit one card), the cell of slice 3
MIXTRAL_CUT = dict(pattern_repeats=8)
MIXTRAL_CHECK_SEQ = 3000  # the real prefill B3 and B4 are held on
# the prompts of a second reading of mixtral's routing agreement
MIXTRAL_SECOND_SEED = SEED + 1
# least share of (token, layer) pairs that mixtral's kernel and plain
# paths, each with its own routing, send to the same top-k experts: with
# random weights most tokens lean to the same experts, and near-ties
# that a bf16 rounding flips leave about 95% alike
MIXTRAL_MIN_AGREEMENT = 0.9
# slice 9 (phase 13): the other archs' serving, each at its published
# width (random weights and extras from SEED) with phase 6's slots and
# cache; 16 new tokens a request. Per cell: arch, requests, prompt
# lengths, plain-path requests. stablelm, starcoder2, qwen3 and
# llama-3.2-vision take the first 8 of phase 6's 16 prompts (the
# script's time limit); hymba 2 of 1,100-1,400 tokens (past its 1,024
# window), since its Mamba head's loop over time issues three kernels a
# token a layer on both paths (a cut in requests, not in width); whisper
# 8 of 16-400 tokens, inside the real model's 448 positions
SLICE9_NEW_TOKENS = 16
SLICE9_CELLS = (
    ("stablelm-1.6b", 8, SERVE_PROMPT_LENS, 4),
    ("starcoder2-3b", 8, SERVE_PROMPT_LENS, 4),
    ("qwen3-32b", 8, SERVE_PROMPT_LENS, 4),
    ("hymba-1.5b", 2, (1100, 1400), 1),
    ("whisper-tiny", 8, (16, 400), 4),
    ("llama-3.2-vision-11b", 8, SERVE_PROMPT_LENS, 4),
)
# llama-3.2-vision's tanh gates start at 0 (the cross layers add exactly
# 0), so both paths open them
CROSS_GATE_OPEN = 1.0
# first-token logits, kernel vs plain path: FIRST_LOGIT_TOL but where
# named here. hymba's bf16 forward gathers rounding noise layer on layer
# (about 1% of the residual a layer, a quarter of it by layer 32): its two
# bf16 paths differ by 0.81-1.30, each is 0.78-0.87 from the f32 forward,
# and moving only B4's outputs by one bf16 unit moves the logits by
# 0.65-0.98 (two runs on an H100). So 2.0, twice the largest of those
# moves; and the same check in float32, where the paths agree to 1e-4,
# held to SLICE9_F32_TOL
SLICE9_LOGIT_TOL = {"hymba-1.5b": 2.0}
SLICE9_F32_TOL = 1e-3
# B4 held at every layer, and timed at layer 0, of a real prefill of this
# many tokens: d 128 at 8 query heads a KV head, d 64 at an odd 5
SLICE9_READINGS = {"qwen3-32b": 3000, "hymba-1.5b": 1400}
# the kernel path's device busy share, over its first this many requests
SLICE9_PROFILED = {"qwen3-32b": 4, "hymba-1.5b": 1}
# slice 11 (phase 15): llama4-maverick-400b-a17b at its published width,
# cut in depth only to one of its 12 pattern repeats (4 layers: 3
# chunked-local of 8,192 + 1 global NoPE, MoE on 2; 35.04 B parameters,
# 70.08 GB of bf16 weights and 0.54 GB of cache at 8 x 4,096: the whole
# model's 795 GB need ten cards), the cell of phase 13 with its 16
# prompts; plain path the first LLAMA4_PLAIN_REQUESTS
LLAMA4 = "llama4-maverick-400b-a17b"
LLAMA4_CUT = dict(pattern_repeats=1)
LLAMA4_PLAIN_REQUESTS = 4
LLAMA4_CHECK_SEQ = 3000  # the real prefill B3 and B4 are held on
# B4 on a chunked layer where the 8,192-token chunk binds (random inputs
# at llama4's heads, before the model is made: the plain version's f32
# scores are 40 x 9,000^2)
LLAMA4_BINDING_SEQ = 9000
# per-shard dispatch: the same weights with 4 shards, the first 8 prompts
LLAMA4_SHARDS = 4
LLAMA4_SHARD_REQUESTS = 8
# B3's grouped launch held and timed at these group counts
GROUP_COUNTS = (1, 2, 4, 8)
# slice 7: fig4's widest cells (benchmarks/figures.py:55-63: 80 lanes,
# 64 hot) for the three dynamic-2PL schemes, and fig6's dual-partition
# cell of the partitioned store (:157-170)
DL_PROTOCOLS = ("twopl_waitdie", "twopl_waitfor", "twopl_dreadlocks")
YCSB_FIG6 = dict(YCSB_FULL, num_hot=0, partitions_per_txn=2,
                 num_partitions=64)
PSTORE_FULL = dict(protocol="partitioned_store", n_exec=64)
SLICE7_CELLS = tuple((p, dict(protocol=p, n_exec=80), YCSB_FULL)
                     for p in DL_PROTOCOLS) + (
    ("partitioned_store", PSTORE_FULL, YCSB_FIG6),)
# slice 7, item 7: open arrival and the overload layer at the figures'
# width. fig16's base (benchmarks/figures.py:817-823: 64-txn epochs,
# also fig17's at hot 16, :912) and fig15's (:681-690: 256-txn epochs),
# both at hot 16
YCSB_FIG16 = dict(YCSB_FULL, num_hot=16, batch_epoch=64)
YCSB_FIG15 = dict(YCSB_FULL, num_hot=16, batch_epoch=256)
OA_BATCH_CELLS = (
    # fig16's past-the-knee point of its planned dgcc lane
    ("fig16_h16_i200_dgcc_planned",
     dict(protocol="dgcc", n_cc=4, n_exec=32, window=2, n_planner_lanes=2,
          epoch_interval_rounds=200), YCSB_FIG16),
    # fig15's one-planner-lane quecc with fragments at its fastest rate
    ("fig15_h16_i200_L1_quecc_frag",
     dict(protocol="quecc", n_cc=16, n_exec=32, window=2,
          fragment_exec=True, n_planner_lanes=1, epoch_interval_rounds=200),
     YCSB_FIG15),
)
FIG17_DF = dict(protocol="deadlock_free", n_exec=40)
FIG17_SHED = dict(FIG17_DF, epoch_interval_rounds=200,
                  admission_policy="deadline_shed", deadline_rounds=1000)
FIG17_BB = dict(FIG17_DF, epoch_interval_rounds=200,
                admission_policy="bounded_backlog", backlog_cap=64)
FIG17_BURST = dict(FIG17_SHED, epoch_interval_rounds=800,
                   arrival_pattern="burst", burst_period_epochs=4,
                   burst_on_epochs=1)
FIG17_BACKOFF = dict(protocol="twopl_waitdie", n_exec=40,
                     backoff_mode="exp", backoff_max_rounds=4096)
# the burst cell's depth: one whole burst period (4 epochs x 800
# rounds) after its warmup
SIM_BURST = dict(max_rounds=3600, warmup_rounds=400, chunk_rounds=1200,
                 target_commits=10**9)
# B1 under open arrival: the orthrus golden's workload and lanes (no
# figure runs orthrus open-loop), shedding, a retry budget, exp backoff
ORTHRUS_OA = dict(epoch_interval_rounds=150,
                  admission_policy="deadline_shed", deadline_rounds=400,
                  retry_budget=3, backoff_mode="exp", backoff_max_rounds=256)
BATCH_CELLS = (("dgcc", DGCC_FULL, YCSB_FULL),
               ("quecc", QUECC_FULL, YCSB_FULL),
               ("quecc_frag_pipe", QUECC_FRAG_PIPE_FULL, YCSB_FIG14),
               ("scheduled", SCHEDULED_FULL, YCSB_FIG18))
# slice 7, item 8: K-fused dispatch. Each cell runs three ways (the
# eager oracle issues every kernel from the host), so each runs half its
# depth of phases 4, 5, 9 and 10: the lock-table cells 1,000 rounds
# (SIM_K), the batch cells 2,000 (SIM_K_BATCH); widths stay
SIM_K = dict(max_rounds=1000, warmup_rounds=250, chunk_rounds=250,
             target_commits=10**9)
SIM_K_BATCH = dict(max_rounds=2000, warmup_rounds=500, chunk_rounds=500,
                   target_commits=10**9)
K_FUSED = 8
# phase 11's cells at about a quarter of those depths (256 and 512
# rounds): each runs three to five ways, the eager oracle issuing every
# kernel from the host, and the script must end inside its time limit on
# a slow host (PERF.md, section 4, lists the depths it ran before)
SIM_K11 = dict(SIM_K, max_rounds=256, warmup_rounds=64, chunk_rounds=64)
SIM_K11_BATCH = dict(SIM_K_BATCH, max_rounds=512, warmup_rounds=128,
                     chunk_rounds=128)
# name, engine kwargs, workload kwargs, depth, the kernel on its path
K_CELLS = (
    ("orthrus", ORTHRUS_FULL, YCSB_FULL, SIM_K11, "lock_grant"),
    ("orthrus plain path", dict(ORTHRUS_FULL, kernel_impl="jnp"), YCSB_FULL,
     SIM_K11, None),
    ("deadlock_free", DF_FULL, YCSB_FULL, SIM_K11, None),
    ("dgcc", DGCC_FULL, YCSB_FULL, SIM_K11_BATCH, "dep_wavefront"),
    ("quecc", QUECC_FULL, YCSB_FULL, SIM_K11_BATCH, "dep_wavefront"),
    ("quecc_frag_pipe", QUECC_FRAG_PIPE_FULL, YCSB_FIG14, SIM_K11_BATCH,
     "dep_wavefront"),
    ("scheduled", SCHEDULED_FULL, YCSB_FIG18, SIM_K11_BATCH,
     "dep_wavefront"),
) + tuple((p, dict(protocol=p, n_exec=80), YCSB_FULL, SIM_K11, None)
          for p in DL_PROTOCOLS) + (
    ("partitioned_store", PSTORE_FULL, YCSB_FIG6, SIM_K11, None),
    ("fig17_i200_deadline_shed", FIG17_SHED, YCSB_FIG16, SIM_K11, None),
)
# the cells that also run K = 5 (K = 8's runner: a cache hit) and K = 32
K_MORE = ("orthrus", "twopl_waitdie")

# slice 8, item 9: the multi-cell sweep. Fig 13's contention axis
# (benchmarks/figures.py:472-516): its 8 protocols at 40 lanes (the
# message-based ones 8 CC/planner + 32 exec, window 4) x hot sets 1,024,
# 64 and 16 on YCSB_FULL, at half SIM_K's depth (500 rounds: the
# script's time limit) with no commit target
SIM_SWEEP = dict(SIM_K, max_rounds=500, warmup_rounds=125, chunk_rounds=125)
SWEEP_LANES = 40
SWEEP_HOTS = (1024, 64, 16)
SWEEP_PROTOCOLS = (
    tuple((p, dict(protocol=p, n_exec=SWEEP_LANES))
          for p in DL_PROTOCOLS + ("deadlock_free", "partitioned_store"))
    + tuple((p, dict(protocol=p, n_cc=SWEEP_LANES // 5,
                     n_exec=SWEEP_LANES - SWEEP_LANES // 5, window=4))
            for p in ("orthrus", "dgcc", "quecc")))
# the reference's own sweep subset (benchmarks/perf_smoke.py:181-200):
# the saturated lock-table protocol and the batch-planned one across the
# contention axis, here with a finite commit target (the early exit)
EXIT_PROTOCOLS = ("twopl_waitdie", "dgcc")
SWEEP_MODE_ARGS = dict(devices=1, pipeline=2, early_exit=True)

# slice 10, item 12 (phase 14): the legacy state layout held to the
# packed engine on phase 11's cells at their depths (name, engine
# kwargs, workload kwargs, depth), and the cells whose step profiles it
# prints, legacy against packed
LEGACY_CELLS = (
    ("orthrus", ORTHRUS_FULL, YCSB_FULL, SIM_K),
    ("deadlock_free", DF_FULL, YCSB_FULL, SIM_K),
) + tuple((p, dict(protocol=p, n_exec=80), YCSB_FULL, SIM_K)
          for p in DL_PROTOCOLS) + (
    ("partitioned_store", PSTORE_FULL, YCSB_FIG6, SIM_K),
    ("dgcc", DGCC_FULL, YCSB_FULL, SIM_K_BATCH),
    ("quecc", QUECC_FULL, YCSB_FULL, SIM_K_BATCH),
)
LEGACY_PROFILED = ("orthrus", "dgcc")
# the latency oracle (tests/test_metrics.py:222-296) at the paper's
# width: fig4's widest wait-die cell closed loop (arrival = admission
# round), and fig17's 40-lane deadlock_free under open arrival with no
# admission policy (a 64-txn epoch every 200 rounds: arrival = (tid //
# 64) * 200). Name, engine kwargs, workload kwargs, (epoch txns,
# interval) or None for closed loop
ORACLE_SIM = dict(max_rounds=1000, warmup_rounds=0, chunk_rounds=250,
                  target_commits=10**9)
ORACLE_CELLS = (
    ("twopl_waitdie_closed", dict(protocol="twopl_waitdie", n_exec=80),
     YCSB_FULL, None),
    ("deadlock_free_open_i200", dict(FIG17_DF, epoch_interval_rounds=200),
     YCSB_FIG16, (64, 200)),
)
# Distributed ORTHRUS (phase 16, slice 12): tests/test_sharding.py's
# 8-shard cell and its per-shard commits under the JAX reference; then
# fig13's orthrus split (16 CC + 64 exec lanes) as 16 CC shards x 4 exec
# lanes over YCSB_FULL's 10 M records (625,000 keys a shard), each lane
# re-running one of the workload's first 64 txns, at a quarter of the
# figures' depth (16,000 rounds until phase 17 came: the script's limit)
DIST_TEST = dict(lanes_per_shard=8, keys_per_txn=3, rounds=200,
                 keys_per_shard=512, msg_cap=32)
DIST_TEST_COMMITS = [200, 200, 175, 200, 200, 175, 200, 200]
DIST_CC = 16
DIST_FULL = dict(lanes_per_shard=4, keys_per_txn=10, exec_rounds=3,
                 msg_cap=16, keys_per_shard=625_000)
DIST_ROUNDS = 4_000
DIST_CPU_ROUNDS = 500  # the depth at which the card is held to the CPU
DIST_HOTS = (64, 0)  # 64 hot keys, all on shard 0; uniform
DIST_PROFILED = 400
# the process form over NCCL, eager at 143-187 rounds/s: 500 rounds (2,000
# until the script's time limit forced the cut)
DIST_NCCL = dict(DIST_FULL, lanes_per_shard=4, keys_per_shard=10_000_000,
                 rounds=500)
# Training (phase 17, slice 13): (arch, depth cut, optimizer, batch, seq,
# steps on the kernel path and on the plain path) through
# launch.train.build_trainer on one card, bf16 params, remat "nothing",
# the whole loss (loss_chunk 0, the JAX launcher's). mixtral at its
# published width cut to 2 layers: serving's 8 do not fit with their
# grads (40.9 GB + 40.9 GB). rwkv6-1.6b's steps are the phase's longest
# (B5's plain backward loops over time, 7-10 s a kernel-path step at 512
# tokens): 256 tokens a sequence, and 2 steps a path. gemma3-1b 6 steps
# a path (the script's time limit)
TRAIN_CELLS = (
    ("gemma3-1b", {}, dict(name="adamw"), 4, 2048, (6, 6)),
    ("rwkv6-1.6b", {}, dict(name="adamw"), 2, 256, (2, 2)),
    ("mixtral-8x22b", dict(pattern_repeats=2), dict(name="adafactor"), 2,
     1024, (2, 2)),
)
TRAIN_LR = 1e-3  # the JAX launcher's default
TRAIN_CKPT_ARCH = "gemma3-1b"  # saved after its next-to-last step
# step 0's loss, kernel path against plain path (bf16 forwards)
TRAIN_LOSS_TOL = 0.02
# the watched step-0 grads (wq/wk/wv, routers, rwkv's time mix), kernel
# path against plain path, ||g_kernel - g_plain|| / ||g_plain||, are held
# kind by kind (attention projections, routers, time-mix projections,
# decay and bonus) to TRAIN_GRAD_NUDGES x how far the kernel path's own
# grads of that kind move at most when B4's and B5's outputs move by one
# bf16 unit (the yardstick phase 13 set hymba's logits by), or to
# TRAIN_GRAD_FLOOR where that is larger; that bound must stay below
# TRAIN_GRAD_POWER, since a missing gradient gives about 1
TRAIN_GRAD_NUDGES = 2.0
TRAIN_GRAD_POWER = 0.8
TRAIN_GRAD_FLOOR = 0.02
# Phase 18 (slice 14): the DTensor trainer's run_step calls a cell after
# its step 0 (rwkv's steps take 5-8 s: its step 0 is its one step), and
# GPipe at full width: gemma3-1b's 24 grouped layers as 4 stages of 6, 4
# microbatches of 1 x 2,048 tokens; its stage-stacked grads against the
# layers run in sequence, relative L2 by leaf (bf16 grads: the same ops,
# summed over the microbatches alike)
DT_STEPS = {"rwkv6-1.6b": 0}
PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = 4, 4, 2048
PIPE_GRAD_RTOL = 1e-2
# the checkpoint's next step against the uninterrupted run's
TRAIN_RESUME_TOL = 1e-3
# Phase 19 (slice 16): gemma3-1b's decode with its cache's rows cut into
# blocks as a mesh of SEQ_DECODE_BLOCKS ranks along cache_seq holds them;
# the cache is SEQ_DECODE_ROWS rows, all but the decoded token's filled
# by the prefill
SEQ_DECODE_ROWS, SEQ_DECODE_BLOCKS = 32768, 4
SEQ_DECODE_REPEATS = 5  # timed steps a path, after one untimed
# each autograd Function's backward against autograd through the plain
# version on the same inputs: the same kernels, so equal up to the
# atomics of index_add_ and embedding-style backwards; held to this
# share of the plain gradient's largest |value|
TRAIN_VJP_RTOL = 1e-3
# Phase 20 (slice 17): the examples under examples/torch_*.py, called
# in-process at their own sizes; the demo at its REPRO_DEMO_FAST budget
EXAMPLES = ROOT / "examples"
EXAMPLE_TRAIN_STEPS = 300  # examples/torch_train_lm.py's default
# B3's slot weights against plan_dispatch's (the same f32 products)
EXAMPLE_PLAN_WEIGHT_TOL = 1e-6


def fingerprint(res, include_metrics: bool = False) -> dict:
    """Everything a run reports except wall-clock (the keys of
    tests/golden/regenerate.py's ``fingerprint``)."""
    fp = dict(
        commits=res.commits,
        aborts_deadlock=res.aborts_deadlock,
        aborts_ollp=res.aborts_ollp,
        wasted_ops=res.wasted_ops,
        rounds=res.rounds,
        sim_seconds=res.sim_seconds,
        breakdown=res.breakdown,
        total_commits=res.raw["total_commits"],
        next_txn=res.raw["next_txn"],
        rounds_total=res.raw["rounds_total"],
        steps_executed=res.raw["steps_executed"],
    )
    fp.update({k: res.raw[k] for k in FINGERPRINT_OPT_KEYS if k in res.raw})
    if include_metrics and res.metrics is not None:
        m = res.metrics
        fp["lat_hist"] = [int(x) for x in m.lat_hist]
        fp["q_depth"] = [int(x) for x in m.q_depth]
        fp["q_inflight"] = [int(x) for x in m.q_inflight]
        fp["p50_rounds"] = m.p50
        fp["p99_rounds"] = m.p99
        fp["p999_rounds"] = m.p999
    return fp


def eager_ms(fn, repeats: int = 200, warmup: int = 10) -> float:
    """Milliseconds per ``fn()`` issued back to back from the host: CUDA
    events around ``repeats`` calls. Where the host issues work slower
    than the card runs it, this is the host's rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(repeats):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / repeats


def graph_ms(fn, repeats: int = 100, samples: int = 21) -> float:
    """Device milliseconds per ``fn()``: ``repeats`` calls captured in one
    CUDA graph, the graph replayed between CUDA events; the median of
    ``samples`` replays. No host work is inside the timed span."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeats):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / repeats)
    times.sort()
    return times[len(times) // 2]


def max_abs_err(got, want) -> int:
    """Largest absolute difference over matching integer/bool outputs."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"output {g.shape} {g.dtype} vs plain "
                                 f"{w.shape} {w.dtype}")
        err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def random_sorted_entries(n: int, seed: int, device):
    """Random kernel inputs sorted by key: long runs of one key, runs that
    cross 1,024-entry tiles, every REQ_* kind, inactive entries inside
    runs, and a KEY_SENTINEL padding tail."""
    import numpy as np
    import torch

    from repro_torch.core.lockgrant import KEY_SENTINEL, REQ_NONE

    rng = np.random.default_rng(seed)
    n_pad = n // 16
    m = n - n_pad
    # geometric run lengths, a few runs thousands of entries long
    lens = np.minimum(rng.geometric(1 / 40, size=m // 10 + 1), m)
    lens[rng.random(len(lens)) < 0.02] *= 60
    runs = np.repeat(np.arange(len(lens)), lens)[:m]
    keys = np.concatenate([runs * 3, np.full(n_pad, KEY_SENTINEL)])
    kind = rng.integers(0, 4, n)
    kind[m:] = REQ_NONE
    wh_free = rng.random(n) < 0.7
    rc = np.where(rng.random(n) < 0.6, 0, rng.integers(1, 4, n))

    def t(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    return (t(keys, torch.int32), t(kind, torch.int32),
            t(wh_free, torch.bool), t(rc, torch.int32))


def random_requests(n: int, num_records: int, seed: int, device):
    """Unsorted wrapper inputs: keys up to 2 * num_records (so some lie
    past the lock table), unique stamps, all REQ_* kinds, and a lock
    table with write holders and read counts."""
    import numpy as np
    import torch

    from repro_torch.core.lockgrant import KEY_SENTINEL, REQ_NONE

    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2 * num_records, n)
    kind = rng.integers(0, 4, n)
    keys = np.where(kind == REQ_NONE, KEY_SENTINEL, keys)
    ts = rng.permutation(n)
    wh = np.where(rng.random(num_records) < 0.3, 5, -1)
    rc = np.where(rng.random(num_records) < 0.3, rng.integers(1, 4,
                                                              num_records), 0)

    def t(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    return t(keys), t(ts), t(kind), t(wh), t(rc)


def random_step(T: int, K: int, num_records: int, seed: int, device):
    """Random inputs of the fused grant (``lock_grant_step``): keys that
    collide on 16 hot records, and some past the lock table; both modes;
    pending, release and inactive entries; stamps with ties and negative
    ones (as after ``rebase_enq``); a lock table whose write holders
    include the entries' own slots (re-entrant grants) and whose read
    counts are partly non-zero. Returns the call's arguments."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    shape = (T, K)
    keys = np.where(rng.random(shape) < 0.5, rng.integers(0, 16, shape),
                    rng.integers(0, num_records + num_records // 4 + 1,
                                 shape))
    modes = rng.integers(0, 2, shape)
    pend = rng.random(shape) < 0.4
    rel = rng.random(shape) < 0.1
    enq = rng.integers(-50, T * K // 2 + 1, shape)
    R1 = num_records + 1
    wh = np.where(rng.random(R1) < 0.3, rng.integers(0, T, R1), -1)
    rc = np.where(rng.random(R1) < 0.3, rng.integers(1, 4, R1), 0)

    def t(a, dt=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    return (t(keys), t(modes), t(pend, torch.bool), t(rel, torch.bool),
            t(enq), t(wh), t(rc), num_records)


def chain_inputs(step_args):
    """The engine's chain around the sorted form on one round's inputs:
    (the sorted-form inputs, the chain's other arguments)."""
    import torch

    from repro_torch.core import engine
    from repro_torch.core.lockgrant import (
        REQ_NONE,
        REQ_READ,
        REQ_RELEASE,
        REQ_WRITE,
    )

    keys, modes, pend2d, rel, enq, wh, rc, R = step_args
    T, K = keys.shape
    dev = keys.device
    ent_slot = torch.arange(T, dtype=torch.int32,
                            device=dev).repeat_interleave(K)
    consts = tuple(torch.tensor(v, dtype=torch.int32, device=dev)
                   for v in (REQ_WRITE, REQ_READ, REQ_RELEASE, REQ_NONE))
    chain_args = (keys, modes, pend2d, rel, enq, wh[:R], rc[:R], ent_slot,
                  consts)
    sorted_args = []

    def grab(*a):
        sorted_args[:] = a
        return a[1] == -1  # any bool [N]; the inputs are what is wanted

    engine.grant_chain(*chain_args, grab)
    return sorted_args, chain_args


def capture_orthrus_round(device, max_rounds: int = 400):
    """The fused grant's inputs (cloned) of the round with the most
    pending entries in a short full-width ORTHRUS run."""
    from repro_torch.core.engine import EngineConfig, make_plan
    from repro_torch.core.sweep import simulate_eager
    from repro_torch.core.workloads import WorkloadConfig, make_workload
    from repro_torch.kernels.lock_grant import ops

    captured = []
    most = [-1]
    original = ops.lock_grant_step

    def capture(*args, **kw):
        n = int(args[2].sum())
        if n >= most[0]:
            most[0] = n
            captured[:] = [a.clone() if hasattr(a, "clone") else a
                           for a in args]
        return original(*args, **kw)

    cfg = EngineConfig(**ORTHRUS_FULL, max_rounds=max_rounds,
                       warmup_rounds=0, chunk_rounds=max_rounds,
                       target_commits=10**9, kernel_impl="pallas")
    plan = make_plan(cfg, make_workload(WorkloadConfig(**YCSB_FULL)))
    ops.lock_grant_step = capture
    try:
        # eager: the capture reads each round's inputs on the host
        simulate_eager(cfg, plan, device=device)
    finally:
        ops.lock_grant_step = original
    if not captured:
        raise AssertionError("the ORTHRUS run made no grant pass")
    return captured


def in_turns(fns: dict, timer, rounds: int = 1) -> dict:
    """``timer(fn)`` of every entry of ``fns``, in turns: in order, then
    in reverse order, ``rounds`` times; name -> (the readings, their
    mean)."""
    got = {name: [] for name in fns}
    for name in (list(fns) + list(fns)[::-1]) * rounds:
        got[name].append(timer(fns[name]))
    return {name: (v, sum(v) / len(v)) for name, v in got.items()}


def print_turns(what: str, res: dict) -> None:
    print(f"{what}, in turns (forward then reversed; each reading and the "
          f"mean, ms): " + "; ".join(
              f"{name} {' / '.join(f'{x:.6f}' for x in v)} = {m:.6f}"
              for name, (v, m) in res.items()))


def scan_build_report(names=("lock_grant", "lock_grant_tile",
                             "dep_wavefront", "dep_wavefront_tile",
                             "moe_dispatch")) -> None:
    """B1's, B2's and B3's builds (the libraries ``names``), per kernel of
    each library and of the earlier designs': registers, shared memory
    and spills (0 required), from nvcc's -Xptxas -v."""
    from repro_torch.kernels import _build

    for name in names:
        if name not in _build.BUILD_LOG:
            print(f"build: {name} was built before this run (cached in "
                  f"{_build.BUILD_DIR}): no ptxas report")
            continue
        found = ptxas_entries(_build.BUILD_LOG[name][1])
        if not found:
            raise AssertionError(f"build: no ptxas report for {name}")
        for fn, got in sorted(found.items()):
            stores, loads = got.get("spills", (None, None))
            what = (f"{name}: {fn}: {got.get('registers')} registers, "
                    f"static shared memory {got.get('smem')} B; spill "
                    f"stores {stores} B, spill loads {loads} B")
            print(f"build: {what}")
            if stores != 0 or loads != 0:
                raise AssertionError(f"B1/B2/B3 spills: {what}")


def check_lock_grant(device, sizes=(1, 1024, 2560, 4096, 4097, 65536,
                                    1 << 20)) -> dict:
    """Phase 2: B1 against its plain versions, bit-equal: the fused form
    on the round of a full-width ORTHRUS run and on random rounds (T*K =
    12 .. 4,096; above the capacity the engine's chain around the sorted
    form), the sorted form and its earlier design on that round's sorted
    entries and on random sorted inputs up to 2^20, the whole wrapper
    against ``grant_round``. Then times, in turns: the sorted form
    against its earlier design, the fused launch against the eager chain
    it replaces (graph replay and host-issued), the launch floor."""
    import torch

    from repro_torch.core import engine
    from repro_torch.core.lockgrant import grant_round
    from repro_torch.kernels.lock_grant import ops
    from repro_torch.kernels.lock_grant.ref import (
        lock_grant_ref,
        lock_grant_step_ref,
    )

    scan_build_report()
    err = 0
    designs = {"kernel": ops.lock_grant_cuda,
               "earlier design": ops._lock_grant_tile}

    def hold_sorted(label, args):
        want = lock_grant_ref(*args)
        e = max(max_abs_err(fn(*args), want) for fn in designs.values())
        print(f"lock_grant sorted form: {label}: kernel and earlier design "
              f"bit-equal (max_abs_err {e})")
        return e

    def hold_step(label, args):
        want = lock_grant_step_ref(*args)
        e = max_abs_err((ops.lock_grant_step_cuda(*args),), (want,))
        print(f"lock_grant fused form: {label}: bit-equal (max_abs_err {e}, "
              f"{int(args[2].sum())} pending, {int(want.sum())} granted)")
        return e

    main = capture_orthrus_round(device)
    T, K = main[0].shape
    n_main = T * K
    err = max(err, hold_step(f"the round of a full-width ORTHRUS run with "
                             f"the most pending entries, T*K = {T}*{K}",
                             main))
    sorted_main, chain_main = chain_inputs(main)
    err = max(err, hold_sorted(f"that round's N={n_main} sorted entries",
                               sorted_main))
    for i, (t, k) in enumerate(((4, 3), (16, 10), (64, 10), (256, 10),
                                (409, 10), (512, 8))):
        for seed in range(3):
            R = (3, 50, 131072)[seed]
            err = max(err, hold_step(f"random T*K = {t}*{k}, R = {R}",
                                     random_step(t, k, R, 10 * i + seed,
                                                 device)))
    # above the capacity the engine runs its chain around the sorted form
    big = random_step(512, 10, 1000, 99, device)
    try:
        ops.step_output(512, 10, 1000, device)
        raise AssertionError("lock_grant_step took 5,120 entries")
    except ValueError:
        pass
    got = engine.grant_chain(
        *chain_inputs(big)[1],
        lambda *a: ops.lock_grant_sorted(*a)[0])
    e = max_abs_err((got,), (lock_grant_step_ref(*big),))
    print(f"lock_grant above the fused capacity (T*K = 512*10): the "
          f"engine's chain around the sorted form bit-equal (max_abs_err "
          f"{e})")
    err = max(err, e)
    for i, n in enumerate(sizes):
        err = max(err, hold_sorted(f"random N={n}", random_sorted_entries(
            n, seed=i, device=device)))
        if n >= 8:
            keys, ts, kind, wh, rc = random_requests(n, n // 8, seed=i,
                                                     device=device)
            g1, c1 = ops.lock_grant(keys, ts, kind, wh, rc,
                                    num_records=n // 8, block_n=1024)
            g0, c0, _ = grant_round(keys, ts, kind, wh, rc, n // 8)
            e = max_abs_err((g1, c1), (g0, c0))
            print(f"lock_grant: random N={n}: the whole wrapper bit-equal "
                  f"to grant_round (max_abs_err {e})")
            err = max(err, e)
    if err:
        raise AssertionError(f"lock_grant disagrees with its plain version "
                             f"(max_abs_err {err})")

    # device time per call from CUDA graph replays, in turns
    res = in_turns({name: (lambda fn=fn: fn(*sorted_main))
                    for name, fn in designs.items()}, graph_ms)
    print_turns(f"lock_grant sorted form, device time at N={n_main}", res)
    out = ops.step_output(T, K, main[7], device)
    sorted_kernel = (lambda *a: ops.lock_grant_cuda(*a)[0])
    fns = {
        "fused launch": lambda: ops.lock_grant_step_cuda(*main, out=out),
        "the chain it replaces (sorted-form kernel)":
            lambda: engine.grant_chain(*chain_main, sorted_kernel),
        "launch floor (empty kernel, 1,024 threads)":
            lambda: ops._launch_floor(device),
    }
    dev_res = in_turns(fns, graph_ms)
    print_turns(f"lock_grant grant pass, device time (graph replay) at "
                f"T*K = {n_main}", dev_res)
    fns["eager elementwise op (a & b)"] = lambda: main[2] & main[3]
    host_res = in_turns(fns, eager_ms)
    print_turns(f"lock_grant grant pass, host-issued (eager) at "
                f"T*K = {n_main}", host_res)
    ms = dev_res["fused launch"][1]
    plain_ms = graph_ms(lambda: lock_grant_step_ref(*main))
    # the fused form must read each entry's key, mode, stamp and pending
    # flag (13 B) and write its grant (1 B), and gather the write holder
    # and read count (8 B) of each pending entry of a record in the table;
    # the release mask changes no grant
    keys, pend = main[0], main[2]
    n_cand = int((pend & (keys < main[7])).sum())
    n_bytes = n_main * (13 + 1) + n_cand * 8
    # per entry: the pending and range tests, a hash, two minima of two
    # compares each and the decision's six compares
    n_ops = n_main * 2 + n_cand * 14
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    print(f"lock_grant fused form at T*K = {n_main} ({n_cand} pending "
          f"entries in the table): kernel {ms:.6f} ms, plain "
          f"{plain_ms:.6f} ms, bound {max(bytes_ms, ops_ms):.9f} ms "
          f"({n_bytes} B); host-issued {host_res['fused launch'][1]:.6f} "
          f"ms a call against {host_res['eager elementwise op (a & b)'][1]:.6f}"
          f" for one eager elementwise op")
    return dict(
        name="lock_grant",
        route="cuda",
        source="src/repro_torch/kernels/lock_grant/csrc/lock_grant.cu",
        replaces="src/repro/kernels/lock_grant/kernel.py:84",
        launches=0,
        max_abs_err=err,
        ms=ms,
        plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None,
    )


def random_grouped_edges(n: int, seed: int, device):
    """Random kernel inputs grouped by dst: geometric runs, a few runs
    thousands of edges long (crossing 1,024-edge tiles), padding entries
    inside the list and a KEY_SENTINEL padding tail."""
    import numpy as np
    import torch

    from repro_torch.core.lockgrant import KEY_SENTINEL

    rng = np.random.default_rng(seed)
    lens = rng.geometric(1 / 12, size=n)
    lens[rng.random(n) < 0.02] *= 150
    dst = np.repeat(np.arange(len(lens)), lens)[:n]
    dst = np.where(rng.random(n) < 0.05, KEY_SENTINEL, dst)
    dst[n - n // 16:] = KEY_SENTINEL
    ok = rng.random(n) < 0.7
    return (torch.as_tensor(dst, dtype=torch.int32, device=device),
            torch.as_tensor(ok, dtype=torch.bool, device=device))


def random_dependency_edges(n: int, n_units: int, seed: int, device):
    """Unsorted wrapper inputs: edges between random units, padding
    entries mixed in, and a random committed bitmap."""
    import numpy as np
    import torch

    from repro_torch.core.lockgrant import KEY_SENTINEL

    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n_units, n)
    dst = np.where(rng.random(n) < 0.1, KEY_SENTINEL, dst)
    src = rng.integers(0, n_units, n)
    done = rng.random(n_units) < 0.8

    def t(a, dt):
        return torch.as_tensor(a, dtype=dt, device=device)

    return t(dst, torch.int32), t(src, torch.int32), t(done, torch.bool)


def random_rows(T: int, P: int, n_units: int, seed: int, device):
    """Random inputs of B2's row form: runs of rows of one unit whose
    predecessor rows differ (so segments join rows), rows with no
    predecessor and partial rows, and committed flags over the units
    and the drop row."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    unit = rng.integers(0, n_units, T)
    run = rng.random(T) < 0.4
    for t in range(1, T):
        if run[t]:
            unit[t] = unit[t - 1]
    preds = rng.integers(0, n_units, (T, P))
    preds[rng.random((T, P)) < 0.3] = -1
    preds[rng.random(T) < 0.1] = -1
    done = rng.random(n_units + 1) < 0.7

    def t(a, dt=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    return t(unit), t(preds), t(done, torch.bool)


def capture_scan(eng_kw, wl_kw, device, max_rounds: int = 1500):
    """The row form's inputs (slot units, predecessor rows, the committed
    flags; cloned) of the readiness check with the most live edges in a
    short run of one full-width batch cell."""
    from repro_torch.core.engine import EngineConfig, make_plan
    from repro_torch.core.sweep import simulate_eager
    from repro_torch.core.workloads import WorkloadConfig, make_workload
    from repro_torch.kernels.dep_wavefront import ops

    captured = []
    most = [-1]
    original = ops.dep_wavefront_rows

    def capture(*args, **kw):
        live = int((args[1] >= 0).sum())
        if live >= most[0]:
            most[0] = live
            captured[:] = [a.clone() for a in args]
        return original(*args, **kw)

    cfg = EngineConfig(**eng_kw, max_rounds=max_rounds, warmup_rounds=0,
                       chunk_rounds=max_rounds, target_commits=10**9,
                       kernel_impl="pallas")
    plan = make_plan(cfg, make_workload(WorkloadConfig(**wl_kw)))
    ops.dep_wavefront_rows = capture
    try:
        # eager: the capture reads each check's inputs on the host
        simulate_eager(cfg, plan, device=device)
    finally:
        ops.dep_wavefront_rows = original
    if not captured:
        raise AssertionError(f"{eng_kw}: the run made no readiness scan")
    return captured


def check_dep_wavefront(device, sizes=(1, 40, 128, 768, 1000, 2048, 3000,
                                       4096, 4097, 65536, 1 << 20)) -> dict:
    """Phase 2: B2 against its plain versions, bit-equal: the row form on
    the readiness check of each of the four full-width batch cells (also
    against the dense check) and on random rows (runs of one unit with
    differing rows, T up to 1,500 rows), the grouped-edge form and its
    earlier design on those checks' edges and on random grouped edges up
    to 2^20, the whole wrapper against the dense oracle. Then times, in
    turns: the grouped-edge form against its earlier design, the row
    form against the eager chain it replaces and the dense plain path
    (graph replay and host-issued), the launch floor."""
    import torch

    from repro_torch.core.lockgrant import KEY_SENTINEL
    from repro_torch.kernels.dep_wavefront import ops
    from repro_torch.kernels.dep_wavefront.ref import (
        dep_wavefront_ref,
        dep_wavefront_rows_ref,
    )

    err = 0
    designs = {"kernel": ops.dep_wavefront_cuda,
               "earlier design": ops._dep_wavefront_tile}

    def hold_grouped(label, args):
        want = dep_wavefront_ref(*args)
        e = max(max_abs_err(fn(*args), want) for fn in designs.values())
        print(f"dep_wavefront grouped edges: {label}: kernel and earlier "
              f"design bit-equal (max_abs_err {e})")
        return e

    def edges_of(row_unit, preds, done):
        dst = torch.where(preds >= 0, row_unit[:, None],
                          KEY_SENTINEL).reshape(-1)
        ok = done[torch.clamp(preds, 0, done.shape[0] - 1).long()]
        return dst, ok.reshape(-1)

    shapes = {}
    for name, eng_kw, wl_kw in BATCH_CELLS:
        row_unit, preds, done = capture_scan(eng_kw, wl_kw, device)
        T, P = preds.shape
        live = int((preds >= 0).sum())
        got = ops.dep_wavefront_rows_cuda(row_unit, preds, done)
        dense = ((preds < 0) | done[torch.clamp(preds, min=0).long()]).all(1)
        e = max(max_abs_err((got,), (dep_wavefront_rows_ref(
            row_unit, preds, done),)), max_abs_err((got,), (dense,)))
        print(f"dep_wavefront row form: the check with the most live edges "
              f"of a full-width {name} run (T={T} rows of P={P}, E={T * P}, "
              f"{live} live): bit-equal to its plain version and to the "
              f"dense check (max_abs_err {e})")
        err = max(err, e, hold_grouped(f"that check's E={T * P} edges",
                                       edges_of(row_unit, preds, done)))
        shapes[name] = (row_unit, preds, done)
    for i, (t, p, nu) in enumerate(((1, 1, 2), (40, 1, 30), (128, 1, 100),
                                    (256, 3, 200), (256, 8, 200),
                                    (1500, 3, 400), (3000, 2, 50))):
        for seed in range(2):
            args = random_rows(t, p, nu, 10 * i + seed, device)
            got = ops.dep_wavefront_rows_cuda(*args)
            e = max_abs_err((got,), (dep_wavefront_rows_ref(*args),))
            print(f"dep_wavefront row form: random T={t} rows of P={p}: "
                  f"bit-equal (max_abs_err {e})")
            err = max(err, e)
    for i, n in enumerate(sizes):
        err = max(err, hold_grouped(f"random E={n}", random_grouped_edges(
            n, seed=i, device=device)))
        n_units = max(n // 8, 2)
        edst, esrc, done = random_dependency_edges(n, n_units, seed=i,
                                                   device=device)
        got = ops.dep_wavefront_ready(edst, esrc, done, num_txns=n_units,
                                      block_n=1024)
        plain = ops.dep_wavefront_ready(edst.cpu(), esrc.cpu(), done.cpu(),
                                        num_txns=n_units, block_n=1024)
        live_e = edst != KEY_SENTINEL
        oracle = torch.ones(n_units + 1, dtype=torch.int32, device=device)
        oracle.scatter_reduce_(
            0, torch.where(live_e, edst, n_units).long(),
            done[esrc.long()].to(torch.int32), "amin", include_self=True)
        e = max(max_abs_err((got,), (plain.to(device),)),
                max_abs_err((got,), (oracle[:n_units] > 0,)))
        print(f"dep_wavefront: random E={n}: the whole wrapper ({n_units} "
              f"units) bit-equal to its plain run and the dense oracle "
              f"(max_abs_err {e})")
        err = max(err, e)
    if err:
        raise AssertionError(f"dep_wavefront disagrees with its plain version "
                             f"(max_abs_err {err})")

    def chain(row_unit, preds, done):
        """The kernel path's stage 4 before the row form: the gather, the
        where, the grouped-edge kernel, the per-row amax, the compare."""
        src_ok = done[torch.clamp(preds, min=0).long()]
        edge_dst = torch.where(preds >= 0, row_unit[:, None], KEY_SENTINEL)
        miss, _pos = ops.dep_wavefront_cuda(edge_dst.reshape(-1),
                                            src_ok.reshape(-1))
        return miss.view(preds.shape).amax(dim=1) == 0

    def dense(row_unit, preds, done):
        return ((preds < 0) | done[torch.clamp(preds, min=0).long()]).all(1)

    rows = {}
    for name, (row_unit, preds, done) in shapes.items():
        E = preds.numel()
        edges = edges_of(row_unit, preds, done)
        res = in_turns({n_: (lambda fn=fn: fn(*edges))
                        for n_, fn in designs.items()}, graph_ms)
        print_turns(f"dep_wavefront grouped edges, device time at E={E} "
                    f"({name})", res)
        out = ops.rows_output(*preds.shape, done.shape[0], device)
        args = (row_unit, preds, done)
        fns = {
            "row form": lambda: ops.dep_wavefront_rows_cuda(*args, out=out),
            "the chain it replaces": lambda: chain(*args),
            "the dense plain path": lambda: dense(*args),
            "launch floor (empty kernel, 1,024 threads)":
                lambda: ops._launch_floor(device),
        }
        dev_res = in_turns(fns, graph_ms)
        print_turns(f"dep_wavefront stage 4, device time (graph replay) at "
                    f"E={E} ({name})", dev_res)
        host_res = in_turns(fns, eager_ms)
        print_turns(f"dep_wavefront stage 4, host-issued (eager) at E={E} "
                    f"({name})", host_res)
        rows[name] = (E, dev_res["row form"][1], args)
    # the JSON row: the largest main-path shape (quecc)
    name = max(rows, key=lambda k: rows[k][0])
    E, ms, (row_unit, preds, done) = rows[name]
    plain_ms = graph_ms(lambda: dep_wavefront_rows_ref(row_unit, preds,
                                                       done))
    T = preds.shape[0]
    live = int((preds >= 0).sum())
    # each pred read once (4 B) and each row's unit (4 B), the committed
    # flag of each live edge gathered (1 B), each row's verdict written
    n_bytes = E * 4 + T * 4 + live + T
    # per edge: the liveness test, the miss test, the segment flag and a
    # running sum; per row the verdict
    n_ops = E * 4 + T * 3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    print(f"dep_wavefront row form at E={E} ({name}, {live} live edges): "
          f"kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, bound "
          f"{max(bytes_ms, ops_ms):.9f} ms ({n_bytes} B)")
    return dict(
        name="dep_wavefront",
        route="cuda",
        source="src/repro_torch/kernels/dep_wavefront/csrc/dep_wavefront.cu",
        replaces="src/repro/kernels/dep_wavefront/kernel.py:75",
        launches=0,
        max_abs_err=err,
        ms=ms,
        plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None,
    )


def tree_tensors(tree):
    """Every tensor of a nested dict/list of tensors."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_tensors(v)
    else:
        yield tree


def full_model(arch, device, **cut):
    """``arch`` at its published width (``cut`` may change its depth),
    bf16, random weights from SEED."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(arch), **cut)
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, SEED, device)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_tensors(params))
    heads = (f"{cfg.ssm_heads} heads of {cfg.head_dim}" if cfg.family == "ssm"
             else f"{cfg.num_heads} query heads over {cfg.num_kv_heads} KV "
             f"head of {cfg.head_dim}")
    ffn = (f"{cfg.num_experts} experts top-{cfg.experts_per_token} of d_ff "
           f"{cfg.expert_d_ff}" if cfg.num_experts else f"d_ff {cfg.d_ff}")
    print(f"{arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, {heads}, "
          f"{ffn}, vocab {cfg.vocab_size}: {n} parameters in "
          f"{cfg.dtype}, made on the card in {time.time() - t0:.3f} s; "
          f"torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B, "
          f"{torch.cuda.memory_allocated()} B held in all")
    return cfg, params


def capture_attention(cfg, params, seq_len, device):
    """The kernel's inputs at every layer of one full-width prefill of a
    ``seq_len``-token prompt (the main path's calls, in layer order)."""
    import numpy as np
    import torch

    from repro_torch.models import layers
    from repro_torch.models import model as M

    captured = []
    original = layers.flash_attention

    def capture(q, k, v, *, kind, window):
        captured.append((q.clone(), k.clone(), v.clone(), kind, window))
        return original(q, k, v, kind=kind, window=window)

    prompt = np.random.default_rng(SEED + 1).integers(2, cfg.vocab_size,
                                                      seq_len)
    layers.flash_attention = capture
    try:
        M.prefill(params, cfg, torch.as_tensor(prompt, device=device)[None],
                  kernel_impl="auto")
    finally:
        layers.flash_attention = original
    if len(captured) != cfg.num_layers:
        raise AssertionError(f"a prefill made {len(captured)} attention "
                             f"calls, not {cfg.num_layers}")
    return captured


def attention_bound(q, k, kind, window):
    """(bound ms, bound_by) of one attention call: the two products'
    operations over the visible (query, key) pairs, at the peak for the
    input type (bf16 tensor cores; f32 CUDA cores), against q, k, v read
    once and o written once at the HBM rate."""
    import numpy as np
    import torch

    B, S, HQ, D = q.shape
    T, HKV = k.shape[1], k.shape[2]
    qp = np.arange(S)
    n = np.minimum(qp + 1, T)
    if kind == "swa" and window:
        n = np.minimum(n, window)
    elif kind == "chunked" and window:
        n = np.minimum(n, qp % window + 1)
    flops = 4 * B * HQ * D * int(n.sum())
    bf16 = q.dtype == torch.bfloat16
    ops_ms = flops / (BF16_OPS_PER_S if bf16 else FP32_OPS_PER_S) * 1e3
    n_bytes = (2 * B * S * HQ * D + 2 * B * T * HKV * D) * q.element_size()
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def sdpa_call(q, k, v, kind, window):
    """One F.scaled_dot_product_attention call computing the kernel's
    function (the yardstick; the port never calls it): is_causal where
    the mask is the causal one (full, or a window no query reaches past),
    an explicit boolean mask otherwise. Returns (the call, which of the
    two)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import mask_fn

    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    mask = mask_fn(kind, torch.arange(q.shape[1], device=q.device),
                   torch.arange(k.shape[1], device=q.device), window)
    if torch.equal(mask, mask_fn("full", *(torch.arange(
            n, device=q.device) for n in mask.shape), 0)):
        return (lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True).transpose(1, 2),
            "is_causal")
    return (lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, enable_gqa=True).transpose(1, 2),
        "boolean mask")


def cuda_kernel_names(fn) -> str:
    """The CUDA kernels one call of ``fn`` runs (which SDPA backend)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kern.sort(key=lambda e: -e.self_device_time_total)
    return "; ".join(e.key[:70] for e in kern[:3])


def random_attention(B, S, HQ, HKV, D, dtype, seed, device, scale=1.0):
    """q, k, v [B, S, H, D] from a seed: unit normal by default, as q and
    k are after gemma's qk-norm."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return tuple((torch.randn((B, S, h, D), generator=g, device=device)
                  * scale).to(dtype) for h in (HQ, HKV, HKV))


def bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits), 0 at 0."""
    import torch

    mag = x.abs()
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return torch.where(mag > 0, ulp, torch.zeros_like(ulp))


def check_flash_attention(device, model, mixtral_attn) -> dict:
    """Phase 2: flash_attention against its plain version, within the
    tolerances of tests/test_kernels.py, on a real full-width gemma3-1b
    prefill, on every layer of a real full-width mixtral-8x22b prefill
    (``mixtral_attn``, capture_mixtral's calls) and on random inputs
    (bf16 on the tensor-core kernel, f32 on the CUDA-core one); its
    build report; times in turns at gemma's shapes and at mixtral's,
    whose layer 0 (where B4 costs the most device time per run) gives
    the JSON row's numbers."""
    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    cfg, params = model
    worst = [0.0]
    failed = []

    def check(label, q, k, v, kind, window):
        """Largest |kernel - plain| and its ratio to the tolerance."""
        err, ratio, finite = flash_attention_error(q, k, v, kind, window)
        if not (ratio <= 1 and finite):
            failed.append(f"{label} {kind} {window} {q.dtype}: {err}")
        worst[0] = max(worst[0], err)
        return err, ratio

    seq = 2048
    real = capture_attention(cfg, params, seq, device)
    for kind in ("swa", "full"):
        errs = [check(f"layer {i}", q, k, v, kd, w)
                for i, (q, k, v, kd, w) in enumerate(real) if kd == kind]
        print(f"flash_attention: the {len(errs)} {kind} layers of a "
              f"full-width {seq}-token gemma3-1b prefill (bf16, q "
              f"{tuple(real[0][0].shape)}): max_abs_err "
              f"{max(e for e, _ in errs)}, at most {max(r for _, r in errs)} "
              f"of the tolerance")
    errs = [check(f"mixtral-8x22b layer {i}", *c)
            for i, c in enumerate(mixtral_attn)]
    q, k = mixtral_attn[0][:2]
    print(f"flash_attention: the {len(errs)} layers of a full-width "
          f"{q.shape[1]}-token mixtral-8x22b prefill (bf16, q "
          f"{tuple(q.shape)}, k {tuple(k.shape)}: {q.shape[2] // k.shape[2]} "
          f"query heads per KV head of {q.shape[3]}, {mixtral_attn[0][3]} "
          f"window {mixtral_attn[0][4]}): max_abs_err "
          f"{max(e for e, _ in errs)}, at most {max(r for _, r in errs)} of "
          f"the tolerance")
    for dtype in (torch.bfloat16, torch.float32):
        for s in (7, 511, 512, 513, 2048, 4096):
            args = random_attention(1, s, cfg.num_heads, cfg.num_kv_heads,
                                    cfg.head_dim, dtype, s, device)
            for kind, w in (("full", 0), ("swa", cfg.window),
                            ("chunked", cfg.window)):
                e, r = check(f"random S={s}", *args, kind, w)
                print(f"flash_attention: random S={s} {kind} window {w} "
                      f"{dtype}: max_abs_err {e}, {r} of the tolerance")
    # test_kernels.py's shapes, and SMOKE mixtral's heads (d = 16, which
    # examples/torch_serve_lm.py serves) at a ragged length
    for B, s, h, kv, d in ((2, 128, 4, 2, 32), (2, 256, 2, 2, 64),
                           (2, 100, 4, 2, 16)):
        for dtype in (torch.bfloat16, torch.float32):
            args = random_attention(B, s, h, kv, d, dtype, s + h, device,
                                    scale=0.2)
            for kind, w in (("full", 0), ("swa", 64), ("chunked", 64)):
                e, r = check(f"test_kernels B={B} S={s} H={h} KV={kv} "
                             f"d={d}", *args, kind, w)
                print(f"flash_attention: test_kernels shape B={B} S={s} "
                      f"H={h} KV={kv} d={d} {kind} {dtype}: max_abs_err {e}, "
                      f"{r} of the tolerance")
    if failed:
        raise AssertionError("flash_attention disagrees with its plain "
                             "version: " + "; ".join(failed))

    def timed(label, q, k, v, kind, window):
        ms = graph_ms(lambda: ops.flash_attention_cuda(
            q, k, v, kind=kind, window=window), repeats=10, samples=11)
        plain_ms = graph_ms(lambda: flash_attention_ref(
            q, k, v, kind=kind, window=window), repeats=10, samples=11)
        lib, how = sdpa_call(q, k, v, kind, window)
        lib_ms = graph_ms(lib, repeats=10, samples=11)
        lib_err = float((lib().float() - flash_attention_ref(
            q, k, v, kind=kind, window=window).float()).abs().max())
        bound_ms, bound_by = attention_bound(q, k, kind, window)
        print(f"flash_attention device time, {label} {kind} {q.dtype} q "
              f"{tuple(q.shape)}: kernel {ms:.6f} ms, plain {plain_ms:.6f} "
              f"ms, F.scaled_dot_product_attention ({how}) {lib_ms:.6f} ms "
              f"(max_abs_err {lib_err} vs plain; kernels: "
              f"{cuda_kernel_names(lib)}), bound {bound_ms:.6f} ms "
              f"({bound_by}), kernel at {bound_ms / ms:.4f} of its bound")
        return ms, plain_ms, lib_ms, bound_ms, bound_by

    def timed_in_turns(label, q, k, v, kind, window):
        """Device ms, in one call and in turns (each timed twice, the
        order reversed the second time): the kernel (its own choice of
        head packing), the tensor-core kernel at one and at two query
        heads of a KV head a block, the earlier CUDA-core design, the
        plain version and SDPA (the yardstick); beside the bound. The
        mean of the two turns."""
        lib, how = sdpa_call(q, k, v, kind, window)
        paired = ops._flash_attention_tc(q, k, v, kind=kind, window=window,
                                         heads_per_block=2)
        single = ops._flash_attention_tc(q, k, v, kind=kind, window=window,
                                         heads_per_block=1)
        torch.cuda.synchronize()
        if not torch.equal(paired, single):
            failed.append(f"{label}: one head a block differs from two")
        fns = {
            "kernel": lambda: ops.flash_attention_cuda(
                q, k, v, kind=kind, window=window),
            "one head a block": lambda: ops._flash_attention_tc(
                q, k, v, kind=kind, window=window, heads_per_block=1),
            "two heads a block": lambda: ops._flash_attention_tc(
                q, k, v, kind=kind, window=window, heads_per_block=2),
            "CUDA-core design": lambda: ops._flash_attention_simt(
                q, k, v, kind=kind, window=window),
            "plain": lambda: flash_attention_ref(q, k, v, kind=kind,
                                                 window=window),
            f"SDPA ({how})": lib,
        }
        turns = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                turns[name].append(graph_ms(fns[name], repeats=10,
                                            samples=11))
        ms = {name: sum(t) / len(t) for name, t in turns.items()}
        bound_ms, bound_by = attention_bound(q, k, kind, window)
        kern = ms["kernel"]
        print(f"flash_attention in turns, {label} ({kind} window {window}, "
              f"q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype}; "
              f"{power}): " + "; ".join(
                  f"{name} {t[0]:.6f} / {t[1]:.6f} ms" for name, t in
                  turns.items())
              + f"; bound {bound_ms:.6f} ms ({bound_by}); the kernel at "
              f"{bound_ms / kern:.4f} of its bound, "
              f"{kern / ms[f'SDPA ({how})']:.3f}x SDPA, "
              f"{ms['CUDA-core design'] / kern:.2f}x faster than the "
              f"CUDA-core design; two heads a block "
              f"{ms['two heads a block'] / ms['one head a block']:.3f}x "
              f"one head a block's time")
        return kern, ms["plain"], ms[f"SDPA ({how})"], bound_ms, bound_by

    power = gpu_name_and_power()
    flash_attention_build_report()
    if failed:
        raise AssertionError("flash_attention: " + "; ".join(failed))
    first = {kd: i for i, (_q, _k, _v, kd, _w) in reversed(list(
        enumerate(real)))}
    timed_in_turns(f"gemma3-1b layer {first['full']} of the {seq}-token "
                   f"prefill", *real[first["full"]])
    timed_in_turns(f"gemma3-1b layer {first['swa']} of the {seq}-token "
                   f"prefill", *real[first["swa"]])
    mix_seq = mixtral_attn[0][0].shape[1]
    ms, plain_ms, lib_ms, bound_ms, bound_by = timed_in_turns(
        f"mixtral-8x22b layer 0 of the {mix_seq}-token prefill",
        *mixtral_attn[0])
    if failed:
        raise AssertionError("flash_attention: " + "; ".join(failed))
    packing_sweep(device, cfg, mixtral_attn[0])
    for s in (513, 4096):
        args = random_attention(1, s, cfg.num_heads, cfg.num_kv_heads,
                                cfg.head_dim, torch.bfloat16, s, device)
        for kind, w in (("full", 0), ("swa", cfg.window)):
            timed(f"random S={s}", *args, kind, w)
    timed("random S=2048", *random_attention(
        1, 2048, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
        torch.float32, 2048, device), "full", 0)
    q, k, _v, kind, window = mixtral_attn[0]
    return dict(
        name="flash_attention",
        route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention_tc.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:74",
        launches=0,
        max_abs_err=worst[0],
        ms=ms,
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
        library_ms=lib_ms,
        shape=f"mixtral-8x22b layer 0 of a real {mix_seq}-token prefill: "
              f"q {list(q.shape)}, k/v {list(k.shape)}, bf16, {kind} "
              f"window {window}",
    )


def packing_sweep(device, cfg, mixtral_call) -> None:
    """B4's head packing against the prompt length: device ms at one and
    at two query heads a block, and the kernel's own choice, at gemma's
    global layout and mixtral's, random bf16 inputs, one turn each."""
    import torch

    from repro_torch.kernels.flash_attention import ops

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mq, mk = mixtral_call[:2]
    layouts = (("gemma3-1b global", cfg.num_heads, cfg.num_kv_heads,
                cfg.head_dim, "full", 0, (600, 1200, 3000)),
               ("mixtral-8x22b", mq.shape[2], mk.shape[2], mq.shape[3],
                "swa", mixtral_call[4], (300, 600, 1200)))
    for label, hq, hkv, d, kind, w, lengths in layouts:
        for s in lengths:
            q, k, v = random_attention(1, s, hq, hkv, d, torch.bfloat16, s,
                                       device)
            t = {n: graph_ms(lambda n=n: ops._flash_attention_tc(
                q, k, v, kind=kind, window=w, heads_per_block=n),
                repeats=10, samples=11) for n in (1, 2)}
            auto = graph_ms(lambda: ops.flash_attention_cuda(
                q, k, v, kind=kind, window=w), repeats=10, samples=11)
            paired = -(-s // ops.Q_TILE) * hq // 2
            print(f"flash_attention packing, {label} S={s}: one head a "
                  f"block {t[1]:.6f} ms, two {t[2]:.6f} ms ({paired} "
                  f"paired blocks on {sms} SMs), the kernel's choice "
                  f"{auto:.6f} ms")


def ptxas_entries(log: str) -> dict:
    """Per kernel (mangled name) in nvcc's -Xptxas -v output: its
    registers, static shared memory and (spill stores, spill loads)."""
    import re

    found = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            found[fn] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and fn:
            found[fn]["spills"] = tuple(map(int, m.groups()))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            found[fn]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            found[fn]["smem"] = int(m.group(1)) if m else 0
    return found


def flash_attention_build_report() -> None:
    """B4's build, per template instance: registers, spills (0 required
    for every tensor-core instance) and dynamic shared memory, from
    nvcc's -Xptxas -v; and the count of HGMMA (wgmma) instructions in the
    built library's SASS (cuobjdump), or of wgmma in its PTX where the
    toolkit has no cuobjdump (at least one required)."""
    import re
    import shutil

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    for name in ("flash_attention", "flash_attention_simt"):
        if name not in _build.BUILD_LOG:
            print(f"build: {name} was built before this run (cached in "
                  f"{_build.BUILD_DIR}): no ptxas report")
            continue
        found = ptxas_entries(_build.BUILD_LOG[name][1])
        for fn, got in sorted(found.items()):
            tc = re.search(r"flash_attention_tc_kernelILi(\d+)ELi(\d+)E", fn)
            simt = re.search(r"flash_attention_kernelI(\w+?)Li(\d+)E", fn)
            stores, loads = got.get("spills", (None, None))
            if tc:
                d, wg = int(tc.group(1)), int(tc.group(2))
                bk = 64 if d == 256 else 128
                what = (f"tensor-core d={d}, {wg} head(s) a block: "
                        f"{got.get('registers')} registers at entry"
                        + (" (setmaxnreg: consumers 240, producer 24)"
                           if wg == 2 else "")
                        + f", dynamic shared memory "
                        f"{wg * 64 * d * 2 + 4 * bk * d * 2 + 1088} B")
                if stores != 0 or loads != 0:
                    raise AssertionError(f"flash_attention: {what}; spill "
                                         f"stores {stores}, loads {loads}")
            elif simt:
                t = "f32" if simt.group(1) == "f" else "bf16"
                what = (f"CUDA-core {t} d={simt.group(2)}: "
                        f"{got.get('registers')} registers")
            else:
                what = fn
            print(f"build: {what}; spill stores {stores} B, spill loads "
                  f"{loads} B")
    lib = Path(ops._library()._name)  # the library this run loaded
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).parent / "cuobjdump")
    if Path(cuobjdump).exists():
        sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                              capture_output=True, text=True).stdout
        count, where = sass.count("HGMMA"), f"HGMMA in {lib.name}'s SASS"
    else:
        ptx = _build.BUILD_DIR / "flash_attention_tc.ptx"
        subprocess.run([_build._nvcc(), "-gencode",
                        "arch=compute_90a,code=compute_90a", "-std=c++17",
                        "-ptx", "-o", str(ptx), str(ops.SOURCES[0])],
                       check=True, capture_output=True)
        count, where = ptx.read_text().count("wgmma.mma_async"), \
            "wgmma.mma_async in its PTX (no cuobjdump)"
    print(f"build: {count} {where}")
    if count == 0:
        raise AssertionError("flash_attention: no wgmma in the built kernel")


def scan_tile_smem(D, rows, cols, block_cols, chunk) -> int:
    """Dynamic shared memory of one instance of B5 (``Tile`` in
    rwkv6_scan.cu): two chunk buffers of r, k, w and v, and the partial
    column sums padded by one row group's columns."""
    ps = D // rows * block_cols + block_cols
    return 4 * (2 * (3 * chunk * D + chunk * block_cols) + chunk * ps)


def rwkv6_scan_build_report() -> None:
    """B5's build, per instance of the kernel and of its earlier design:
    registers, shared memory and spills (0 required for every instance),
    from nvcc's -Xptxas -v."""
    import re

    from repro_torch.kernels import _build

    for name in ("rwkv6_scan", "rwkv6_scan_chain"):
        if name not in _build.BUILD_LOG:
            print(f"build: {name} was built before this run (cached in "
                  f"{_build.BUILD_DIR}): no ptxas report")
            continue
        found = ptxas_entries(_build.BUILD_LOG[name][1])
        if not found:
            raise AssertionError(f"build: no ptxas report for {name}")
        for fn, got in sorted(found.items()):
            tile = re.search(r"rwkv6_scan_tile_kernelILi(\d+)ELi(\d+)ELi"
                             r"(\d+)ELi(\d+)ELi(\d+)E", fn)
            chain = re.search(r"rwkv6_scan_chain_kernelILi(\d+)E", fn)
            if tile:
                d, rt, ct, c, t = map(int, tile.groups())
                what = (f"rwkv6_scan hd={d}, {rt} x {ct} tile, {c} columns "
                        f"a block, {t}-step chunk: {d // rt * c // ct} "
                        f"threads, dynamic shared memory "
                        f"{scan_tile_smem(d, rt, ct, c, t)} B")
            elif chain:
                what = f"rwkv6_scan_chain hd={chain.group(1)}: 64 threads"
            else:
                what = fn
            stores, loads = got.get("spills", (None, None))
            what += (f", {got.get('registers')} registers, static shared "
                     f"memory {got.get('smem')} B; spill stores {stores} B, "
                     f"spill loads {loads} B")
            print(f"build: {what}")
            if stores != 0 or loads != 0:
                raise AssertionError(f"B5 spills: {what}")


def capture_scans(cfg, params, device, prompts, max_new_tokens, keep):
    """The kernel's inputs (cloned) of the calls ``keep(r)`` picks, in
    call order, from a kernel-path serving run of ``prompts`` on one slot
    per prompt."""
    import torch

    from repro_torch.models import ssm
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    captured = []
    original = ssm.rwkv6_scan

    def capture(r, k, v, w, u, state0, *, state_out=None):
        if keep(r):
            captured.append(tuple(a.clone() for a in (r, k, v, w, u,
                                                       state0)))
        return original(r, k, v, w, u, state0, state_out=state_out)

    eng = ServingEngine(cfg, ServeConfig(batch_slots=len(prompts),
                                         cache_len=SERVE_CACHE_LEN),
                        params, device=device, kernel_impl="auto")
    ssm.rwkv6_scan = capture
    try:
        eng.run([Request(rid=i, prompt=p, max_new_tokens=max_new_tokens)
                 for i, p in enumerate(prompts)])
    finally:
        ssm.rwkv6_scan = original
    torch.cuda.synchronize()
    return captured


def scan_bound(r):
    """(bound ms, bound_by) of one scan: r, k, v, w read once, o written
    once, the state read and written once (all f32), against 5 flops per
    (step, i, j) (the output's and the update's multiply-adds and k v)
    and 3 per (step, i) (the bonus r u k) at the f32 peak."""
    B, H, S, D = r.shape
    n_bytes = 4 * (5 * B * H * S * D + 2 * B * H * D * D + H * D)
    n_ops = B * H * S * (5 * D * D + 3 * D)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def random_scan(B, H, S, D, seed, device, views=True):
    """r, k, v, w, u, state0 at tests/test_kernels.py's scales; r, k, v, w
    as the model hands them in ([B,H,S,hd] views of [B,S,H,hd] tensors)
    where ``views``."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def n(shape, scale):
        return torch.randn(shape, generator=g, device=device) * scale

    def seq(x):
        return x.transpose(1, 2) if views else x.transpose(1, 2).contiguous()

    r, k, v = (seq(n((B, S, H, D), 0.2)) for _ in range(3))
    w = seq(torch.sigmoid(n((B, S, H, D), 1.0)) * 0.5 + 0.4)
    return r, k, v, w, n((H, D), 0.1), n((B, H, D, D), 0.1)


def check_rwkv6_scan(device, model) -> dict:
    """Phase 2: rwkv6_scan and its earlier design against the plain
    version on the inputs of a real full-width prefill and decode step,
    and on random inputs; the two designs timed in turns at the prefill
    and the decode shape (the decode step also with the L2 cache cold),
    over prompt lengths, and the kernel's built tiles swept."""
    import numpy as np
    import torch

    from repro_torch.kernels.rwkv6_scan import ops
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

    rwkv6_scan_build_report()
    cfg, params = model
    designs = (("kernel", ops.rwkv6_scan_cuda),
               ("earlier design", ops._rwkv6_scan_chain))
    worst = {name: 0.0 for name, _ in designs}
    failed = []

    def check(label, args, real):
        """Largest |design - plain| over o and the state, and its ratio to
        the tolerance, per design; the state also written over a copy of
        state0."""
        want = rwkv6_scan_ref(*args)
        tops = [float(ref.abs().max()) for ref in want]
        out = {}
        for name, fn in designs:
            s_in = args[5].clone()
            got = fn(*args[:5], s_in, state_out=s_in)
            torch.cuda.synchronize()
            err = ratio = 0.0
            for g, ref, top in zip(got, want, tops):
                tol = max(RWKV_TOL, RWKV_REL_TOL * top) if real else RWKV_TOL
                e = float((g - ref).abs().max())
                if not (e <= tol and bool(torch.isfinite(g).all())):
                    failed.append(f"{name}, {label}: {e} > {tol}")
                err, ratio = max(err, e), max(ratio, e / tol)
            worst[name] = max(worst[name], err)
            out[name] = (err, ratio)
        return out, max(tops)

    def summary(res):
        return "; ".join(f"{name} max_abs_err {max(r[name][0] for r in res)}"
                         f", at most {max(r[name][1] for r in res)} of the "
                         f"tolerance" for name, _ in designs)

    prompt = np.random.default_rng(SEED + 1).integers(
        2, cfg.vocab_size, RWKV_CHECK_SEQ).astype(np.int32)
    prefill = capture_scans(cfg, params, device, [prompt], 1,
                            lambda r: r.shape[2] > 1)
    decode_prompts = [r.prompt for r in serve_requests(cfg)[:SERVE_SLOTS]]
    decode = capture_scans(cfg, params, device, decode_prompts, 2,
                           lambda r: r.shape[2] == 1)
    for name, calls in (("prefill", prefill), ("decode", decode)):
        if len(calls) != cfg.num_layers:
            raise AssertionError(f"a {name} made {len(calls)} scans, not "
                                 f"{cfg.num_layers}")
    for name, calls in (
            (f"a full-width {RWKV_CHECK_SEQ}-token prefill", prefill),
            (f"a full-width decode step at {SERVE_SLOTS} slots", decode)):
        res = [check(f"{name}, layer {i}", a, real=True)
               for i, a in enumerate(calls)]
        print(f"rwkv6_scan: the {len(res)} layers of {name} (r "
              f"{tuple(calls[0][0].shape)}, strides {calls[0][0].stride()}): "
              f"{summary([r for r, _ in res])}; largest |reference value| "
              f"{max(m for _, m in res)}")
    for D in ops.HEAD_DIMS:
        for B, H in ((1, 1), (2, 3), (8, 32)):
            for S in (1, 7, 63, 64, 65, 1000):
                r, _ = check(f"random B={B} H={H} S={S} hd={D}",
                             random_scan(B, H, S, D, S + D + B * H, device),
                             real=False)
                print(f"rwkv6_scan: random B={B} H={H} S={S} hd={D}: "
                      f"{summary([r])}")
    for S in (64, 128, 96):
        for D in (16, 64):
            r, _ = check(f"test_kernels S={S} hd={D}",
                         random_scan(2, 3, S, D, S + D, device, views=False),
                         real=False)
            print(f"rwkv6_scan: test_kernels shape B=2 H=3 S={S} hd={D}: "
                  f"{summary([r])}")
    if failed:
        raise AssertionError("rwkv6_scan disagrees with its plain version: "
                             + "; ".join(failed))

    def turns(label, calls, repeats, samples):
        """Device ms of each design per call of ``calls`` (argument tuples
        run in sequence in one graph), in turns: earlier, kernel, kernel,
        earlier; the mean of each design's two."""
        fns = dict(designs)
        ms = {name: [] for name in fns}
        for name in ("earlier design", "kernel", "kernel", "earlier design"):
            ms[name].append(graph_ms(
                lambda: [fns[name](*a) for a in calls],
                repeats=repeats, samples=samples) / len(calls))
        bound_ms, bound_by = scan_bound(calls[0][0])
        mean = {name: sum(v) / len(v) for name, v in ms.items()}
        print(f"rwkv6_scan device time in turns, {label} (r "
              f"{tuple(calls[0][0].shape)}): kernel {ms['kernel']} ms, "
              f"earlier design {ms['earlier design']} ms; means "
              f"{mean['kernel']:.6f} / {mean['earlier design']:.6f}: the "
              f"kernel {mean['earlier design'] / mean['kernel']:.3f}x as "
              f"fast, at {bound_ms / mean['kernel']:.4f} of its bound "
              f"{bound_ms:.6f} ms ({bound_by})")
        return mean, bound_ms, bound_by

    pre, bound_ms, bound_by = turns(
        f"layer 0 of the {RWKV_CHECK_SEQ}-token prefill", prefill[:1], 20, 5)
    turns(f"layer 0 of the decode step at {SERVE_SLOTS} slots, L2 warm",
          decode[:1], 100, 21)
    state_mb = decode[0][5].numel() * 4 / 1e6
    turns(f"the decode step's {len(decode)} layers in sequence, each "
          f"{state_mb:.1f} MB of state (L2 cold: {len(decode) * state_mb:.0f} "
          f"MB against its 50 MB)", decode, 10, 21)
    plain_ms = graph_ms(lambda: rwkv6_scan_ref(*prefill[0]), repeats=1,
                        samples=5)
    print(f"rwkv6_scan plain version, layer 0 of the prefill: {plain_ms:.6f} "
          f"ms; at the decode step: "
          f"{graph_ms(lambda: rwkv6_scan_ref(*decode[0])):.6f} ms")
    for S in (600, 1200, 1800, 3000):
        turns(f"the first {S} steps of prefill layer 0",
              [tuple(x[:, :, :S] for x in prefill[0][:4]) + prefill[0][4:]],
              20, 5)
    for label, args, chunks in (("prefill layer 0", prefill[0], (ops.CHUNK,)),
                                ("decode layer 0", decode[0],
                                 (ops.DECODE_CHUNK,))):
        sweep = [(tile, chunk) for tile in ops.SWEEP_TILES
                 for chunk in (ops.DECODE_CHUNK, ops.CHUNK)]
        sweep += [(ops.TILE, chunk) for chunk in ops.SWEEP_CHUNKS]
        times = {f"{t[0]}x{t[1]}/{t[2]} columns, {c}-step chunk":
                 graph_ms(lambda t=t, c=c: ops._rwkv6_scan_tile(
                     *args, tile=t, chunk=c), repeats=20 if c > 4 else 100,
                     samples=5 if args[0].shape[2] > 1 else 21)
                 for t, c in sweep}
        print(f"rwkv6_scan tile sweep, {label} (the default: "
              f"{'decode' if chunks == (ops.DECODE_CHUNK,) else 'prefill'}"
              f"), ms: " + ", ".join(f"{k} {v:.6f}"
                                     for k, v in sorted(times.items(),
                                                        key=lambda kv: kv[1])))
    print(f"rwkv6_scan eager (host-issued) at the decode step: kernel "
          f"wrapper {eager_ms(lambda: ops.rwkv6_scan_cuda(*decode[0])):.6f} "
          f"ms, plain {eager_ms(lambda: rwkv6_scan_ref(*decode[0])):.6f} ms")
    return dict(
        name="rwkv6_scan",
        route="cuda",
        source="src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu",
        replaces="src/repro/kernels/rwkv6_scan/kernel.py:54",
        launches=0,
        max_abs_err=worst["kernel"],
        ms=pre["kernel"],
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
        library_ms=None,
        earlier_design_ms=pre["earlier design"],
        shape=f"layer 0 of a real {RWKV_CHECK_SEQ}-token rwkv6-1.6b prefill: "
              f"r {list(prefill[0][0].shape)}, f32",
    )


def capture_calls(targets, run):
    """Run ``run()`` with each ``(module, attribute, keep)`` of
    ``targets`` wrapped: the calls for which ``keep(*args)`` holds are
    recorded, tensor arguments cloned. Returns one list of argument
    tuples per target, in call order."""
    import torch

    records = [[] for _ in targets]
    originals = [getattr(m, a) for m, a, _ in targets]

    def wrap(orig, rec, keep):
        def recorded(*args, **kw):
            if keep(*args):
                rec.append(tuple(a.clone() if isinstance(a, torch.Tensor)
                                 else a for a in args) + tuple(kw.values()))
            return orig(*args, **kw)
        return recorded

    for (m, a, keep), orig, rec in zip(targets, originals, records):
        setattr(m, a, wrap(orig, rec, keep))
    try:
        run()
    finally:
        for (m, a, _), orig in zip(targets, originals):
            setattr(m, a, orig)
    torch.cuda.synchronize()
    return records


def capture_mixtral(device, model) -> dict:
    """The kernel path's inputs at every layer of mixtral-8x22b: B4's
    (q, k, v, kind, window) and B3's plan's (router probabilities, top_k,
    capacity), of one MIXTRAL_CHECK_SEQ-token prefill and of one decode
    step at SERVE_SLOTS slots (after prefills of the serving phase's
    first 8 prompts)."""
    import numpy as np
    import torch

    from repro_torch.models import layers
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    cfg, params = model
    prompt = np.random.default_rng(SEED + 1).integers(
        2, cfg.vocab_size, MIXTRAL_CHECK_SEQ)

    def prefill():
        M.prefill(params, cfg, torch.as_tensor(prompt, device=device)[None],
                  kernel_impl="auto")

    def decode_step():
        eng = ServingEngine(cfg, ServeConfig(batch_slots=SERVE_SLOTS,
                                             cache_len=SERVE_CACHE_LEN),
                            params, device=device, kernel_impl="auto")
        eng.run([Request(rid=r.rid, prompt=r.prompt, max_new_tokens=2)
                 for r in serve_requests(cfg)[:SERVE_SLOTS]])

    def every(*_args):
        return True

    def at_decode(x, *_args):
        return x.shape[0] == SERVE_SLOTS

    attn, probs = capture_calls(
        [(layers, "flash_attention", every),
         (moe, "moe_dispatch_plan", every)], prefill)
    dec_probs, = capture_calls(
        [(moe, "moe_dispatch_plan", at_decode)], decode_step)
    out = dict(attn=attn, probs=probs, dec_probs=dec_probs)
    for name, calls in out.items():
        if len(calls) != cfg.num_layers:
            raise AssertionError(f"mixtral capture {name}: {len(calls)} "
                                 f"calls, not {cfg.num_layers}")
    print(f"mixtral-8x22b captures: a {MIXTRAL_CHECK_SEQ}-token prefill "
          f"(B3's plan over probabilities {tuple(probs[0][0].shape)}, top "
          f"{probs[0][1]}, capacity {probs[0][2]}; B4 q "
          f"{tuple(attn[0][0].shape)}) and a decode step at {SERVE_SLOTS} "
          f"slots (probabilities {tuple(dec_probs[0][0].shape)}, capacity "
          f"{dec_probs[0][2]}), {cfg.num_layers} layers each")
    return out


def random_expert_ids(n, num_experts, seed, device, runs=False):
    """int32[n]: sorted random expert ids with a tail of n // 8 -1
    entries; with ``runs``, unsorted runs of ids in -1 .. 2 instead
    (positions count runs, so any input has one answer)."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    if runs:
        vals = torch.randint(-1, 3, (n,), generator=g, device=device)
        lens = torch.randint(1, 400, (n,), generator=g, device=device)
        return torch.repeat_interleave(vals, lens)[:n].to(torch.int32)
    m = n - n // 8
    ids = torch.randint(0, num_experts, (m,), generator=g, device=device)
    return torch.cat([torch.sort(ids).values,
                      torch.full((n - m,), -1, device=device)]).to(
                          torch.int32)


def random_router_probs(n, num_experts, seed, device, ties=False):
    """f32[n, num_experts]: a softmax of normal logits (twice the scale
    of a unit normal, so some experts are favoured); with ``ties``, a
    third of the rows all equal and the rest drawn from four levels, so
    ties fall at the top, at the k-th place and below."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    if ties:
        z = torch.randint(1, 5, (n, num_experts), generator=g,
                          device=device).float()
        z[::3] = 1.0
        return z / z.sum(-1, keepdim=True)
    z = torch.randn(n, num_experts, generator=g, device=device) * 2.0
    return torch.softmax(z, -1)


def sorted_expert_ids(probs, top_k):
    """The sorted form's input for one plan: the (token, choice) entries'
    experts by the plain route, stably sorted."""
    import torch

    from repro_torch.models import moe

    _w, eidx = moe.route(probs, top_k)
    return torch.sort(eidx.reshape(-1).to(torch.int32), stable=True).values


def cuda_kernels_per_call(fn, calls: int = 100) -> tuple:
    """(CUDA kernels, and memory copies and sets, per call of ``fn``;
    the kernels' names) under torch.profiler, over ``calls`` calls after
    a warm-up call. The profiler may miss a few of the first launches of
    its window: the counts are means, not exact. A window in which it
    recorded no device activity at all (it once lost a whole window of
    100 launches on an H100) is measured again, up to twice: ``fn``
    launches work every call, so an empty window is the profiler's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        if kern:
            break
        print(f"cuda_kernels_per_call: the profiler recorded no device "
              f"activity over {calls} calls (attempt {attempt + 1}); "
              f"measuring again")
    copies = [e for e in kern if e.key.startswith(("Memcpy", "Memset"))]
    kern = [e for e in kern if e not in copies]
    return (sum(e.count for e in kern) / calls,
            sum(e.count for e in copies) / calls,
            sorted({e.key[:50] for e in kern}))


def plan_bound(n, num_experts, top_k, capacity, groups=1):
    """The plan's least time (ms, and what bounds it): the probabilities
    read once (4 B each), the table written once (8 B a slot) and the
    load (4 B an expert); per probability a compare and an insert step,
    per entry a rank and a slot (about 2 E + 4 k operations a token).
    ``groups`` plans of ``n`` tokens each also write their counts (4 B
    an expert)."""
    n_bytes = groups * (n * num_experts * 4 + num_experts * capacity * 8
                        + num_experts * 4 * (2 if groups > 1 else 1))
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (groups * n * (2 * num_experts + 4 * top_k) / FP32_OPS_PER_S
              * 1e3)
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms
            else "operations", n_bytes)


def largest_difference(pairs) -> float:
    """The largest |got - want| over (got, want) tensor pairs (0: all
    bit-equal; a NaN difference counts as inf, and a pair that differs
    with no difference to show, as -0.0 against 0.0, as 1.0)."""
    import torch

    e = 0.0
    for got, want in pairs:
        if not torch.equal(got, want):
            e = max(e, float((got.double() - want.double()).abs()
                             .nan_to_num(float("inf")).max()) or 1.0)
    return e


def hold_plan(label, probs, top_k, capacity) -> float:
    """B3's fused plan against the plain plan: the largest difference
    (0: bit-equal)."""
    import torch

    from repro_torch.kernels.moe_dispatch import ops
    from repro_torch.models import moe

    got = ops.moe_dispatch_plan_cuda(probs, top_k=top_k, capacity=capacity)
    want = moe.plan_dispatch(probs, top_k, capacity)
    torch.cuda.synchronize()
    e = largest_difference((got[f], want[f]) for f in want)
    if e:
        print(f"BAD moe_dispatch_plan {label}: differs by {e}")
    return e


def hold_grouped(label, probs, groups, top_k, capacity) -> float:
    """B3's grouped launch over ``probs`` [N, E] cut into ``groups`` shards
    of N / groups tokens, against its plain version (each group's plain
    plan): the largest difference over the slot table, the weights, the
    loads and the counts (0: bit-equal). One group is also held to the
    one-plan launch. Prints a line where it differs."""
    import torch

    from repro_torch.kernels.moe_dispatch import ops
    from repro_torch.kernels.moe_dispatch.ref import (
        moe_dispatch_plan_grouped_ref,
    )

    pg = probs.view(groups, -1, probs.shape[-1])
    before = ops.launches
    got = ops.moe_dispatch_plan_cuda(pg, top_k=top_k, capacity=capacity)
    torch.cuda.synchronize()
    if ops.launches != before + 1:
        raise AssertionError("a grouped plan is not one launch")
    want = moe_dispatch_plan_grouped_ref(pg, top_k, capacity)
    pairs = [(got[f], want[f]) for f in want]
    if groups == 1:
        one = ops.moe_dispatch_plan_cuda(probs, top_k=top_k,
                                         capacity=capacity)
        pairs += [(got[f][0], one[f]) for f in one]
    e = largest_difference(pairs)
    if e:
        print(f"BAD moe_dispatch_plan grouped, {label}, G={groups}: differs "
              f"by {e}")
    return e


def check_moe_dispatch(device, caps) -> dict:
    """Phase 2: B3's fused plan bit-equal to the plain plan at every layer
    of a real full-width mixtral prefill and decode step and on random
    router probabilities (N = 1 .. 65,536, E 4, 8 and 128, top 1 and 2,
    rows with ties, capacities that drop and that do not); its grouped
    form (G plans in one launch) bit-equal to each group's plain plan on
    those prefill layers in GROUP_COUNTS shards and on random groups; the
    sorted
    form bit-equal to its plain version on those layers' sorted expert
    ids and on random ids; in turns, the fused launch against the chain
    around the sorted form and the plain plan (graph replay and
    host-issued), and the sorted form against its plain version; CUDA
    kernels per plan on each route."""
    import torch

    from repro_torch.kernels.moe_dispatch import ops
    from repro_torch.kernels.moe_dispatch.ref import dispatch_slots_ref
    from repro_torch.models import moe

    err = 0

    def hold_sorted(ids, capacity, num_experts):
        got = ops.dispatch_positions_cuda(ids, capacity, num_experts)
        torch.cuda.synchronize()
        return max_abs_err(got, dispatch_slots_ref(ids, capacity,
                                                   num_experts))

    for name, key in (
            (f"a full-width {MIXTRAL_CHECK_SEQ}-token prefill", "probs"),
            (f"a full-width decode step at {SERVE_SLOTS} slots",
             "dec_probs")):
        calls = caps[key]
        e = max(hold_plan(f"{name}, layer {i}", *c)
                for i, c in enumerate(calls))
        kept = [int((ops.moe_dispatch_plan_cuda(
            p, top_k=k, capacity=c)["slot_token"] >= 0).sum())
            for p, k, c in calls]
        print(f"moe_dispatch_plan: the {len(calls)} layers of {name} "
              f"(probabilities {tuple(calls[0][0].shape)}, top {calls[0][1]}, "
              f"capacity {calls[0][2]}): slot_token, slot_weight and load "
              f"bit-equal to plan_dispatch's (max_abs_err {e}); kept per "
              f"layer {kept}")
        err = max(err, e)
        e = max(hold_sorted(sorted_expert_ids(p, k), c, p.shape[1])
                for p, k, c in calls)
        print(f"moe_dispatch sorted form: the {len(calls)} layers of {name} "
              f"({calls[0][0].shape[0] * calls[0][1]} sorted entries): pos, "
              f"keep and slot bit-equal (max_abs_err {e})")
        err = max(err, e)
    n_plans = 0
    for n in (1, 7, 16, 1000, 1023, 1024, 1025, 3000, 6000, 65536):
        for num_experts in (4, 8, 128):
            for top_k in (1, 2):
                for ties in (False, True):
                    probs = random_router_probs(
                        n, num_experts, n + 7 * num_experts + top_k, device,
                        ties)
                    # half the mean load (drops), or every entry (none)
                    for capacity in (n * top_k // (2 * num_experts), n):
                        err = max(err, hold_plan(
                            f"random N={n} E={num_experts} top {top_k} "
                            f"ties {ties} capacity {capacity}", probs, top_k,
                            capacity))
                        n_plans += 1
    print(f"moe_dispatch_plan: {n_plans} random plans (N = 1 .. 65,536; E "
          f"4, 8, 128; top 1, 2; rows with and without ties; capacities "
          f"that drop and that do not): bit-equal to plan_dispatch's "
          f"(max_abs_err {err})")
    # the grouped form: mixtral's prefill layers cut in G shards at the
    # shards' capacity, and random groups with ties
    e = 0.0
    for i, (p, k, _c) in enumerate(caps["probs"]):
        for G in GROUP_COUNTS:
            cap = moe.capacity_for(p.shape[0] // G, k, p.shape[1], 1.25,
                                   floor=32)
            e = max(e, hold_grouped(f"mixtral layer {i}", p, G, k, cap))
    for G in (1, 3, 8):
        for n, num_experts, top_k in ((2, 128, 1), (375, 128, 1),
                                      (1500, 8, 2), (9000, 8, 2)):
            probs = random_router_probs(G * n, num_experts, G + n, device,
                                        ties=True)
            for capacity in (32, 128, n):
                e = max(e, hold_grouped(f"random n={n} E={num_experts} "
                                        f"top {top_k} capacity {capacity}",
                                        probs, G, top_k, capacity))
    print(f"moe_dispatch_plan grouped form: the {len(caps['probs'])} layers "
          f"of the mixtral prefill in G = {GROUP_COUNTS} shards, and random "
          f"groups with ties (G = 1, 3, 8; n = 2 .. 9,000; E 8, 128): "
          f"slot table, weights, loads and counts bit-equal to each group's "
          f"plain plan, G = 1 to the one-plan launch (max_abs_err {e})")
    err = max(err, e)
    for n in (1, 16, 1000, 1023, 1024, 1025, 3000, 6000, 65536, 1 << 20):
        for num_experts in (8, 4096):
            ids = random_expert_ids(n, num_experts, n + num_experts, device)
            m = n - n // 8
            # half the mean run (drops), or every entry as far as the
            # slots stay in int32 (no drops)
            for capacity in (m // (2 * num_experts),
                             min(m, (2**31 - 1) // num_experts)):
                e = hold_sorted(ids, capacity, num_experts)
                print(f"moe_dispatch sorted form: random N={n} "
                      f"E={num_experts} capacity {capacity}: bit-equal "
                      f"(max_abs_err {e})")
                err = max(err, e)
        if n >= 1000:
            e = hold_sorted(random_expert_ids(n, 3, n, device, runs=True),
                            150, 3)
            print(f"moe_dispatch sorted form: random unsorted runs N={n}: "
                  f"bit-equal (max_abs_err {e})")
            err = max(err, e)
    if err:
        raise AssertionError(f"moe_dispatch disagrees with its plain version "
                             f"(max_abs_err {err})")

    rows = {}
    for name, key in (
            (f"layer 0 of the {MIXTRAL_CHECK_SEQ}-token prefill", "probs"),
            (f"layer 0 of the decode step at {SERVE_SLOTS} slots",
             "dec_probs")):
        probs, top_k, capacity = caps[key][0]
        E = probs.shape[1]
        ids = sorted_expert_ids(probs, top_k)
        fns = {
            "fused launch": lambda: ops.moe_dispatch_plan_cuda(
                probs, top_k=top_k, capacity=capacity),
            "chain (sorted form)": lambda: ops.moe_dispatch_chain(
                probs, top_k=top_k, capacity=capacity),
            "plain plan": lambda: moe.plan_dispatch(probs, top_k, capacity),
        }
        dev_res = in_turns(fns, graph_ms)
        print_turns(f"moe_dispatch plan, device time (graph replay), {name}",
                    dev_res)
        host_res = in_turns(fns, eager_ms)
        print_turns(f"moe_dispatch plan, host-issued (eager), {name}",
                    host_res)
        per_plan = {label: cuda_kernels_per_call(fn)
                    for label, fn in fns.items()}
        print(f"moe_dispatch plan, CUDA kernels per plan (and memory copies "
              f"and sets), {name}: " + "; ".join(
                  f"{label} {n:.2f} ({c:.2f}; {', '.join(names)})"
                  for label, (n, c, names) in per_plan.items()))
        n, c, names = per_plan["fused launch"]
        if round(n) != 1 or c or len(names) != 1:
            raise AssertionError(f"the fused plan ran "
                                 f"{per_plan['fused launch']}")
        sorted_res = in_turns({
            "sorted form": lambda: ops.dispatch_positions_cuda(ids, capacity,
                                                               E),
            "its plain version": lambda: dispatch_slots_ref(ids, capacity, E),
        }, graph_ms)
        print_turns(f"moe_dispatch sorted form ({ids.shape[0]} entries), "
                    f"{name}", sorted_res)
        bound_ms, bound_by, n_bytes = plan_bound(probs.shape[0], E, top_k,
                                               capacity)
        ms = dev_res["fused launch"][1]
        print(f"moe_dispatch fused plan, {name} (N {probs.shape[0]}, E {E}, "
              f"top {top_k}, capacity {capacity}): {ms:.6f} ms, bound "
              f"{bound_ms:.9f} ms ({bound_by}, {n_bytes} B), at "
              f"{bound_ms / ms:.6f} of its bound; chain "
              f"{dev_res['chain (sorted form)'][1]:.6f} ms, plain plan "
              f"{dev_res['plain plan'][1]:.6f} ms")
        rows[key] = (ms, dev_res["plain plan"][1], bound_ms, bound_by)
    ms, plain_ms, bound_ms, bound_by = rows["probs"]
    return dict(
        name="moe_dispatch",
        route="cuda",
        source="src/repro_torch/kernels/moe_dispatch/csrc/moe_dispatch.cu",
        replaces="src/repro/kernels/moe_dispatch/kernel.py:51",
        launches=0,
        max_abs_err=err,
        ms=ms,
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
        library_ms=None,
    )


def replay_goldens(device) -> None:
    """Phase 3: the golden fixtures, bit-exactly, on ``device``."""
    from repro_torch.core.engine import EngineConfig, run_simulation
    from repro_torch.core.workloads import WorkloadConfig, make_workload

    for name in GOLDEN_CELLS:
        g = json.loads((GOLDEN / f"{name}.json").read_text())
        cfg = EngineConfig(**g["engine"], **g["sim"])
        t0 = time.time()
        res = run_simulation(cfg, make_workload(WorkloadConfig(**g["workload"])),
                             device=device)
        got = fingerprint(res, include_metrics=name in GOLDEN_METRICS_CELLS)
        if got != g["trace"]:
            diff = {k: (got[k], g["trace"].get(k)) for k in got
                    if got[k] != g["trace"].get(k)}
            raise AssertionError(f"golden {name} diverged: {diff}")
        print(f"golden {name}: bit-exact ({time.time() - t0:.3f} s)")


def run_cell(name, eng_kw, workload, device, sim=SIM_FULL,
             deadlock_aborts=False, **extra):
    """One run through ``run_simulation``: finite results, commits, and
    deadlock aborts where ``deadlock_aborts`` (None: unchecked), none
    otherwise."""
    from repro_torch.core.engine import EngineConfig, run_simulation

    cfg = EngineConfig(**eng_kw, **sim, **extra)
    t0 = time.time()
    res = run_simulation(cfg, workload, device=device)
    wall = time.time() - t0
    steps = res.raw["steps_executed"]
    rounds = res.raw["rounds_total"]
    for v in (res.throughput_txn_s, *res.breakdown.values()):
        if v != v or abs(v) == float("inf"):
            raise AssertionError(f"{name}: non-finite result {v}")
    if res.commits <= 0 or (deadlock_aborts is not None and (
            res.aborts_deadlock > 0) != deadlock_aborts):
        raise AssertionError(f"{name}: {res.commits} commits, "
                             f"{res.aborts_deadlock} deadlock aborts")
    print(f"{name}: commits {res.commits}, simulated throughput_txn_s "
          f"{res.throughput_txn_s}, steps_executed {steps}, rounds "
          f"{rounds}, wall {wall:.3f} s, rounds/wall-s {rounds / wall:.1f}, "
          f"steps/wall-s {steps / wall:.1f}")
    return res


def make_full_workload(wl_kw):
    from repro_torch.core.workloads import WorkloadConfig, make_workload

    t0 = time.time()
    wl = make_workload(WorkloadConfig(**wl_kw))
    print(f"workload: YCSB {wl_kw} made in {time.time() - t0:.3f} s")
    return wl


def main_path_slice7(device) -> None:
    """Phase 9: the dynamic-2PL baselines and the partitioned store at
    the paper's width through ``run_simulation``, with the in-tree
    oracles; plain PyTorch, so no kernel may launch."""
    workloads = {name: make_full_workload(wl_kw)
                 for name, _eng_kw, wl_kw in SLICE7_CELLS}
    cells = {name: eng_kw for name, eng_kw, _wl_kw in SLICE7_CELLS}
    reset_launches()
    results = {}
    for name, eng_kw in cells.items():
        res = run_cell(name, eng_kw, workloads[name], device, sim=SIM_CUT,
                       deadlock_aborts=name in DL_PROTOCOLS)
        full = json.dumps(fingerprint(res, True), sort_keys=True)
        print(f"{name}: fingerprint {json.dumps(fingerprint(res))}, with "
              f"the metrics sha256 "
              f"{hashlib.sha256(full.encode()).hexdigest()[:16]}")
        results[name] = res
    wl = workloads["twopl_waitfor"]
    waitfor = cells["twopl_waitfor"]
    csr = fingerprint(results["twopl_waitfor"], True)
    dense = run_cell("twopl_waitfor release_path=dense", waitfor, wl,
                     device, sim=SIM_CUT, deadlock_aborts=True,
                     release_path="dense")
    if fingerprint(dense, True) != csr:
        raise AssertionError("twopl_waitfor: the csr and dense paths "
                             "diverged")
    print("twopl_waitfor: csr and dense fingerprints identical (metrics "
          "incl.)")
    no_leap = fingerprint(run_cell(
        "twopl_waitfor event_leap=False", waitfor, wl, device, sim=SIM_CUT,
        deadlock_aborts=True, event_leap=False), True)
    leap_steps = csr.pop("steps_executed")
    dense_steps = no_leap.pop("steps_executed")
    if no_leap != csr or dense_steps != no_leap["rounds_total"] \
            or leap_steps > dense_steps:
        raise AssertionError("twopl_waitfor: the leaping and dense runs "
                             "diverged")
    print(f"twopl_waitfor: leaping and dense fingerprints identical "
          f"(metrics incl.; steps {leap_steps} / {dense_steps})")
    counts = {name: ops.launches for name, ops in kernel_ops().items()}
    if any(counts.values()):
        raise AssertionError(f"the slice-7 path launched a kernel: {counts}")
    print(f"slice 7 path: kernel launches {counts} (none on this path)")
    profile_steps("slice 7", {
        "twopl_waitdie": cells["twopl_waitdie"],
        "twopl_dreadlocks": cells["twopl_dreadlocks"],
        "deadlock_free": DF_FULL}, wl, device, warm=50, timed=50)


def report_open(name, res) -> None:
    """One open-arrival run's fingerprint, metrics digest and goodput
    split."""
    full = json.dumps(fingerprint(res, True), sort_keys=True)
    m = res.metrics
    print(f"{name}: fingerprint {json.dumps(fingerprint(res))}, with the "
          f"metrics sha256 {hashlib.sha256(full.encode()).hexdigest()[:16]}"
          f"; offered {m.offered}, admitted {m.admitted}, committed "
          f"{m.committed}, rejected {m.rejected}, shed {m.shed}, timedout "
          f"{m.timedout}, sacrificed {m.sacrificed}, p50/p99 rounds "
          f"{m.p50}/{m.p99}, q_depth max {int(max(m.q_depth))}")


def backlog_samples(res, eng_kw, sim=SIM_FULL) -> list:
    """The run's queue-depth samples at the grid points it reached (the
    grid covers (0, max_rounds]; points past the last round stay 0)."""
    from repro_torch.core.engine import EngineConfig, qgrid_interval

    iv = qgrid_interval(EngineConfig(**eng_kw, **sim))
    n = res.raw["rounds_total"] // iv
    return [int(x) for x in res.metrics.q_depth[:n]]


def both_paths(name, eng_kw, workload, device, ops, sim=SIM_FULL):
    """One cell on the kernel path and the plain path: identical
    fingerprints and ``raw`` counters (metrics included), ``ops``'s
    launches = steps on the kernel path (one a replay of its K = 1
    graph) and none on the plain one.
    Returns the kernel path's result and its launches."""
    runs, launches = {}, 0
    for impl in ("auto", "jnp"):
        before = ops.launches
        res = run_cell(f"{name} kernel_impl={impl}", eng_kw, workload,
                       device, sim=sim, kernel_impl=impl)
        n = ops.launches - before
        steps = res.raw["steps_executed"]
        extra = {k: res.raw[k] for k in ("pipe_adm", "pipe_commits")
                 if k in res.raw}
        print(f"{name} kernel_impl={impl}: {ops.__name__.split('.')[-2]} "
              f"launches {n}, steps_executed {steps} {extra}")
        if n != (steps if impl == "auto" else 0) or steps <= 0:
            raise AssertionError(f"{name} kernel_impl={impl}: {n} launches "
                                 f"in {steps} steps")
        launches += n
        runs[impl] = res
    skip = {"wall_s_group"}
    raw = [{k: v for k, v in runs[i].raw.items() if k not in skip}
           for i in ("auto", "jnp")]
    if fingerprint(runs["auto"], True) != fingerprint(runs["jnp"], True) \
            or raw[0] != raw[1] \
            or runs["auto"].metrics.summary_row() != (
                runs["jnp"].metrics.summary_row()):
        raise AssertionError(f"kernel and plain {name} runs diverged")
    print(f"{name}: kernel and plain fingerprints identical (metrics and "
          f"counters incl.)")
    return runs["auto"], launches


def main_path_slice7_open(device) -> dict:
    """Phase 10: open epoch arrival and the overload layer at the
    figures' width through ``run_simulation``, B2 and B1 on its path.
    Returns the lock_grant and dep_wavefront launches of the path."""
    from repro_torch.core import engine
    from repro_torch.core.workloads import WorkloadConfig, make_workload
    from repro_torch.kernels.dep_wavefront import ops as dw_ops
    from repro_torch.kernels.lock_grant import ops as lg_ops

    wl16 = make_full_workload(YCSB_FIG16)
    batch_wl = {"fig16_h16_i200_dgcc_planned": wl16,
                "fig15_h16_i200_L1_quecc_frag": make_full_workload(
                    YCSB_FIG15)}
    wl64 = make_full_workload(YCSB_FULL)
    golden = json.loads((GOLDEN / "orthrus.json").read_text())
    wl_small = make_workload(WorkloadConfig(**golden["workload"]))
    reset_launches()
    batch = {}
    for name, eng_kw, _wl_kw in OA_BATCH_CELLS:
        res, _n = both_paths(name, eng_kw, batch_wl[name], device, dw_ops)
        report_open(name, res)
        q = backlog_samples(res, eng_kw)
        print(f"{name}: plan_qdelay {res.raw['plan_qdelay']}, plan_busy "
              f"{res.raw['plan_busy']}, epoch_ctr {res.raw['epoch_ctr']}, "
              f"backlog mid-run {q[len(q) // 2]}, last {q[-1]}")
        batch[name] = (res, q)
    # fig15's one planner lane takes about 1,570 rounds a 256-txn plan
    # against an epoch every 200 rounds: the planner saturates. fig16's
    # two lanes take 184 rounds a 64-txn plan against an epoch every 200
    # (cost_model.planner_lane_schedule gives no queueing at all), so
    # its exec lanes bind instead: past the knee the backlog grows
    if batch["fig15_h16_i200_L1_quecc_frag"][0].raw["plan_qdelay"] <= 0:
        raise AssertionError("fig15_h16_i200_L1_quecc_frag: the planner "
                             "did not saturate")
    q16 = batch["fig16_h16_i200_dgcc_planned"][1]
    if not q16[-1] > q16[len(q16) // 2] > 0:
        raise AssertionError("fig16_h16_i200_dgcc_planned: the backlog "
                             "did not grow past the knee")

    shed = run_cell("fig17_i200_deadline_shed", FIG17_SHED, wl16, device,
                    sim=SIM_CUT)
    report_open("fig17_i200_deadline_shed", shed)
    if shed.raw["pol_shed"] <= 0:
        raise AssertionError("fig17_i200_deadline_shed shed nothing")
    dense = run_cell("fig17_i200_deadline_shed event_leap=False",
                     FIG17_SHED, wl16, device, sim=SIM_CUT,
                     event_leap=False)
    leap_fp, dense_fp = fingerprint(shed, True), fingerprint(dense, True)
    leap_steps = leap_fp.pop("steps_executed")
    dense_steps = dense_fp.pop("steps_executed")
    if dense_fp != leap_fp or dense_steps != dense_fp["rounds_total"] \
            or dense.metrics.summary_row() != shed.metrics.summary_row():
        raise AssertionError("fig17_i200_deadline_shed: the leaping and "
                             "dense runs diverged")
    print(f"fig17_i200_deadline_shed: leaping and dense fingerprints "
          f"identical (metrics incl.; steps {leap_steps} / {dense_steps})")
    bb = run_cell("fig17_i200_bounded_backlog", FIG17_BB, wl16, device,
                  sim=SIM_CUT)
    report_open("fig17_i200_bounded_backlog", bb)
    # after the last executed round the backlog (the host oracle's
    # arrivals less the consumed txns) is within the cap; a queue sample
    # may exceed it by one epoch, which lands on its grid point before
    # that round's drop stage runs (tests/test_overload.py's bound)
    cap = FIG17_BB["backlog_cap"]
    cfg_bb = engine.EngineConfig(**FIG17_BB, **SIM_CUT)
    backlog = engine.offered_by_round(
        cfg_bb, engine.make_plan(cfg_bb, wl16),
        bb.raw["rounds_total"] - 1) - bb.raw["next_txn"]
    q_max = int(max(bb.metrics.q_depth))
    print(f"fig17_i200_bounded_backlog: backlog after the last round "
          f"{backlog} (cap {cap}), largest queue sample {q_max}")
    if bb.raw["pol_rejected"] <= 0 or not 0 <= backlog <= cap \
            or q_max > cap + YCSB_FIG16["batch_epoch"]:
        raise AssertionError("fig17_i200_bounded_backlog: no rejection, or "
                             "a backlog past the cap")
    burst = run_cell("fig17_burst_i800_deadline_shed", FIG17_BURST, wl16,
                     device, sim=SIM_BURST)
    report_open("fig17_burst_i800_deadline_shed", burst)
    backoff = run_cell("fig17_backoff_h64_exp", FIG17_BACKOFF, wl64, device,
                       sim=SIM_CUT, deadlock_aborts=True)
    report_open("fig17_backoff_h64_exp", backoff)
    print(f"fig17_backoff_h64_exp: deadlock aborts "
          f"{backoff.aborts_deadlock}, pol_backoff_rounds "
          f"{backoff.raw['pol_backoff_rounds']}")
    if backoff.raw["pol_backoff_rounds"] <= 0:
        raise AssertionError("fig17_backoff_h64_exp issued no backoff")

    orthrus = dict(golden["engine"], **ORTHRUS_OA)
    res, _n = both_paths("orthrus golden size, open arrival", orthrus,
                         wl_small, device, lg_ops, sim=golden["sim"])
    report_open("orthrus golden size, open arrival", res)
    counts = {name: ops.launches for name, ops in kernel_ops().items()}
    print(f"slice 7 open-arrival path: kernel launches {counts}")
    if any(v for k, v in counts.items()
           if k not in ("lock_grant", "dep_wavefront")):
        raise AssertionError("a kernel off this path launched")
    profile_steps("fig17", {
        "fig17_i200_deadline_shed": FIG17_SHED,
        "deadlock_free closed loop": FIG17_DF}, wl16, device, warm=50,
        timed=50)
    dgcc = OA_BATCH_CELLS[0][1]
    profile_steps("fig16_h16_i200_dgcc_planned", {
        "kernel path": dgcc, "plain path": dict(dgcc, kernel_impl="jnp")},
        wl16, device, warm=100, timed=50, watch="dep_wavefront")
    return counts


def graph_of(runner, state=None):
    """The captured dispatch (``ChunkRunner.graphs``) of a runner whose
    state buffers are ``state`` (the one it has, where ``None``)."""
    gs = [g for g in runner.graphs.values()
          if state is None or g.state is state]
    if len(gs) != 1:
        raise AssertionError(f"{len(gs)} graphs match")
    return gs[0]


def k_run(mode, k, eng_kw, plan, sim, kernel, device):
    """One whole run of a cell's ``plan``: ``mode`` "eager"
    (``simulate_eager``, one read of ``r`` a step) or "graph"
    (``simulate_plans``: its cached runner, a replay per dispatch of K =
    ``k`` rounds). Holds the kernel counts to the dispatches: the eager
    run launches ``kernel`` once a step, a graph once per replay per
    inner step (K x replays, of which ``steps_executed`` are active),
    and no other kernel launches."""
    from repro_torch.core import engine, sweep

    cfg = engine.EngineConfig(**eng_kw, **sim, rounds_per_dispatch=k)
    meta = engine.plan_meta(cfg, plan)
    ops = kernel_ops()
    before = {n: m.launches for n, m in ops.items()}
    misses = sweep.runner_cache_info()["misses"]
    runner = None if mode == "eager" else sweep.get_runner(cfg, meta, device)
    hit = int(runner is not None
              and sweep.runner_cache_info()["misses"] == misses)
    replays0 = runner.replays if runner else 0
    t0 = time.perf_counter()
    if runner is None:
        res = sweep.simulate_eager(cfg, plan, device=device)
    else:
        res = sweep.simulate_plans(cfg, [plan], device=device)[0]
    wall = time.perf_counter() - t0
    steps = res.raw["steps_executed"]
    kk = 1 if runner is None else cfg.dispatch_rounds
    replays = steps if runner is None else runner.replays - replays0
    launched = {n: m.launches - before[n] for n, m in ops.items()}
    n = launched.pop(kernel) if kernel else 0
    if any(launched.values()) or (kernel and n != kk * replays) \
            or kk * replays < steps:
        raise AssertionError(f"{mode} K={k}: {replays} dispatches of "
                             f"{kk} for {steps} steps, {kernel} launches "
                             f"{n}, others {launched}")
    return dict(res=res, wall=wall, steps=steps, replays=replays, K=kk,
                launches=n, runner=runner, cfg=cfg, meta=meta, hit=hit)


def k_windows(name, runs: dict, device, steps: int = 32,
              profiled: int = 8) -> None:
    """Per-step readings of the eager dispatch and of each graph of one
    cell, from the end of its runs onwards with the chunk bound far ahead
    (every inner step active): wall ms a step in turns (each path's state
    carried on, one read of ``r`` per dispatch); each graph's span, CUDA
    events around back-to-back replays; then under torch.profiler the
    CUDA kernels a step (in a replay CUPTI reports each kernel node of
    the graph as its own kernel), device ms a step and the busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    one = graph_of(runs["graph K=1"]["runner"])
    far = int(one.state["r"]) + 10**6
    eager = dict(d=runs["graph K=1"]["runner"].dispatch, p=one.p,
                 s={k: v.clone() for k, v in one.state.items()},
                 r_end=torch.tensor(far, dtype=torch.int32, device=device))
    graphs = {}
    for label, run in runs.items():
        if label.startswith("graph") and label != "graph K=5":
            g = graphs[label] = graph_of(run["runner"])
            g.r_end.fill_(far)
    ks = {label: runs[label]["K"] for label in ["eager K=1", *graphs]}

    def do(label, n_steps):
        if label in graphs:
            g = graphs[label]
            for _ in range(n_steps // ks[label]):
                g.replay()
                int(g.state["r"])
        else:
            for _ in range(n_steps):
                eager["s"] = eager["d"](eager["p"], eager["s"],
                                        eager["r_end"])
                int(eager["s"]["r"])

    def wall(label):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        do(label, steps)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    def span(label):
        """Device ms a step from CUDA events around back-to-back
        replays (no host read between them): the graph's own span,
        gaps between its nodes included."""
        g, k = graphs[label], ks[label]
        n = max(steps // k, 1)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            g.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / (n * k)

    for label in ks:
        do(label, max(ks[label], 8))
    walls = in_turns({label: label for label in ks}, wall)
    spans = {label: span(label) for label in graphs}
    for label, k in ks.items():
        n = max(profiled, k)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            do(label, n)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        n_kernels = sum(e.count for e in kern) / n
        dev_ms = sum(e.self_device_time_total for e in kern) / n / 1e3
        if n_kernels <= 0:
            raise AssertionError(f"{name} {label}: the profiler saw no CUDA "
                                 f"kernel")
        readings, wall_ms = walls[label]
        what, spanned = "CUDA kernels", ""
        if label in spans:
            what = "CUDA kernels (the graph's kernel nodes)"
            spanned = (f", graph span {spans[label]:.4f} ms (busy "
                       f"{dev_ms / spans[label]:.4f} of it)")
        print(f"k-fused {name} {label} per step: wall {wall_ms:.4f} ms "
              f"(turns {' / '.join(f'{w:.4f}' for w in readings)}), "
              f"{n_kernels:.1f} {what}, device {dev_ms:.4f} ms, device busy "
              f"share {dev_ms / wall_ms:.4f}{spanned}")


def k_cell(name, eng_kw, wl, sim, kernel, device) -> int:
    """Phase 11's readings of one cell: the eager loop at K = 1 (the
    oracle), its cached graph at K = 1 and at K = 8 (and in K_MORE at 5,
    a cache hit on K = 8's runner, and 32), identical fingerprints
    (metrics and ``raw`` counters incl.), the per-step windows. Returns
    the kernel's launches."""
    from repro_torch.core import engine

    plan = engine.make_plan(engine.EngineConfig(**eng_kw, **sim), wl)
    runs = {}
    order = [("graph", 1), ("graph", K_FUSED), ("eager", 1)]
    if name in K_MORE:
        order += [("graph", 5), ("graph", 32)]
    for mode, k in order:
        runs[f"{mode} K={k}"] = k_run(mode, k, eng_kw, plan, sim, kernel,
                                      device)
    if name in K_MORE and runs["graph K=5"]["hit"] != 1:
        raise AssertionError(f"{name}: K = 5 missed K = 8's runner")
    skip = {"wall_s_group"}
    want = runs["eager K=1"]["res"]
    for label, run in runs.items():
        res = run["res"]
        if fingerprint(res, True) != fingerprint(want, True) \
                or res.metrics.summary_row() != want.metrics.summary_row() \
                or {k: v for k, v in res.raw.items() if k not in skip} != {
                    k: v for k, v in want.raw.items() if k not in skip}:
            raise AssertionError(f"{name} {label}: the fingerprint differs "
                                 f"from the eager loop's")
    full = json.dumps(fingerprint(want, True), sort_keys=True)
    print(f"k-fused {name}: fingerprints identical over "
          f"{', '.join(runs)} (metrics and counters incl.; sha256 "
          f"{hashlib.sha256(full.encode()).hexdigest()[:16]})")
    for label, run in runs.items():
        steps, k, reps = run["steps"], run["K"], run["replays"]
        capture = (sum(g.capture_s for g in run["runner"].graphs.values())
                   if run["runner"] else 0.0)
        print(f"k-fused {name} {label} whole run: wall {run['wall']:.3f} s "
              f"({run['wall'] / steps * 1e3:.4f} ms/step, capture incl. "
              f"on a cache miss), steps {steps}, dispatches {reps}, host "
              f"syncs/step {reps / steps:.4f}, inactive inner steps "
              f"{(k * reps - steps) / (k * reps):.4f}, "
              f"{kernel or 'kernel'} launches {run['launches']}, "
              f"cache hit {run['hit']}, capture {capture:.3f} s")
    k_windows(name, runs, device)
    return sum(run["launches"] for run in runs.values())


def k_sweep_case(wl, device) -> int:
    """One cached orthrus runner (K = 8) through two open-arrival cells
    that differ only in the epoch interval, then the first again: each
    gives the fingerprint of a fresh eager run. Returns the lock_grant
    launches."""
    from repro_torch.core import engine

    cells = [dict(ORTHRUS_FULL, epoch_interval_rounds=iv)
             for iv in (200, 400, 200)]
    fresh = {}
    launches = 0
    for i, eng_kw in enumerate(cells):
        iv = eng_kw["epoch_interval_rounds"]
        plan = engine.make_plan(engine.EngineConfig(**eng_kw, **SIM_K), wl)
        if iv not in fresh:
            run = k_run("eager", 1, eng_kw, plan, SIM_K, "lock_grant",
                        device)
            fresh[iv] = fingerprint(run["res"], True)
            launches += run["launches"]
        run = k_run("graph", K_FUSED, eng_kw, plan, SIM_K, "lock_grant",
                    device)
        launches += run["launches"]
        if fingerprint(run["res"], True) != fresh[iv] or run["hit"] != (
                i > 0):
            raise AssertionError(f"orthrus sweep cell {i} (interval {iv}): "
                                 f"diverged from a fresh run, or cache hit "
                                 f"{run['hit']}")
        m = run["res"].metrics
        print(f"k-fused orthrus sweep cell {i}, epoch interval {iv}: the "
              f"fresh run's fingerprint, cache hit {run['hit']}, "
              f"{run['steps']} steps in {run['wall']:.3f} s; commits "
              f"{run['res'].commits}, offered {m.offered}, q_depth max "
              f"{int(max(m.q_depth))}")
    if fresh[200] == fresh[400]:
        raise AssertionError("the two epoch intervals gave one fingerprint")
    return launches


def main_path_slice7_kfused(device) -> dict:
    """Phase 11: K-fused dispatch at the paper's width. Returns the
    lock_grant and dep_wavefront launches of the path."""
    import torch

    from repro_torch.core import sweep

    workloads = {}
    for _name, _eng_kw, wl_kw, _sim, _kernel in K_CELLS:
        key = json.dumps(wl_kw, sort_keys=True)
        if key not in workloads:
            workloads[key] = make_full_workload(wl_kw)
    reset_launches()
    counts = {"lock_grant": 0, "dep_wavefront": 0}
    for name, eng_kw, wl_kw, sim, kernel in K_CELLS:
        n = k_cell(name, eng_kw, workloads[json.dumps(wl_kw, sort_keys=True)],
                   sim, kernel, device)
        if kernel:
            counts[kernel] += n
    counts["lock_grant"] += k_sweep_case(
        workloads[json.dumps(YCSB_FULL, sort_keys=True)], device)
    info = sweep.runner_cache_info()
    print(f"k-fused: runner cache {info['entries']} entries, "
          f"{info['hits']} hits, {info['misses']} misses, "
          f"{info['evictions']} evictions; card memory allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB, reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB")
    print(f"slice 7 K-fused path: kernel launches {counts}")
    return counts


def sweep_kernel(cfg, meta, device):
    """The kernel a cell's step launches once on ``device`` (B1 on
    orthrus' kernel path, B2 on a batch cell with predecessor edges)."""
    from repro_torch.kernels import use_kernel

    if cfg.state_layout == "legacy" or not use_kernel(cfg.kernel_impl,
                                                      device):
        return None
    if cfg.protocol == "orthrus":
        return "lock_grant"
    width = meta.frag_pred_width if cfg.fragment_exec else meta.pred_width
    return "dep_wavefront" if cfg.is_batch_planned and width > 0 else None


def counted_run(label, fn):
    """``fn()`` (a sweep or per-cell runs), holding B1's and B2's
    launches to the replays of the runners it drove: a group runner's
    C x K a replay (its inactive branches' included), one cell's K.
    Returns (fn's result, wall s, launches by kernel)."""
    from repro_torch.core import sweep

    ops = kernel_ops()
    names = ("lock_grant", "dep_wavefront")
    launches = {n: ops[n].launches for n in names}
    replays = {key: r.replays for key, r in sweep._RUNNER_CACHE.items()}
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    want = dict.fromkeys(names, 0)
    for key, r in sweep._RUNNER_CACHE.items():
        kernel = sweep_kernel(r.cfg, r.meta, r.device)
        if kernel:
            want[kernel] += (getattr(r, "n", 1) * r.cfg.dispatch_rounds
                             * (r.replays - replays.get(key, 0)))
    got = {n: ops[n].launches - launches[n] for n in names}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, the runners' "
                             f"replays give {want}")
    return out, wall, got


def same_results(label, got, want, group_sizes=None) -> None:
    """Fingerprints, metrics and ``raw`` counters equal (the wall and,
    against one-cell runs, ``group_cells`` aside); ``group_cells`` equal
    to ``group_sizes``."""
    skip = {"wall_s_group", "group_cells"}
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        if fingerprint(g, True) != fingerprint(w, True) \
                or g.metrics.summary_row() != w.metrics.summary_row() \
                or {k: v for k, v in g.raw.items() if k not in skip} != {
                    k: v for k, v in w.raw.items() if k not in skip}:
            raise AssertionError(f"{label}: cell {i} differs from its "
                                 f"single-cell run")
        if group_sizes is not None and g.raw["group_cells"] != group_sizes[i]:
            raise AssertionError(f"{label}: cell {i} group_cells "
                                 f"{g.raw['group_cells']}, want "
                                 f"{group_sizes[i]}")


def sweep_groups(cells) -> list:
    """Each cell's group under the reference's grouping key (statics,
    host-loop budget, plan shape), from the cells' plans: the index of
    its group's first cell."""
    from repro_torch.core import engine, sweep

    keys = []
    for cfg, wl in cells:
        plan = engine.make_plan(cfg, wl)
        keys.append((cfg.trace_statics(), sweep._budget(cfg),
                     engine.plan_meta(cfg, plan),
                     sweep._plan_shape_sig(engine.plan_device(cfg, plan))))
    return [keys.index(k) for k in keys]


def group_windows(name, group, single, device, replays: int = 16,
                  profiled: int = 4) -> None:
    """One group's graph against one of its cells' K = 1 graph, and
    that cell's state in a one-cell group graph (its whole dispatch
    guarded: the guard's cost a step), from the end of their runs with
    every bound far ahead: span a replay (CUDA events around
    back-to-back replays, in turns), then under torch.profiler the
    device ms a replay (the kernel nodes' self device time) and its
    share of the span. C independent branches that overlapped would
    show a span under C x the cell's."""
    from repro_torch.core import sweep

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = next(iter(group.graphs.values()))
    one = graph_of(single)
    guard = sweep.get_group_runner(group.cfg, group.meta, device, 1)
    guard.load([one.p], [one.state])
    guard = guard.cells
    for buf in (g.r_end, one.r_end, guard.r_end):
        buf.fill_(10**9)

    def span(replay):
        replay()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(replays):
            replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / replays

    def device_ms(replay):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(profiled):
                replay()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        if not kern:
            raise AssertionError(f"{name}: the profiler saw no CUDA kernel")
        return (sum(e.self_device_time_total for e in kern) / profiled / 1e3,
                sum(e.count for e in kern) / profiled)

    fns = {"group": g.replay, "cell": one.replay, "guarded": guard.replay}
    spans = in_turns(fns, span)
    dev = {label: device_ms(fn) for label, fn in fns.items()}
    c = len(g.state)
    (gs, g_ms), (cs, c_ms) = spans["group"], spans["cell"]
    (us, u_ms) = spans["guarded"]
    print(f"sweep {name} group of {c}: span a replay {g_ms:.4f} ms (turns "
          f"{' / '.join(f'{x:.4f}' for x in gs)}), device "
          f"{dev['group'][0]:.4f} ms in {dev['group'][1]:.1f} kernel nodes, "
          f"busy {dev['group'][0] / g_ms:.4f}; one cell's K = 1 graph: span "
          f"{c_ms:.4f} ms (turns {' / '.join(f'{x:.4f}' for x in cs)}), "
          f"device {dev['cell'][0]:.4f} ms in {dev['cell'][1]:.1f} nodes, "
          f"busy {dev['cell'][0] / c_ms:.4f}; group span / (C x cell span) "
          f"{g_ms / (c * c_ms):.4f}, group device / (C x cell device) "
          f"{dev['group'][0] / (c * dev['cell'][0]):.4f}")
    print(f"sweep {name} the cell guarded whole (a one-cell group graph): "
          f"span {u_ms:.4f} ms (turns {' / '.join(f'{x:.4f}' for x in us)}), "
          f"device {dev['guarded'][0]:.4f} ms in {dev['guarded'][1]:.1f} "
          f"nodes; the guard adds {u_ms - c_ms:+.4f} ms of span, "
          f"{dev['guarded'][0] - dev['cell'][0]:+.4f} ms of device time and "
          f"{dev['guarded'][1] - dev['cell'][1]:+.1f} nodes a step")


def main_path_slice8_sweep(device) -> dict:
    """Phase 12: the multi-cell sweep at the paper's width. Fig 13's
    contention axis through ``run_cells`` under SERIAL_MODE and the
    pipelined early-exit mode, each cell equal to its own
    ``run_simulation``; the cells/s of the sweep against per-cell runs,
    in turns; the group spans; the early-exit subset; the 17 goldens
    twice in one call. Returns the lock_grant and dep_wavefront
    launches of the path."""
    import torch

    from repro_torch.core import engine, sweep
    from repro_torch.core.workloads import WorkloadConfig, make_workload

    torch.cuda.reset_peak_memory_stats(device)
    wls = {h: make_full_workload(dict(YCSB_FULL, num_hot=h))
           for h in SWEEP_HOTS}
    cells = [(engine.EngineConfig(**eng_kw, **SIM_SWEEP), wls[h])
             for h in SWEEP_HOTS for _name, eng_kw in SWEEP_PROTOCOLS]
    names = [f"fig13_h{h}_{name}" for h in SWEEP_HOTS
             for name, _eng_kw in SWEEP_PROTOCOLS]
    group_of = sweep_groups(cells)
    sizes = [group_of.count(g) for g in group_of]
    mode = sweep.SweepMode(**SWEEP_MODE_ARGS)
    reset_launches()
    counts = dict.fromkeys(("lock_grant", "dep_wavefront"), 0)

    def count(label, fn):
        out, wall, got = counted_run(label, fn)
        for k, v in got.items():
            counts[k] += v
        return out, wall

    def per_cell(cs):
        return [engine.run_simulation(cfg, wl, device=device)
                for cfg, wl in cs]

    want, t_cold = count("fig13 per cell", lambda: per_cell(cells))
    caps = sweep.runner_cache_info()
    serial, t_serial = count("fig13 run_cells serial", lambda: sweep.run_cells(
        cells, mode=sweep.SERIAL_MODE, device=device))
    same_results("fig13 serial", serial, want, sizes)
    groups = [(key, r) for key, r in sweep._RUNNER_CACHE.items()
              if isinstance(r, sweep.GroupRunner)
              and key not in caps["keys"]]
    for key, r in groups:
        cap = sum(g.capture_s for g in r.graphs.values())
        print(f"sweep group: {r.cfg.protocol}, {r.n} cells, capture "
              f"{cap:.3f} s, replays {r.replays}")
    piped, t_piped = count("fig13 run_cells pipelined", lambda: sweep.run_cells(
        cells, mode=mode, device=device))
    same_results("fig13 pipelined", piped, want, sizes)
    for name, res, size in zip(names, want, sizes):
        print(f"sweep {name}: group of {size}, commits {res.commits}, "
              f"steps {res.raw['steps_executed']}, simulated "
              f"throughput_txn_s {res.throughput_txn_s}")
    print(f"sweep fig13: {len(cells)} cells in {len(groups)} groups of "
          f"several cells and {sizes.count(1)} alone, every "
          f"fingerprint equal to its run_simulation (metrics and counters "
          f"incl.) under SERIAL_MODE and {mode}; first walls: per cell "
          f"{t_cold:.3f} s (captures incl.), serial sweep {t_serial:.3f} s "
          f"(group captures incl.), pipelined {t_piped:.3f} s")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    turns = in_turns({
        "per cell": lambda: count("turn per cell", lambda: per_cell(cells)),
        "run_cells": lambda: count("turn run_cells", lambda: sweep.run_cells(
            cells, mode=mode, device=device)),
    }, timed)
    (pc, pc_s), (rc, rc_s) = turns["per cell"], turns["run_cells"]
    print(f"sweep fig13 wall, warm caches, in turns: per cell "
          f"{' / '.join(f'{x:.3f}' for x in pc)} s = {pc_s:.3f} s "
          f"({len(cells) / pc_s:.3f} cells/s); run_cells {mode} "
          f"{' / '.join(f'{x:.3f}' for x in rc)} s = {rc_s:.3f} s "
          f"({len(cells) / rc_s:.3f} cells/s); ratio {pc_s / rc_s:.4f}")

    # the largest group of each engine: orthrus' (B1), dgcc's or else
    # quecc's (B2)
    for protos in (("orthrus",), ("dgcc", "quecc")):
        cands = [r for p in protos for _key, r in groups
                 if r.cfg.protocol == p]
        if not cands:
            raise AssertionError(f"no group of several {protos} cells")
        group = max(cands, key=lambda r: r.n)
        single = sweep.get_runner(group.cfg, group.meta, device)
        group_windows(f"fig13 {group.cfg.protocol}", group, single, device)

    exit_cells, exit_names = [], []
    for proto in EXIT_PROTOCOLS:
        eng_kw = dict(SWEEP_PROTOCOLS)[proto]
        base = [(i, r) for i, (r, (cfg, _)) in enumerate(zip(want, cells))
                if cfg.protocol == proto]
        # half the median cell's measured commits: the cells of the
        # group meet it at different boundaries
        target = sorted(r.commits for _i, r in base)[1] // 2
        for h in SWEEP_HOTS:
            exit_cells.append((engine.EngineConfig(
                **eng_kw, **dict(SIM_SWEEP, target_commits=target)), wls[h]))
            exit_names.append(f"{proto}_h{h}_target{target}")
    exit_group = sweep_groups(exit_cells)
    exit_sizes = [exit_group.count(g) for g in exit_group]
    exit_want, _ = count("exit per cell", lambda: per_cell(exit_cells))
    for label, m in (("serial", sweep.SERIAL_MODE), ("pipelined", mode)):
        got, wall = count(f"exit {label}", lambda m=m: sweep.run_cells(
            exit_cells, mode=m, device=device))
        same_results(f"exit {label}", got, exit_want, exit_sizes)
        print(f"sweep early exit {label}: {wall:.3f} s")
    stops = [r.raw["rounds_total"] for r in exit_want]
    for name, stop, size in zip(exit_names, stops, exit_sizes):
        print(f"sweep early exit {name}: group of {size}, stops at "
              f"boundary {stop}")
    if not any(len({b for b, g in zip(stops, exit_group) if g == first}) > 1
               for first in set(exit_group)):
        raise AssertionError(f"no group stops at two boundaries: {stops}")

    gcells, gnames = [], []
    for name in GOLDEN_CELLS:
        g = json.loads((GOLDEN / f"{name}.json").read_text())
        cfg = engine.EngineConfig(**g["engine"], **g["sim"])
        wl = make_workload(WorkloadConfig(**g["workload"]))
        gcells += [(cfg, wl), (cfg, wl)]
        gnames += [name, name]
    t0 = time.time()
    gres, _ = count("goldens twice", lambda: sweep.run_cells(
        gcells, mode=mode, device=device))
    for name, res in zip(gnames, gres):
        g = json.loads((GOLDEN / f"{name}.json").read_text())
        got = fingerprint(res, include_metrics=name in GOLDEN_METRICS_CELLS)
        if got != g["trace"] or res.raw["group_cells"] != 2:
            raise AssertionError(f"golden {name} in the sweep diverged "
                                 f"(group_cells {res.raw['group_cells']})")
    print(f"sweep goldens: all {len(GOLDEN_CELLS)} twice in one run_cells "
          f"call, bit-exact, groups of 2 ({time.time() - t0:.3f} s)")
    info = sweep.runner_cache_info()
    print(f"sweep: runner cache {info['entries']} entries, {info['hits']} "
          f"hits, {info['misses']} misses, {info['evictions']} evictions; "
          f"card memory max allocated "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB")
    print(f"slice 8 sweep path: kernel launches {counts}")
    return counts


def kernel_ops() -> dict:
    """The five kernels' ops modules by name; each counts its launches."""
    from repro_torch.kernels.dep_wavefront import ops as dw_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.lock_grant import ops as lg_ops
    from repro_torch.kernels.moe_dispatch import ops as md_ops
    from repro_torch.kernels.rwkv6_scan import ops as rw_ops

    return {"lock_grant": lg_ops, "dep_wavefront": dw_ops,
            "flash_attention": fa_ops, "rwkv6_scan": rw_ops,
            "moe_dispatch": md_ops}


def reset_launches() -> None:
    for ops in kernel_ops().values():
        ops.launches = 0


def main_path_slice1(device) -> int:
    """Phase 4: orthrus and deadlock_free at the paper's width through
    ``run_simulation``. Returns the lock_grant launches of the path."""
    from repro_torch.kernels.lock_grant import ops

    wl = make_full_workload(YCSB_FULL)
    reset_launches()
    _res, launches = both_paths("orthrus", ORTHRUS_FULL, wl, device, ops,
                                sim=SIM_CUT)
    run_cell("deadlock_free", DF_FULL, wl, device, sim=SIM_CUT)
    if ops.launches != launches:
        raise AssertionError("deadlock_free launched lock_grant")
    profile_steps("orthrus", {
        "kernel path": ORTHRUS_FULL,
        "plain path": dict(ORTHRUS_FULL, kernel_impl="jnp")}, wl, device,
        watch="lock_grant")
    profile_steps("deadlock_free", {"(no kernel)": DF_FULL}, wl, device)
    return launches


def main_path_slice2(device) -> int:
    """Phase 5: the batch-planned engine at the paper's width through
    ``run_simulation``. Returns the dep_wavefront launches of the path."""
    from repro_torch.kernels.dep_wavefront import ops

    workloads = {name: make_full_workload(wl_kw)
                 for name, _eng_kw, wl_kw in BATCH_CELLS}
    reset_launches()
    total = sum(both_paths(name, eng_kw, workloads[name], device, ops)[1]
                for name, eng_kw, _wl_kw in BATCH_CELLS)
    if total != ops.launches:
        raise AssertionError("dep_wavefront launched outside the runs")
    profile_steps("dgcc", {
        "kernel path": DGCC_FULL,
        "plain path": dict(DGCC_FULL, kernel_impl="jnp")},
        workloads["dgcc"], device, warm=300, watch="dep_wavefront")
    profile_steps("quecc_frag_pipe", {"kernel path": QUECC_FRAG_PIPE_FULL},
                  workloads["quecc_frag_pipe"], device, warm=300,
                  watch="dep_wavefront")
    return total



def serve_requests(cfg, seed=SEED, n=SERVE_REQUESTS, lens=SERVE_PROMPT_LENS,
                   new_tokens=SERVE_NEW_TOKENS):
    """A serving phase's requests: ``n`` prompt lengths in ``lens`` and
    their tokens from ``seed`` (phase 6's by default)."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    lo, hi = lens
    lengths = rng.integers(lo, hi + 1, n)
    return [Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, k).astype(
                np.int32), max_new_tokens=new_tokens)
            for i, k in enumerate(lengths)]


def serve_run(model, device, kernel_impl, n_requests=SERVE_REQUESTS):
    """One whole serving run of the first ``n_requests`` requests:
    (engine, answered requests, wall s)."""
    import torch

    from repro_torch.serve import ServeConfig, ServingEngine

    cfg, params = model
    eng = ServingEngine(cfg, ServeConfig(batch_slots=SERVE_SLOTS,
                                         cache_len=SERVE_CACHE_LEN),
                        params, device=device, kernel_impl=kernel_impl)
    reqs = serve_requests(cfg)[:n_requests]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    return eng, done, time.perf_counter() - t0


def first_token_logits(model, device, outputs, tol=FIRST_LOGIT_TOL,
                       n_requests=SERVE_REQUESTS) -> None:
    """The first ``n_requests`` requests' prefill logits on the kernel and
    the plain path: the largest difference, held to ``tol``, and each
    path's argmax equal to the first token its engine run gave."""
    import torch

    from repro_torch.models import model as M

    cfg, params = model
    worst = scale = 0.0
    same = 0
    for req in serve_requests(cfg)[:n_requests]:
        prompt = torch.as_tensor(req.prompt, dtype=torch.long,
                                 device=device)[None]
        logits = {}
        for impl in ("auto", "jnp"):
            lg, _ = M.prefill(params, cfg, prompt, kernel_impl=impl)
            lg = lg[0, -1].float()
            if not bool(torch.isfinite(lg).all()):
                raise AssertionError(f"request {req.rid} kernel_impl={impl}: "
                                     f"non-finite logits")
            if int(torch.argmax(lg)) != outputs[impl][req.rid][0]:
                raise AssertionError(f"request {req.rid} kernel_impl={impl}: "
                                     f"the engine's first token is not the "
                                     f"prefill's argmax")
            logits[impl] = lg
        worst = max(worst, float((logits["auto"] - logits["jnp"]).abs().max()))
        scale = max(scale, float(logits["jnp"].abs().max()))
        same += int(torch.argmax(logits["auto"]) == torch.argmax(logits["jnp"]))
    print(f"{cfg.name} first-token logits, kernel vs plain path, over the "
          f"{n_requests} prompts: max |difference| {worst} (tolerance "
          f"{tol}; largest |logit| {scale}); {same} of {n_requests} first "
          f"tokens agree")
    if not worst <= tol:
        raise AssertionError(f"first-token logits differ by {worst} > {tol}")


@contextlib.contextmanager
def planner(name, make):
    """``repro_torch.models.moe``'s ``name`` (``moe_dispatch_plan``, B3's
    wrapper, or ``plan_dispatch``, its plain version) replaced by
    ``make(original)`` inside the block."""
    from repro_torch.models import moe

    orig = getattr(moe, name)
    setattr(moe, name, make(orig))
    try:
        yield
    finally:
        setattr(moe, name, orig)


def recording(rec):
    """A planner that appends (plan, each token's chosen experts sorted
    [N, k], capacity) to ``rec``, a call at a time."""
    from repro_torch.models import moe

    def wrap(orig):
        def recorded(probs, *, top_k, capacity):
            plan = orig(probs, top_k=top_k, capacity=capacity)
            choice = moe.route(probs.reshape(-1, probs.shape[-1]),
                               top_k)[1].sort(-1).values
            rec.append((plan, choice, capacity))
            return plan
        return recorded
    return wrap


def plain_plan(_orig):
    """A planner that is B3's plain version."""
    from repro_torch.models import moe

    return lambda probs, *, top_k, capacity: moe.plan_dispatch(
        probs, top_k=top_k, capacity=capacity)


def replaying(plans):
    """A planner that hands back ``recording``'s plans in turn."""
    it = iter(plans)

    def wrap(_orig):
        def replayed(probs, *, top_k, capacity):
            plan, _choice, cap = next(it)
            if cap != capacity:
                raise AssertionError("replayed plan of another capacity")
            return plan
        return replayed
    return wrap


def mixtral_first_token_logits(model, device, outputs, tol=FIRST_LOGIT_TOL,
                               n_requests=SERVE_REQUESTS) -> None:
    """The first ``n_requests`` requests' prefill logits on the kernel path
    (B4 and B3) and the plain path, held thus:

    * each path's argmax is its engine's first token;
    * the kernel path with the plain plan in B3's place: B3 is the only
      difference and it is exact, so the logits must be bit-identical;
    * the plain path with the kernel path's plans (the routing, drops
      included, held fixed) differs from the kernel path only in the
      attention's bf16 rounding: within ``tol``;
    * both paths free-running, each with its own routing, in three runs:
      these prompts at the serving capacity and at a capacity that drops
      nothing (capacity factor E / k), and prompts from
      MIXTRAL_SECOND_SEED at the serving capacity. In each run the two
      choose the same top-k experts for at least MIXTRAL_MIN_AGREEMENT of
      the (token, layer) pairs, and where both dispatch a prompt's last
      token alike at every layer (the same experts, the same ones kept),
      which must hold for at least half the prompts, its logits are
      within ``tol``. Where they do not, the top-k choice is a step of
      the model's function: a bf16 rounding that flips a router near-tie
      changes the token's experts, and its logits move by far more than
      a rounding; the difference over all prompts is printed beside.
    """
    import dataclasses

    import torch

    from repro_torch.models import model as M

    cfg, params = model
    n_layers = cfg.num_layers
    ample = dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)

    def first(prompt, impl, c=cfg):
        lg, _ = M.prefill(params, c, prompt, kernel_impl=impl)
        lg = lg[0, -1].float()
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"kernel_impl={impl}: non-finite logits")
        return lg

    def free_run(prompt, c=cfg):
        """Both paths with their own routing: logits and recorded plans."""
        kern, plain = [], []
        with planner("moe_dispatch_plan", recording(kern)):
            lg_k = first(prompt, "auto", c)
        with planner("plan_dispatch", recording(plain)):
            lg_p = first(prompt, "jnp", c)
        if len(kern) != n_layers or len(plain) != n_layers:
            raise AssertionError("a prefill did not plan every layer once")
        return lg_k, lg_p, kern, plain

    def tally(name):
        return dict(name=name, diff=0.0, diff_last_same=0.0, last_same=0,
                    agree=[0] * n_layers, routed=[0] * n_layers,
                    kept=[0] * n_layers)

    def last_kept(plan, n_tokens):
        """bool[E]: the experts that keep the prompt's last token."""
        return (plan["slot_token"].view(cfg.num_experts, -1)
                == n_tokens - 1).any(-1)

    def count(acc, lg_k, lg_p, kern, plain):
        """Adds one prompt's difference, agreement and drops to ``acc``."""
        diff = float((lg_p - lg_k).abs().max())
        acc["diff"] = max(acc["diff"], diff)
        alike = True
        for layer, ((plan, c_k, _), (plan_p, c_p, _c)) in enumerate(
                zip(kern, plain)):
            same = (c_k == c_p).all(-1)
            acc["agree"][layer] += int(same.sum())
            acc["routed"][layer] += c_k.numel()
            acc["kept"][layer] += int((plan["slot_token"] >= 0).sum())
            alike &= bool(same[-1]) and torch.equal(
                last_kept(plan, c_k.shape[0]), last_kept(plan_p, c_k.shape[0]))
        acc["last_same"] += int(alike)
        if alike:
            acc["diff_last_same"] = max(acc["diff_last_same"], diff)

    def agreement(acc):
        pairs = sum(acc["routed"]) // cfg.experts_per_token
        return sum(acc["agree"]) / pairs

    def report(acc):
        k = cfg.experts_per_token
        per_layer = [round(a * k / r, 6) for a, r in zip(acc["agree"],
                                                         acc["routed"])]
        drops = [round(1 - kp / r, 6) for kp, r in zip(acc["kept"],
                                                       acc["routed"])]
        print(f"{cfg.name} first-token logits, both paths free-running, "
              f"{acc['name']}: the last token dispatched alike at every "
              f"layer in {acc['last_same']} of {n_requests} prompts, max "
              f"|difference| over those {acc['diff_last_same']} (tolerance "
              f"{tol}; over all prompts {acc['diff']}); the same top-{k} "
              f"experts for {agreement(acc):.6f} of the (token, layer) pairs "
              f"(at least {MIXTRAL_MIN_AGREEMENT}), layer by layer "
              f"{per_layer}; share of routed entries dropped at capacity, "
              f"kernel path, layer by layer: {drops}")
        if not (acc["diff_last_same"] <= tol
                and 2 * acc["last_same"] >= n_requests
                and agreement(acc) >= MIXTRAL_MIN_AGREEMENT):
            raise AssertionError(f"{cfg.name} free-running paths, "
                                 f"{acc['name']}: out of bounds")

    def prompt_of(req):
        return torch.as_tensor(req.prompt, dtype=torch.long,
                               device=device)[None]

    forced = scale = 0.0
    served = tally(f"the serving capacity factor {cfg.capacity_factor}")
    at_ample = tally(f"capacity factor {ample.capacity_factor} (no drops)")
    second = tally(f"the serving capacity, prompts from seed "
                   f"{MIXTRAL_SECOND_SEED}")
    for req in serve_requests(cfg)[:n_requests]:
        prompt = prompt_of(req)
        lg_kern, lg_free, kern_plans, free_plans = free_run(prompt)
        with planner("moe_dispatch_plan", plain_plan):
            lg_b3_plain = first(prompt, "auto")
        with planner("plan_dispatch", replaying(kern_plans)):
            lg_forced = first(prompt, "jnp")
        for impl, lg in (("auto", lg_kern), ("jnp", lg_free)):
            if int(torch.argmax(lg)) != outputs[impl][req.rid][0]:
                raise AssertionError(f"request {req.rid} kernel_impl={impl}: "
                                     f"the engine's first token is not the "
                                     f"prefill's argmax")
        if not torch.equal(lg_kern, lg_b3_plain):
            raise AssertionError(f"request {req.rid}: the kernel path's "
                                 f"logits change when the plain plan takes "
                                 f"B3's place")
        forced = max(forced, float((lg_forced - lg_kern).abs().max()))
        scale = max(scale, float(lg_kern.abs().max()))
        count(served, lg_kern, lg_free, kern_plans, free_plans)
        count(at_ample, *free_run(prompt, ample))
    for req in serve_requests(cfg, MIXTRAL_SECOND_SEED)[:n_requests]:
        count(second, *free_run(prompt_of(req)))
    print(f"{cfg.name} first-token logits over the {n_requests} prompts "
          f"(largest |logit| {scale}): the kernel path with the plain plan "
          f"in B3's place bit-identical; the plain path with the kernel "
          f"path's plans: max |difference| {forced} (tolerance {tol})")
    if not forced <= tol:
        raise AssertionError(f"first-token logits with the same plans differ "
                             f"by {forced} > {tol}")
    if at_ample["kept"] != at_ample["routed"]:
        raise AssertionError(f"capacity factor {ample.capacity_factor} "
                             f"dropped entries")
    for acc in (served, at_ample, second):
        report(acc)


def device_activity(prof) -> dict:
    """{name: [count, device s]} over a trace's device activities
    (kernels, copies, memsets), summed from the profiler's raw events:
    the CUDA rows of ``key_averages()`` without building its event tree,
    which takes about 150 us an event on the card's host (30 s for a
    gemma3-1b serving run)."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        row = out.setdefault(e.name(), [0, 0.0])
        row[0] += 1
        row[1] += e.duration_ns() / 1e9
    return out


def profile_share(label, run, wall_s, kernels=()) -> None:
    """``run()`` (which returns its own wall s) under torch.profiler, CUDA
    activity only: CUDA kernels, device seconds, each of ``kernels``'
    share of them, and the device busy share against ``wall_s``, the
    wall time of the same work unprofiled."""
    import re

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prof_wall = run()
    t0 = time.time()
    kern = device_activity(prof)
    print(f"profile {label}: the trace read in {time.time() - t0:.3f} s")
    n_kernels = sum(c for c, _s in kern.values())
    dev_s = sum(sec for _c, sec in kern.values())
    # B4's bf16 kernel is flash_attention_tc_kernel, B5's
    # rwkv6_scan_tile_kernel, B3's moe_dispatch_plan_kernel
    mine = {k: {n: v for n, v in kern.items()
                if re.search(rf"{k}(_tc|_tile|_plan)?_kernel", n)}
            for k in kernels}
    k_s = {k: sum(sec for _c, sec in v.values()) for k, v in mine.items()}
    if n_kernels <= 0 or not all(k_s.values()):
        raise AssertionError(f"the profiler saw no CUDA kernel or not each "
                             f"of {kernels}: {k_s}")
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:6]
    print(f"profile {label}: {n_kernels} CUDA kernels, device {dev_s:.4f} s "
          f"against {wall_s:.4f} s wall unprofiled ({prof_wall:.4f} s under "
          f"the profiler): device busy share {dev_s / wall_s:.4f}; "
          + ", ".join(f"{k} {t:.4f} s ({t / dev_s:.4f} of device time; "
                      f"{sorted({n[:60] for n in mine[k]})})"
                      for k, t in k_s.items())
          + "; top kernels: "
          + "; ".join(f"{n[:60]} {sec * 1e3:.1f} ms" for n, (_c, sec) in top))


def profile_serving(model, device, wall_s, kernels, kernel_impl="auto",
                    n_requests=SERVE_REQUESTS) -> None:
    """One path's serving run again under torch.profiler (about 210,000
    kernels for gemma3-1b): ``profile_share``'s readings against the
    unprofiled run's wall time."""
    path = "kernel path" if kernel_impl == "auto" else "plain path"
    profile_share(f"{model[0].name} serving, {path}",
                  lambda: serve_run(model, device, kernel_impl,
                                    n_requests)[2], wall_s, kernels)


def serve_both_paths(model, device, want, n_plain, logit_tol,
                     logits_check=first_token_logits,
                     profile_plain=False, turns=False) -> dict:
    """One model's serving cell through ServingEngine at full width: all
    requests on the kernel path, the first ``n_plain`` on the plain path.
    ``want`` maps each kernel of the kernel path to its launches as a
    function of the engine's stats; every other serving kernel, and on
    the plain path every kernel, launches none. With ``turns``, both
    paths serve again in reverse order (kernel, plain, plain, kernel)
    and their prefill and decode times are printed in turns. First-token
    logits held to ``logit_tol`` by ``logits_check``; a profile of the
    kernel path, and with ``profile_plain`` of the plain path. Returns
    the kernel path's launches by kernel."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.moe_dispatch import ops as md_ops
    from repro_torch.kernels.rwkv6_scan import ops as rw_ops

    cfg, _params = model
    counts = {"flash_attention": fa_ops, "rwkv6_scan": rw_ops,
              "moe_dispatch": md_ops}
    outputs, walls, launches, timed = {}, {}, {}, {}
    for impl, n_req in (("auto", SERVE_REQUESTS), ("jnp", n_plain)):
        reset_launches()
        eng, done, wall = serve_run(model, device, impl, n_req)
        launches[impl] = {k: m.launches for k, m in counts.items()}
        st = eng.stats
        expect = {k: want[k](st) if impl == "auto" and k in want else 0
                  for k in counts}
        n_tok = sum(len(r.output) for r in done)
        print(f"{cfg.name} serving kernel_impl={impl}: {len(done)} of "
              f"{n_req} requests answered, {n_tok} tokens in "
              f"{wall:.3f} s ({n_tok / wall:.2f} tokens/s); prefill "
              f"{st['prefill_s'] / st['prefills'] * 1e3:.3f} ms per request "
              f"({st['prefills']} prompts of {SERVE_PROMPT_LENS[0]}-"
              f"{SERVE_PROMPT_LENS[1]} tokens, "
              f"{sum(len(r.prompt) for r in done)} in all), decode "
              f"{st['decode_s'] / st['decode_steps'] * 1e3:.3f} ms per step "
              f"({st['decode_steps']} steps of {SERVE_SLOTS} slots); "
              f"launches {launches[impl]}")
        if (len(done) != n_req or st["prefills"] != n_req
                or launches[impl] != expect):
            raise AssertionError(f"{cfg.name} kernel_impl={impl}: "
                                 f"{len(done)} answered, {st['prefills']} "
                                 f"prefills, launches {launches[impl]}, want "
                                 f"{expect}")
        for r in done:
            if not (1 <= len(r.output) <= SERVE_NEW_TOKENS and all(
                    0 <= t < cfg.vocab_size for t in r.output)):
                raise AssertionError(f"request {r.rid}: output {r.output}")
        outputs[impl] = {r.rid: r.output for r in done}
        walls[impl] = wall
        timed[impl] = [st]
    if turns:
        for impl, n_req in (("jnp", n_plain), ("auto", SERVE_REQUESTS)):
            timed[impl].append(serve_run(model, device, impl, n_req)[0].stats)
        print(f"{cfg.name} serving in turns (kernel, plain, plain, kernel "
              f"path; each reading and the mean): " + "; ".join(
                  f"{path} prefill " + " / ".join(
                      f"{st['prefill_s'] / st['prefills'] * 1e3:.3f}"
                      for st in timed[impl])
                  + f" = {mean_ms(timed[impl], 'prefill'):.3f} ms per "
                  f"request, decode " + " / ".join(
                      f"{st['decode_s'] / st['decode_steps'] * 1e3:.3f}"
                      for st in timed[impl])
                  + f" = {mean_ms(timed[impl], 'decode'):.3f} ms per step"
                  for impl, path in (("auto", "kernel path"),
                                     ("jnp", "plain path"))))
    k, j = outputs["auto"], outputs["jnp"]
    same = sum(a == b for rid in j for a, b in zip(k[rid], j[rid]))
    print(f"{cfg.name} serving, kernel vs plain path tokens over the "
          f"{n_plain} requests both served: {same} of "
          f"{sum(len(j[rid]) for rid in j)} positions agree; "
          f"{sum(k[rid][0] == j[rid][0] for rid in j)} of {len(j)} first "
          f"tokens; {sum(k[rid] == j[rid] for rid in j)} whole outputs")
    logits_check(model, device, outputs, logit_tol, n_plain)
    profile_serving(model, device, walls["auto"], tuple(want))
    if profile_plain:
        profile_serving(model, device, walls["jnp"], (), "jnp", n_plain)
    return launches["auto"]


def mean_ms(stats, what) -> float:
    """Mean ms per prefill (``what`` "prefill") or per decode step
    ("decode") over engine stats."""
    key = "prefills" if what == "prefill" else "decode_steps"
    return sum(st[f"{what}_s"] / st[key] for st in stats) / len(stats) * 1e3


def main_path_slice3(device, model) -> int:
    """Phase 6: gemma3-1b serving at full width through ServingEngine, on
    the kernel and the plain path (all requests on both); flash_attention
    launched once per layer of every prefill. Returns its launches."""
    return serve_both_paths(
        model, device,
        {"flash_attention": lambda st: model[0].num_layers * st["prefills"]},
        SERVE_REQUESTS, FIRST_LOGIT_TOL)["flash_attention"]


def scan_rounding_sensitivity(model, device, n_requests) -> None:
    """How far the first ``n_requests`` requests' first-token logits move
    on the kernel path when only the scan's outputs move by RWKV_NUDGE
    relative (Gaussian, from SEED): the size of the difference that
    another order of the f32 sums can make. Printed beside the first-token
    check; checks nothing itself."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.models import ssm

    cfg, params = model
    original = ssm.rwkv6_scan
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)

    def nudged(*args, **kw):
        o, state = original(*args, **kw)
        noise = torch.randn(o.shape, generator=gen, device=o.device)
        return o * (1 + RWKV_NUDGE * noise), state

    worst = 0.0
    for req in serve_requests(cfg)[:n_requests]:
        prompt = torch.as_tensor(req.prompt, dtype=torch.long,
                                 device=device)[None]
        base, _ = M.prefill(params, cfg, prompt, kernel_impl="auto")
        ssm.rwkv6_scan = nudged
        try:
            moved, _ = M.prefill(params, cfg, prompt, kernel_impl="auto")
        finally:
            ssm.rwkv6_scan = original
        worst = max(worst, float((base[0, -1].float()
                                  - moved[0, -1].float()).abs().max()))
    print(f"{cfg.name} first-token logits, kernel path against itself with "
          f"the scan's outputs moved by {RWKV_NUDGE} relative, over the "
          f"{n_requests} prompts: max |difference| {worst}")


def main_path_slice4(device, model) -> int:
    """Phase 7: rwkv6-1.6b serving at full width through ServingEngine,
    all requests on the kernel path and the first RWKV_PLAIN_REQUESTS on
    the plain path; rwkv6_scan launched once per layer of every prefill
    and of every decode step. Returns its launches."""
    scan_rounding_sensitivity(model, device, RWKV_PLAIN_REQUESTS)
    return serve_both_paths(
        model, device,
        {"rwkv6_scan": lambda st: model[0].num_layers * (
            st["prefills"] + st["decode_steps"])},
        RWKV_PLAIN_REQUESTS, RWKV_FIRST_LOGIT_TOL)["rwkv6_scan"]


def main_path_slice5(device, model) -> dict:
    """Phase 8: mixtral-8x22b (MIXTRAL_CUT) serving at full width through
    ServingEngine, all requests on the kernel and the plain path;
    moe_dispatch launched once per layer of every prefill and decode step,
    flash_attention once per layer of every prefill. Returns their
    launches."""
    cfg, params = model
    # a decode step computes every expert over its capacity's padded
    # slots, so it reads every weight but the embedding table once, and
    # the whole cache of every layer
    n_bytes = sum(t.numel() * t.element_size()
                  for t in tree_tensors(params)) - (
        params["tok_embed"].numel() * params["tok_embed"].element_size())
    n_bytes += (cfg.num_layers * 2 * SERVE_SLOTS * SERVE_CACHE_LEN
                * cfg.num_kv_heads * cfg.head_dim * 2)
    print(f"{cfg.name} decode floor: {n_bytes} B read per step (every "
          f"weight but the embedding table, and the bf16 KV cache) at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s: "
          f"{n_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms per step")
    n = cfg.num_layers
    return serve_both_paths(
        model, device,
        {"moe_dispatch": lambda st: n * (st["prefills"] + st["decode_steps"]),
         "flash_attention": lambda st: n * st["prefills"]},
        SERVE_REQUESTS, FIRST_LOGIT_TOL, mixtral_first_token_logits,
        profile_plain=True, turns=True)


def flash_attention_error(q, k, v, kind, window) -> tuple:
    """B4 against its plain version on one call: (max |difference|, its
    largest ratio to the tolerance, whether B4's output is finite). The
    tolerance: FA_TOL, and in bf16 also one unit in the output's last
    place."""
    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    got = ops.flash_attention_cuda(q, k, v, kind=kind, window=window)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, kind=kind, window=window).float()
    diff = (got.float() - want).abs()
    if q.dtype == torch.bfloat16:
        tol = torch.clamp(bf16_ulp(want), min=FA_TOL["bfloat16"])
    else:
        tol = FA_TOL["float32"]
    return (float(diff.max()), float((diff / tol).max()),
            bool(torch.isfinite(got).all()))


def attention_reading(label, q, k, v, kind, window, plain=True) -> dict:
    """Phase 2's reading at a new shape: B4 held to its plain version,
    then device ms in turns (each timed twice, the order reversed the
    second time) of the kernel, the plain version (unless ``plain`` is
    False) and F.scaled_dot_product_attention, beside the bound. Returns
    the mean ms by name, the bound and its error."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    err, ratio, finite = flash_attention_error(q, k, v, kind, window)
    if not (ratio <= 1 and finite):
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version at {label}: {err}")
    lib, how = sdpa_call(q, k, v, kind, window)
    fns = {"kernel": lambda: ops.flash_attention_cuda(
               q, k, v, kind=kind, window=window),
           "plain": lambda: flash_attention_ref(q, k, v, kind=kind,
                                                window=window),
           f"SDPA ({how})": lib}
    if not plain:
        del fns["plain"]
    turns = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            turns[name].append(graph_ms(fns[name], repeats=10, samples=11))
    ms = {name: sum(t) / len(t) for name, t in turns.items()}
    bound_ms, bound_by = attention_bound(q, k, kind, window)
    print(f"flash_attention at {label} ({kind} window {window}, q "
          f"{tuple(q.shape)}, k {tuple(k.shape)}: {q.shape[2] // k.shape[2]} "
          f"query heads per KV head of {q.shape[3]}, {q.dtype}): max_abs_err "
          f"{err} vs plain, {ratio} of the tolerance; in turns "
          + "; ".join(f"{name} {t[0]:.6f} / {t[1]:.6f} ms"
                      for name, t in turns.items())
          + f"; bound {bound_ms:.6f} ms ({bound_by}); the kernel at "
          f"{bound_ms / ms['kernel']:.4f} of its bound, "
          f"{ms['kernel'] / ms[f'SDPA ({how})']:.3f}x SDPA, "
          + (f"{ms['plain'] / ms['kernel']:.2f}x faster than plain"
             if plain else "plain not timed (its f32 scores)")
          + f" (kernels of SDPA: {cuda_kernel_names(lib)})")
    return dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by, err=err,
                sdpa=f"SDPA ({how})")


def slice9_run(model, device, impl, reqs, extras) -> dict:
    """One serving run of ``reqs`` with ``extras``, the launch counts set
    to 0 just before it and read just after, and each prefill's
    first-token logits kept: {stats, outputs, first (by rid), wall,
    launches}. The engine (and its cache) is dropped before returning."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.serve import ServeConfig, ServingEngine

    cfg, params = model
    first = []
    original = M.prefill

    def recording(*args, **kw):
        out = original(*args, **kw)
        first.append(out[0][0, -1])
        return out

    eng = ServingEngine(cfg, ServeConfig(batch_slots=SERVE_SLOTS,
                                         cache_len=SERVE_CACHE_LEN),
                        params, device=device, kernel_impl=impl)
    torch.cuda.synchronize()
    reset_launches()
    M.prefill = recording
    try:
        t0 = time.perf_counter()
        done = eng.run(reqs, extras)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        M.prefill = original
    launches = {k: m.launches for k, m in kernel_ops().items()}
    stats = eng.stats
    del eng
    if len(first) != len(reqs):
        raise AssertionError(f"{len(first)} prefills for {len(reqs)} "
                             f"requests")
    # all requests fit, so the planner admits them in submission order
    return dict(stats=stats, outputs={r.rid: r.output for r in done},
                first={r.rid: lg.float() for r, lg in zip(reqs, first)},
                wall=wall, launches=launches, n=len(reqs),
                done=len(done), tokens=sum(len(r.output) for r in done),
                prompt=sum(len(r.prompt) for r in done))


def attention_rounding_sensitivity(model, device, reqs, extras,
                                   base) -> float:
    """How far the kernel path's first-token logits (``base``, by rid)
    move when only B4's outputs move, each by one bf16 unit up or down
    (random, from SEED): the yardstick for the first-token tolerance.
    Checks nothing itself."""
    import torch

    from repro_torch.models import layers
    from repro_torch.models import model as M

    cfg, params = model
    original = layers.flash_attention
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)

    def nudged(q, k, v, *, kind, window):
        o = original(q, k, v, kind=kind, window=window).float()
        up = torch.randint(0, 2, o.shape, generator=gen, device=o.device,
                           dtype=torch.bool)
        step = bf16_ulp(o)
        return (o + torch.where(up, step, -step)).to(q.dtype)

    worst = 0.0
    for req in reqs:
        prompt = torch.as_tensor(req.prompt, dtype=torch.long,
                                 device=device)[None]
        layers.flash_attention = nudged
        try:
            moved, _ = M.prefill(params, cfg, prompt, extras,
                                 kernel_impl="auto")
        finally:
            layers.flash_attention = original
        worst = max(worst, float((base[req.rid]
                                  - moved[0, -1].float()).abs().max()))
    return worst


def f32_paths_agree(model, device, req, extras) -> None:
    """The model in float32 (B4's f32 kernel on the kernel path): the
    kernel and the plain path's first-token logits on ``req`` within
    SLICE9_F32_TOL, where bf16 rounding no longer hides a difference."""
    import dataclasses

    import torch

    from repro_torch.models import model as M

    cfg, params = model

    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        if isinstance(t, list):
            return [f32(v) for v in t]
        return t.float()

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32, extras32 = f32(params), f32(extras)
    prompt = torch.as_tensor(req.prompt, dtype=torch.long,
                             device=device)[None]
    logits = [M.prefill(params32, cfg32, prompt, extras32,
                        kernel_impl=impl)[0][0, -1] for impl in ("auto", "jnp")]
    diff = float((logits[0] - logits[1]).abs().max())
    print(f"{cfg.name} in float32, first-token logits of request {req.rid} "
          f"({len(req.prompt)} tokens), kernel vs plain path: max "
          f"|difference| {diff} (tolerance {SLICE9_F32_TOL}; largest |logit| "
          f"{float(logits[1].abs().max())})")
    if not diff <= SLICE9_F32_TOL:
        raise AssertionError(f"{cfg.name} in float32: first-token logits "
                             f"differ by {diff} > {SLICE9_F32_TOL}")


def check_serving_run(label, cfg, impl, run, lens, want) -> None:
    """One of ``slice9_run``'s runs printed and held: every request
    answered in one prefill each, the launches ``want(stats)`` gives on
    the kernel path (every other kernel's 0) and none on the plain path,
    each output inside the vocabulary and the token budget, and its first
    token the argmax of its prefill's finite logits."""
    import torch

    st = run["stats"]
    expect = {k: 0 for k in run["launches"]}
    if impl == "auto":
        expect.update(want(st))
    print(f"{label} serving kernel_impl={impl} ({SERVE_SLOTS} slots of "
          f"{SERVE_CACHE_LEN}): {run['done']} of {run['n']} requests "
          f"answered, {run['tokens']} tokens in {run['wall']:.3f} s "
          f"({run['tokens'] / run['wall']:.2f} tokens/s); prefill "
          f"{st['prefill_s'] / st['prefills'] * 1e3:.3f} ms per request "
          f"({st['prefills']} prompts of {lens[0]}-{lens[1]} tokens, "
          f"{run['prompt']} in all), decode "
          f"{st['decode_s'] / st['decode_steps'] * 1e3:.3f} ms per step "
          f"({st['decode_steps']} steps); launches {run['launches']}")
    if (run["done"] != run["n"] or st["prefills"] != run["n"]
            or run["launches"] != expect):
        raise AssertionError(f"{label} kernel_impl={impl}: {run['done']} "
                             f"answered, {st['prefills']} prefills, "
                             f"launches {run['launches']}, want {expect}")
    for rid, out in run["outputs"].items():
        if not (1 <= len(out) <= SLICE9_NEW_TOKENS
                and all(0 <= t < cfg.vocab_size for t in out)
                and bool(torch.isfinite(run["first"][rid]).all())
                and int(torch.argmax(run["first"][rid])) == out[0]):
            raise AssertionError(f"{label} kernel_impl={impl} request "
                                 f"{rid}: output {out}, or its first token "
                                 f"is not its logits' argmax")


def slice9_cell(arch, n_req, lens, n_plain, device) -> int:
    """One arch's serving cell at its published width (random weights
    from SEED; extras from SEED; llama-3.2-vision's gates set to
    CROSS_GATE_OPEN): phase 2's reading at its new shape where
    SLICE9_READINGS names it, all ``n_req`` requests on the kernel path
    and the first ``n_plain`` on the plain path, B4 launched once per
    self-attention layer (encoder included) of every prefill on the
    kernel path and never on the plain path, every other kernel never;
    first-token logits within SLICE9_LOGIT_TOL beside how far B4's
    rounding moves them; a profile where SLICE9_PROFILED names it.
    Returns B4's launches on the kernel path."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import check_fits
    from repro_torch.models import model as M
    from repro_torch.models import transformer as TF

    # the launcher's check, before allocating: the weights and the
    # serving cache fit the card's free memory (qwen3-32b: 65.5 + 8.6 GB)
    check_fits(get_config(arch), torch.cuda.mem_get_info()[0], SERVE_SLOTS,
               SERVE_CACHE_LEN)
    model = full_model(arch, device)
    cfg, params = model
    gates = [p["cross_gate"] for p in params["layers"] if "cross_gate" in p]
    for g in gates:
        g.fill_(CROSS_GATE_OPEN)
    if gates:
        print(f"{arch}: cross_gate set to {CROSS_GATE_OPEN} in all "
              f"{len(gates)} cross layers (tanh {math.tanh(CROSS_GATE_OPEN):.4f}"
              f"), for both paths: at its init of 0 the cross layers add "
              f"exactly 0")
    extras = M.random_extras(cfg, 1, SEED, device)
    if arch in SLICE9_READINGS:
        seq = SLICE9_READINGS[arch]
        calls = capture_attention(cfg, params, seq, device)
        errs = [flash_attention_error(*c) for c in calls]
        print(f"flash_attention: the {len(calls)} layers of a real "
              f"{seq}-token {arch} prefill: max_abs_err "
              f"{max(e for e, _r, _f in errs)}, at most "
              f"{max(r for _e, r, _f in errs)} of the tolerance")
        if not all(r <= 1 and f for _e, r, f in errs):
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version on {arch}'s layers")
        attention_reading(f"{arch} layer 0 of a real {seq}-token prefill",
                          *calls[0])
        del calls
    per_prefill = (sum(TF.has_self_attention(s) for s in TF.layer_specs(cfg))
                   + cfg.encoder_layers)

    def requests():
        return serve_requests(cfg, n=n_req, lens=lens,
                              new_tokens=SLICE9_NEW_TOKENS)

    runs = {"auto": slice9_run(model, device, "auto", requests(), extras),
            "jnp": slice9_run(model, device, "jnp", requests()[:n_plain],
                              extras)}
    for impl, run in runs.items():
        check_serving_run(cfg.name, cfg, impl, run, lens, lambda st: {
            "flash_attention": per_prefill * st["prefills"]})
    k, j = runs["auto"], runs["jnp"]
    worst = max(float((k["first"][rid] - j["first"][rid]).abs().max())
                for rid in j["first"])
    scale = max(float(lg.abs().max()) for lg in j["first"].values())
    moved = attention_rounding_sensitivity(model, device,
                                           requests()[:n_plain], extras,
                                           k["first"])
    same = sum(k["outputs"][rid][0] == j["outputs"][rid][0]
               for rid in j["outputs"])
    tol = SLICE9_LOGIT_TOL.get(arch, FIRST_LOGIT_TOL)
    print(f"{arch} first-token logits, kernel vs plain path, over the "
          f"{n_plain} prompts both served: max |difference| {worst} "
          f"(tolerance {tol}; largest |logit| {scale}); {same} of {n_plain} "
          f"first tokens agree; the kernel path against itself with B4's "
          f"outputs moved by one bf16 unit: max |difference| {moved}")
    if not worst <= tol:
        raise AssertionError(f"{arch}: first-token logits differ by {worst} "
                             f"> {tol}")
    if arch in SLICE9_LOGIT_TOL:
        f32_paths_agree(model, device, requests()[0], extras)
    if arch in SLICE9_PROFILED:
        n = SLICE9_PROFILED[arch]
        wall = slice9_run(model, device, "auto", requests()[:n],
                          extras)["wall"]
        profile_share(f"{arch} serving, kernel path, the first {n} "
                      f"requests",
                      lambda: slice9_run(model, device, "auto",
                                         requests()[:n], extras)["wall"],
                      wall, ("flash_attention",))
    launches = k["launches"]["flash_attention"]
    del model, params, gates, extras, runs, k, j
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main_path_slice9(device) -> int:
    """Phase 13: the other archs' serving (SLICE9_CELLS), each at its
    published width through ServingEngine on the kernel and the plain
    path, one model on the card at a time. Returns B4's launches on the
    kernel paths."""
    import torch

    total = 0
    for cell in SLICE9_CELLS:
        t0 = time.time()
        torch.cuda.reset_peak_memory_stats()
        total += slice9_cell(*cell, device)
        print(f"{cell[0]} cell: {time.time() - t0:.3f} s, peak card memory "
              f"{torch.cuda.max_memory_allocated()} B")
    return total


def profile_steps(name, paths: dict, workload, device, warm: int = 100,
                  timed: int = 200, profiled: int = 20,
                  watch: str | None = None) -> None:
    """Where a full-width step's time goes, for each path of one cell
    (``paths``: label -> engine kwargs, e.g. the kernel and the plain
    path), in two columns: the eager step as the host issues it (one
    read of ``r`` per step), and the path's K = 1 graph (its cached
    runner, the one ``run_simulation`` replays: one replay and one read
    of ``r`` per step), started from the eager state after the warm-up.
    Wall ms per step timed in turns (every column in order, then in
    reverse, three times, each column's state carried on, so all cover
    the same rounds; the host's rate drifts within a call); then under
    torch.profiler the CUDA kernels per step (under replay CUPTI
    reports each kernel node of the graph), their device ms per step
    and the top kernels by device time; with ``watch``, the launches per
    step of the kernels whose names hold it. Returns label -> (wall ms,
    CUDA kernels, device ms) a step; a path's graph column is labelled
    "<label> graph K=1"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine, sweep
    from repro_torch.core.convert import plan_from_numpy

    r_end = torch.tensor(SIM_FULL["max_rounds"], dtype=torch.int32,
                         device=device)
    runs = {}
    for label, eng_kw in paths.items():
        cfg = engine.EngineConfig(**eng_kw, **SIM_FULL)
        plan = engine.make_plan(cfg, workload)
        meta = engine.plan_meta(cfg, plan)
        p = plan_from_numpy(engine.plan_device(cfg, plan), device)
        s = sweep._initial_state(cfg, plan, meta, device)
        step = sweep._build_step(cfg, meta, device)
        # the stamp rebase of the packed lock-table engine's dispatch
        rebase = cfg.state_layout == "packed" and not cfg.is_batch_planned
        runs[label] = dict(p=p, s=s, step=step, rebase=rebase, cfg=cfg,
                           meta=meta)

    def run(label, n):
        st = runs[label]
        if "g" in st:
            for _ in range(n):
                st["g"].replay()
                int(st["g"].state["r"])
            return
        for _ in range(n):
            st["s"] = st["step"](
                st["p"], engine.rebase_enq(st["s"]) if st["rebase"]
                else st["s"], r_end)
            int(st["s"]["r"])

    def wall(label):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(label, timed)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / timed * 1e3

    for label in paths:
        run(label, warm)
    for label in paths:
        st = runs[label]
        runner = sweep.get_runner(st["cfg"], st["meta"], device)
        # loads the eager state into the graph's buffers, replays none
        g = graph_of(runner, runner(st["p"], st["s"], int(st["s"]["r"])))
        g.r_end.fill_(SIM_FULL["max_rounds"])
        runs[f"{label} graph K=1"] = dict(g=g)
        run(f"{label} graph K=1", 8)
    walls = in_turns({label: label for label in runs}, wall, rounds=3)
    readings_of = {}
    for label in runs:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(label, profiled)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        n_kernels = sum(e.count for e in kern) / profiled
        dev_ms = sum(e.self_device_time_total for e in kern) / profiled / 1e3
        if n_kernels <= 0:
            raise AssertionError(f"{name} {label}: the profiler saw no CUDA "
                                 f"kernel")
        readings, wall_ms = walls[label]
        readings_of[label] = (wall_ms, n_kernels, dev_ms)
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
        watched = ""
        if watch:
            n_watch = sum(e.count for e in kern if watch in e.key) / profiled
            watched = f", {watch} {n_watch:.2f} launches/step"
        state = runs[label]["g"].state if "g" in runs[label] else (
            runs[label]["s"])
        print(f"profile {name} {label} (rounds {int(state['r'])}"
              f"): wall {wall_ms:.4f} ms/step (turns "
              f"{' / '.join(f'{w:.4f}' for w in readings)}), "
              f"{n_kernels:.1f} CUDA kernels/step, device {dev_ms:.4f} "
              f"ms/step, device busy share {dev_ms / wall_ms:.4f}{watched}; "
              f"top "
              f"kernels: " + "; ".join(
                  f"{e.key[:60]} {e.self_device_time_total / profiled:.1f} "
                  f"us ({e.count / profiled:.2f}/step)" for e in top))
    return readings_of


def legacy_cell(name, eng_kw, workload, sim, device) -> dict:
    """One LEGACY_CELLS cell through ``run_simulation`` on the legacy
    layout and on the packed engine's kernel path: equal fingerprints,
    no metrics on the legacy run, no B1 or B2 launch in it, one a step
    in the packed run where its path has the kernel. Returns the legacy
    run and the packed run's launches by kernel."""
    from repro_torch.kernels import use_kernel

    ops = kernel_ops()
    names = ("lock_grant", "dep_wavefront")
    before = {n: ops[n].launches for n in names}
    legacy = run_cell(f"legacy {name}", dict(eng_kw, state_layout="legacy"),
                      workload, device, sim=sim,
                      deadlock_aborts=name in DL_PROTOCOLS)
    moved = {n: ops[n].launches - before[n] for n in names}
    if any(moved.values()) or legacy.metrics is not None:
        raise AssertionError(f"legacy {name}: kernel launches {moved}, "
                             f"metrics {legacy.metrics}")
    before = {n: ops[n].launches for n in names}
    packed = run_cell(f"packed {name}", eng_kw, workload, device, sim=sim,
                      deadlock_aborts=name in DL_PROTOCOLS)
    launched = {n: ops[n].launches - before[n] for n in names}
    kernel = ("lock_grant" if eng_kw["protocol"] == "orthrus" else
              "dep_wavefront" if eng_kw["protocol"] in ("dgcc", "quecc")
              else None) if use_kernel("auto", device) else None
    steps = packed.raw["steps_executed"]
    want = {n: steps if n == kernel else 0 for n in names}
    if launched != want:
        raise AssertionError(f"packed {name}: launches {launched}, want "
                             f"{want}")
    got, ref = fingerprint(legacy), fingerprint(packed)
    if got != ref:
        diff = {k: (got[k], ref.get(k)) for k in got if got[k] != ref.get(k)}
        raise AssertionError(f"legacy {name} differs from packed: {diff}")
    full = json.dumps(got, sort_keys=True)
    print(f"legacy {name}: fingerprint identical to the packed engine's "
          f"(sha256 {hashlib.sha256(full.encode()).hexdigest()[:16]}; "
          f"commits {got['commits']}, aborts_deadlock "
          f"{got['aborts_deadlock']}, steps {got['steps_executed']}); "
          f"launches legacy {moved}, packed {launched}")
    return dict(legacy=legacy, launched=launched)


def latency_oracle(name, eng_kw, workload, epoch, device) -> None:
    """The dense-replay latency oracle of ``tools/torch_trace_export.py``
    on the card, checked as tests/test_metrics.py:226-271 does, and the
    cell's Chrome trace written under chiprun_out/."""
    import numpy as np

    from repro_torch.core import engine, metrics
    from tools.torch_trace_export import chrome_trace, replay_dense, txn_events

    cfg = engine.EngineConfig(**eng_kw, **ORACLE_SIM)
    res = run_cell(f"oracle {name}", eng_kw, workload, device,
                   sim=ORACLE_SIM, deadlock_aborts=None)
    t0 = time.time()
    snaps, _state = replay_dense(cfg, workload, device=device)
    replay_s = time.time() - t0
    events = txn_events(snaps)
    if not (len(events) == res.commits > 0):
        raise AssertionError(f"oracle {name}: {len(events)} events for "
                             f"{res.commits} commits")
    # the round each tid first occupies a slot after: its admission round
    tid_row = engine.C_TID
    admit = {}
    for r in range(len(snaps) - 1):
        newly = set(snaps[r + 1][tid_row][snaps[r + 1][tid_row] >= 0]) - set(
            snaps[r][tid_row][snaps[r][tid_row] >= 0])
        for tid in newly:
            admit.setdefault(int(tid), r)
    lats, queued = [], 0
    for tid, stamp, commit_r in events:
        want = admit[tid] if epoch is None else (tid // epoch[0]) * epoch[1]
        if stamp != want:
            raise AssertionError(f"oracle {name}: txn {tid} stamped "
                                 f"{stamp}, arrival {want}")
        queued += admit[tid] > want
        lats.append(commit_r - want)
    lats = np.asarray(lats)
    hist = np.bincount(metrics.bucket_index(lats),
                       minlength=metrics.LAT_BUCKETS)
    carried = [int(x) for x in res.metrics.lat_hist]
    if np.any(lats < 0) or hist.tolist() != carried:
        raise AssertionError(f"oracle {name}: exact histogram "
                             f"{hist.tolist()} against {carried}")
    edges = metrics.bucket_edges()
    srt = np.sort(lats)
    for q, got in ((0.5, res.metrics.p50), (0.99, res.metrics.p99),
                   (0.999, res.metrics.p999)):
        rank = max(int(np.ceil(q * len(lats))), 1)
        want = int(edges[metrics.bucket_index(srt[rank - 1])])
        if got != want:
            raise AssertionError(f"oracle {name}: p{q * 100:g} {got}, the "
                                 f"exact rank statistic's edge {want}")
    trace = chrome_trace(snaps, cfg)
    out = ROOT / "chiprun_out" / f"phase14_{name}.trace.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(traceEvents=trace, displayTimeUnit="ms")))
    print(f"oracle {name}: {len(events)} commit events = commits, every "
          f"arrival stamp as worked out ({queued} txns queued past their "
          f"arrival), exact histogram = lat_hist, p50 {res.metrics.p50} / "
          f"p99 {res.metrics.p99} / p999 {res.metrics.p999} rounds = the "
          f"exact ranks' bucket edges (exact p50 {int(srt[len(srt) // 2])}, "
          f"max {int(srt[-1])}); dense replay of {len(snaps) - 1} rounds in "
          f"{replay_s:.3f} s ({(len(snaps) - 1) / replay_s:.1f} rounds/s, "
          f"one graph replay a round); Chrome trace {len(trace)} events, "
          f"{out.stat().st_size} bytes, {out.relative_to(ROOT)}")


def main_path_slice10(device) -> dict:
    """Phase 14: the legacy state layout and the latency oracle at the
    paper's width. Returns the packed runs' lock_grant and dep_wavefront
    launches."""
    wls = {}
    for _n, _e, wl_kw, _s in LEGACY_CELLS:
        key = json.dumps(wl_kw, sort_keys=True)
        if key not in wls:
            wls[key] = make_full_workload(wl_kw)
    for _n, _e, wl_kw, _ep in ORACLE_CELLS:
        key = json.dumps(wl_kw, sort_keys=True)
        if key not in wls:
            wls[key] = make_full_workload(wl_kw)

    def wl_of(wl_kw):
        return wls[json.dumps(wl_kw, sort_keys=True)]

    reset_launches()
    counts = {"lock_grant": 0, "dep_wavefront": 0}
    legacy = {}
    for name, eng_kw, wl_kw, sim in LEGACY_CELLS:
        out = legacy_cell(name, eng_kw, wl_of(wl_kw), sim, device)
        legacy[name] = out["legacy"]
        for n, v in out["launched"].items():
            counts[n] += v
    # K-fused dispatch on the legacy layout: guarded inner steps, no
    # stamp rebase
    ops = kernel_ops()
    before = ops["lock_grant"].launches + ops["dep_wavefront"].launches
    k8 = run_cell("legacy orthrus K=8", dict(ORTHRUS_FULL,
                                              state_layout="legacy"),
                  wl_of(YCSB_FULL), device, sim=SIM_K,
                  rounds_per_dispatch=K_FUSED)
    skip = {"wall_s_group"}
    one = legacy["orthrus"]
    if fingerprint(k8) != fingerprint(one) or {
            k: v for k, v in k8.raw.items() if k not in skip} != {
            k: v for k, v in one.raw.items() if k not in skip} or (
            ops["lock_grant"].launches + ops["dep_wavefront"].launches
            != before):
        raise AssertionError("legacy orthrus at K = 8 differs from K = 1, "
                             "or launched a kernel")
    print(f"legacy orthrus K={K_FUSED}: fingerprint and counters identical "
          f"to K=1, no kernel launch")
    for name, eng_kw, wl_kw, epoch in ORACLE_CELLS:
        latency_oracle(name, eng_kw, wl_of(wl_kw), epoch, device)
    print(f"slice 10 path: kernel launches {counts} (the packed runs; the "
          f"legacy runs none)")
    for name, eng_kw, wl_kw, _sim in LEGACY_CELLS:
        if name not in LEGACY_PROFILED:
            continue
        got = profile_steps(f"legacy vs packed {name}", {
            "legacy": dict(eng_kw, state_layout="legacy"),
            "packed kernel path": eng_kw}, wl_of(wl_kw), device, timed=100)
        lg, pk = got["legacy graph K=1"], got["packed kernel path graph K=1"]
        print(f"legacy vs packed {name}, graph K=1 per step: wall "
              f"{lg[0]:.4f} / {pk[0]:.4f} ms (legacy/packed "
              f"{lg[0] / pk[0]:.4f}), CUDA kernels {lg[1]:.1f} / "
              f"{pk[1]:.1f}, device {lg[2]:.4f} / {pk[2]:.4f} ms "
              f"(legacy/packed {lg[2] / pk[2]:.4f})")
    return counts


def llama4_captures(model, extras, device) -> dict:
    """The kernel path's inputs at every layer of llama4-maverick (the
    cut): B4's (q, k, v, kind, window) and B3's plan's (router
    probabilities, top_k, capacity) of one LLAMA4_CHECK_SEQ-token prefill
    with the early-fusion prefix, and B3's of one decode step at
    SERVE_SLOTS slots (after prefills of the first 8 prompts)."""
    import numpy as np
    import torch

    from repro_torch.models import layers
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models import transformer as TF
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    cfg, params = model
    prompt = np.random.default_rng(SEED + 1).integers(
        2, cfg.vocab_size, LLAMA4_CHECK_SEQ)

    def prefill():
        M.prefill(params, cfg, torch.as_tensor(prompt, device=device)[None],
                  extras, kernel_impl="auto")

    def decode_step():
        eng = ServingEngine(cfg, ServeConfig(batch_slots=SERVE_SLOTS,
                                             cache_len=SERVE_CACHE_LEN),
                            params, device=device, kernel_impl="auto")
        eng.run([Request(rid=r.rid, prompt=r.prompt, max_new_tokens=2)
                 for r in serve_requests(cfg)[:SERVE_SLOTS]], extras)

    def every(*_args):
        return True

    def at_decode(x, *_args):
        return x.shape[0] == SERVE_SLOTS

    attn, probs = capture_calls(
        [(layers, "flash_attention", every),
         (moe, "moe_dispatch_plan", every)], prefill)
    dec_probs, = capture_calls(
        [(moe, "moe_dispatch_plan", at_decode)], decode_step)
    specs = TF.layer_specs(cfg)
    want = dict(attn=sum(TF.has_self_attention(s) for s in specs),
                probs=sum(s.is_moe for s in specs))
    want["dec_probs"] = want["probs"]
    out = dict(attn=attn, probs=probs, dec_probs=dec_probs)
    for name, calls in out.items():
        if len(calls) != want[name]:
            raise AssertionError(f"{cfg.name} capture {name}: {len(calls)} "
                                 f"calls, not {want[name]}")
    print(f"{cfg.name} captures: a {LLAMA4_CHECK_SEQ}-token prefill with "
          f"its {cfg.early_fusion_tokens}-row early-fusion prefix (B3's "
          f"plan over probabilities {tuple(probs[0][0].shape)}, top "
          f"{probs[0][1]}, capacity {probs[0][2]}, {len(probs)} MoE layers; "
          f"B4 q {tuple(attn[0][0].shape)}, k {tuple(attn[0][1].shape)}, "
          f"kinds {[c[3] for c in attn]}) and a decode step at "
          f"{SERVE_SLOTS} slots (probabilities "
          f"{tuple(dec_probs[0][0].shape)}, capacity {dec_probs[0][2]})")
    return out


def llama4_b4_readings(calls) -> float:
    """B4 held to its plain version on every layer of the real prefill,
    and read (phase 2's reading) at its chunked layer 0, where the
    8,192-token chunk does not bind at LLAMA4_CHECK_SEQ, and at its global
    NoPE layer. Returns the largest error."""
    errs = [flash_attention_error(*c) for c in calls]
    print(f"flash_attention: the {len(calls)} layers of a real "
          f"{LLAMA4_CHECK_SEQ}-token {LLAMA4} prefill: max_abs_err "
          f"{max(e for e, _r, _f in errs)}, at most "
          f"{max(r for _e, r, _f in errs)} of the tolerance")
    if not all(r <= 1 and f for _e, r, f in errs):
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version on {LLAMA4}'s layers")
    for kind, what in (("chunked", "chunked-local"), ("full", "global NoPE")):
        i = next(i for i, c in enumerate(calls) if c[3] == kind)
        attention_reading(f"{LLAMA4} {what} layer {i} of a real "
                          f"{LLAMA4_CHECK_SEQ}-token prefill", *calls[i])
    return max(e for e, _r, _f in errs)


def llama4_b3_readings(caps, power) -> float:
    """B3 at llama4's shape (E 128, top 1): the fused plan bit-equal to the
    plain plan on every MoE layer of the real prefill and decode step,
    timed in turns against the plain plan; the grouped launch at
    GROUP_COUNTS on the prefill's first MoE layer cut into shards (the
    shards' capacity), and at LLAMA4_SHARDS on the decode step's, held
    bit for bit and timed in turns against as many one-plan launches and
    the plain version, beside the bound. Returns the largest error (0)."""
    from repro_torch.kernels.moe_dispatch import ops
    from repro_torch.kernels.moe_dispatch.ref import (
        moe_dispatch_plan_grouped_ref,
    )
    from repro_torch.models import moe

    err = 0.0
    for name, key in ((f"the {LLAMA4_CHECK_SEQ}-token prefill", "probs"),
                      (f"the decode step at {SERVE_SLOTS} slots",
                       "dec_probs")):
        calls = caps[key]
        e = max(hold_plan(f"{LLAMA4} {name}, MoE layer {i}", *c)
                for i, c in enumerate(calls))
        err = max(err, e)
        probs, top_k, capacity = calls[0]
        E = probs.shape[1]
        res = in_turns({
            "fused launch": lambda: ops.moe_dispatch_plan_cuda(
                probs, top_k=top_k, capacity=capacity),
            "plain plan": lambda: moe.plan_dispatch(probs, top_k, capacity),
        }, graph_ms)
        print_turns(f"moe_dispatch plan, device time (graph replay), "
                    f"{LLAMA4} first MoE layer of {name}", res)
        bound_ms, bound_by, n_bytes = plan_bound(probs.shape[0], E, top_k,
                                                 capacity)
        ms = res["fused launch"][1]
        print(f"moe_dispatch fused plan, {LLAMA4} {name} (N "
              f"{probs.shape[0]}, E {E}, top {top_k}, capacity {capacity}; "
              f"{power}): the {len(calls)} MoE layers bit-equal to "
              f"plan_dispatch's (max_abs_err {e}); {ms:.6f} ms, bound "
              f"{bound_ms:.9f} ms ({bound_by}, {n_bytes} B), at "
              f"{bound_ms / ms:.6f} of its bound; plain plan "
              f"{res['plain plan'][1]:.6f} ms")
        counts = GROUP_COUNTS if key == "probs" else (LLAMA4_SHARDS,)
        for G in counts:
            n_loc = probs.shape[0] // G
            cap = moe.capacity_for(n_loc, top_k, E, 1.25, floor=32)
            err = max(err, hold_grouped(f"{LLAMA4} {name}", probs, G, top_k,
                                        cap))
            pg = probs.view(G, n_loc, E)

            def singles(pg=pg, cap=cap):
                for g in range(pg.shape[0]):
                    ops.moe_dispatch_plan_cuda(pg[g], top_k=top_k,
                                               capacity=cap)

            res = in_turns({
                "grouped launch": lambda pg=pg, cap=cap:
                    ops.moe_dispatch_plan_cuda(pg, top_k=top_k,
                                               capacity=cap),
                f"{G} one-plan launches": singles,
                "plain (per group)": lambda pg=pg, cap=cap:
                    moe_dispatch_plan_grouped_ref(pg, top_k, cap),
            }, graph_ms)
            bound_ms, bound_by, n_bytes = plan_bound(n_loc, E, top_k, cap,
                                                     groups=G)
            ms = res["grouped launch"][1]
            print_turns(f"moe_dispatch grouped plan, G={G} (n {n_loc}, E "
                        f"{E}, top {top_k}, capacity {cap}), {LLAMA4} "
                        f"{name}", res)
            print(f"moe_dispatch grouped plan, {LLAMA4} {name}, G={G}: "
                  f"bit-equal to each group's plain plan; {ms:.6f} ms "
                  f"against {G} one-plan launches' "
                  f"{res[f'{G} one-plan launches'][1]:.6f} ms and the plain "
                  f"version's {res['plain (per group)'][1]:.6f} ms; bound "
                  f"{bound_ms:.9f} ms ({bound_by}, {n_bytes} B), at "
                  f"{bound_ms / ms:.6f} of it ({power})")
    if err:
        raise AssertionError(f"moe_dispatch disagrees with its plain version "
                             f"at {LLAMA4}'s shape (max_abs_err {err})")
    return err


def llama4_first_token_logits(model, device, reqs, extras, runs) -> None:
    """The first-token logits of ``reqs`` (the plain path's requests), held
    as mixtral's are: the kernel path with the plain plan in B3's place
    bit-identical (B3 is exact); the plain path with the kernel path's
    plans (routing and drops held fixed) within FIRST_LOGIT_TOL, printed
    beside how far one bf16 unit of B4's outputs moves the kernel path's;
    both paths free-running, each with its own routing, their difference
    printed beside the share of (token, MoE layer) top-1 choices they
    agree on (no floor is held: no reading has shown one yet)."""
    import torch

    from repro_torch.models import model as M

    cfg, params = model

    def first(prompt, impl):
        lg, _ = M.prefill(params, cfg, prompt, extras, kernel_impl=impl)
        lg = lg[0, -1].float()
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"kernel_impl={impl}: non-finite logits")
        return lg

    forced = free = scale = 0.0
    agree = routed = 0
    base = {}
    for req in reqs:
        prompt = torch.as_tensor(req.prompt, dtype=torch.long,
                                 device=device)[None]
        kern, plain = [], []
        with planner("moe_dispatch_plan", recording(kern)):
            lg_kern = first(prompt, "auto")
        with planner("moe_dispatch_plan", plain_plan):
            lg_b3_plain = first(prompt, "auto")
        with planner("plan_dispatch", replaying(kern)):
            lg_forced = first(prompt, "jnp")
        with planner("plan_dispatch", recording(plain)):
            lg_free = first(prompt, "jnp")
        for impl, lg in (("auto", lg_kern), ("jnp", lg_free)):
            if int(torch.argmax(lg)) != runs[impl]["outputs"][req.rid][0]:
                raise AssertionError(f"{LLAMA4} request {req.rid} "
                                     f"kernel_impl={impl}: the engine's "
                                     f"first token is not the prefill's "
                                     f"argmax")
        if not torch.equal(lg_kern, lg_b3_plain):
            raise AssertionError(f"{LLAMA4} request {req.rid}: the kernel "
                                 f"path's logits change when the plain plan "
                                 f"takes B3's place")
        base[req.rid] = lg_kern
        forced = max(forced, float((lg_forced - lg_kern).abs().max()))
        free = max(free, float((lg_free - lg_kern).abs().max()))
        scale = max(scale, float(lg_kern.abs().max()))
        for (_p, c_k, _c), (_q, c_p, _d) in zip(kern, plain):
            agree += int((c_k == c_p).all(-1).sum())
            routed += c_k.shape[0]
    moved = attention_rounding_sensitivity(model, device, reqs, extras, base)
    print(f"{LLAMA4} first-token logits over the {len(reqs)} prompts "
          f"(largest |logit| {scale}): the kernel path with the plain plan "
          f"in B3's place bit-identical; the plain path with the kernel "
          f"path's plans: max |difference| {forced} (tolerance "
          f"{FIRST_LOGIT_TOL}); the kernel path against itself with B4's "
          f"outputs moved by one bf16 unit: {moved}; both paths "
          f"free-running: max |difference| {free}, the same top-"
          f"{cfg.experts_per_token} expert for {agree / routed:.6f} of the "
          f"{routed} (token, MoE layer) pairs")
    if not forced <= FIRST_LOGIT_TOL:
        raise AssertionError(f"{LLAMA4}: first-token logits with the same "
                             f"plans differ by {forced} > {FIRST_LOGIT_TOL}")


def llama4_shards(model, device, extras, requests, per_run) -> dict:
    """The same weights with per-shard dispatch (``moe_dispatch_shards``
    LLAMA4_SHARDS, a config change, no second model): the first
    LLAMA4_SHARD_REQUESTS requests on both paths, B3 once per MoE layer of
    every prefill and decode step whether grouped or not (a prompt length
    that the shards do not divide plans once), B4 once per self-attention
    layer of every prefill; each prefill's plans recorded on both configs:
    grouped or not, drops; the first-token logits held to the unsharded
    kernel path's within FIRST_LOGIT_TOL where neither dropped a routed
    entry, printed otherwise; a decode step's plans at capacity 32.
    Returns the kernel path's launches."""
    import dataclasses

    import torch

    from repro_torch.models import model as M
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    cfg, params = model
    cfg4 = dataclasses.replace(cfg, moe_dispatch_shards=LLAMA4_SHARDS)
    model4 = (cfg4, params)
    reqs = requests()[:LLAMA4_SHARD_REQUESTS]
    runs = {impl: slice9_run(model4, device, impl, reqs, extras)
            for impl in ("auto", "jnp")}
    for impl, run in runs.items():
        check_serving_run(f"{LLAMA4} with {LLAMA4_SHARDS} dispatch shards",
                          cfg4, impl, run, SERVE_PROMPT_LENS, per_run)

    def kept_all(rec):
        return all(int((plan["slot_token"] >= 0).sum()) == choice.numel()
                   for plan, choice, _cap in rec)

    grouped = held = 0
    worst_held = worst_dropped = 0.0
    per_prompt = []
    for req in reqs:
        prompt = torch.as_tensor(req.prompt, dtype=torch.long,
                                 device=device)[None]
        logits, recs = {}, {}
        for shards, c in ((LLAMA4_SHARDS, cfg4), (0, cfg)):
            recs[shards] = []
            with planner("moe_dispatch_plan", recording(recs[shards])):
                lg, _ = M.prefill(params, c, prompt, extras,
                                  kernel_impl="auto")
            logits[shards] = lg[0, -1].float()
        is_grouped = len(req.prompt) % LLAMA4_SHARDS == 0
        shapes = {tuple(plan["slot_token"].shape)
                  for plan, _c, _cap in recs[LLAMA4_SHARDS]}
        if {len(s) for s in shapes} != {2 if is_grouped else 1}:
            raise AssertionError(f"{LLAMA4} request {req.rid} of "
                                 f"{len(req.prompt)} tokens planned as "
                                 f"{shapes}")
        grouped += is_grouped
        if int(torch.argmax(logits[LLAMA4_SHARDS])) != runs["auto"][
                "outputs"][req.rid][0]:
            raise AssertionError(f"{LLAMA4} request {req.rid}: the sharded "
                                 f"engine's first token is not its "
                                 f"prefill's argmax")
        diff = float((logits[LLAMA4_SHARDS] - logits[0]).abs().max())
        kept = (kept_all(recs[LLAMA4_SHARDS]), kept_all(recs[0]))
        if all(kept):
            held += 1
            worst_held = max(worst_held, diff)
        else:
            worst_dropped = max(worst_dropped, diff)
        per_prompt.append(f"{len(req.prompt)} tokens "
                          f"{'grouped' if is_grouped else 'one plan'}, "
                          f"{'none' if kept[0] else 'some'} dropped sharded, "
                          f"{'none' if kept[1] else 'some'} unsharded: "
                          f"{diff}")
    dec = []

    def decode_step():
        eng = ServingEngine(cfg4, ServeConfig(batch_slots=SERVE_SLOTS,
                                              cache_len=SERVE_CACHE_LEN),
                            params, device=device, kernel_impl="auto")
        eng.run([Request(rid=r.rid, prompt=r.prompt, max_new_tokens=2)
                 for r in reqs], extras)

    with planner("moe_dispatch_plan", recording(dec)):
        decode_step()
    dec = [(tuple(plan["slot_token"].shape), cap) for plan, choice, cap in dec
           if choice.shape[0] == SERVE_SLOTS]
    E = cfg.num_experts
    want_dec = (LLAMA4_SHARDS, E * 32)
    if not dec or any(d != (want_dec, 32) for d in dec):
        raise AssertionError(f"{LLAMA4} sharded decode plans {dec}")
    print(f"{LLAMA4} with {LLAMA4_SHARDS} dispatch shards: {grouped} of "
          f"{len(reqs)} prefills grouped (the prompt length divisible by "
          f"{LLAMA4_SHARDS}), {len(reqs) - grouped} fell back to one plan; a "
          f"decode step's {len(dec)} MoE plans grouped at capacity 32 (slot "
          f"tables {dec[0][0]}); first-token logits against the unsharded "
          f"kernel path: {held} prompts with no routed entry dropped on "
          f"either, max |difference| {worst_held} (tolerance "
          f"{FIRST_LOGIT_TOL}); the others {worst_dropped}; by prompt: "
          + "; ".join(per_prompt))
    if not worst_held <= FIRST_LOGIT_TOL:
        raise AssertionError(f"{LLAMA4} sharded first-token logits differ "
                             f"by {worst_held} > {FIRST_LOGIT_TOL}")
    return runs["auto"]["launches"]


def main_path_slice11(device) -> dict:
    """Phase 15: llama4-maverick-400b-a17b (LLAMA4_CUT) serving at its
    published width through ServingEngine with its seeded early-fusion
    prefix, all requests on the kernel path and the first
    LLAMA4_PLAIN_REQUESTS on the plain path; B3 at its shape and its
    grouped form, B4 at its chunked and NoPE layers; per-shard dispatch
    on the same weights. Returns the kernel paths' launches of B3 and B4
    and the readings' largest errors."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import sweep
    from repro_torch.launch.serve import check_fits
    from repro_torch.models import model as M
    from repro_torch.models import transformer as TF

    power = gpu_name_and_power()
    # after the simulator's phases: their cached runners (captured graphs
    # and their memory pools) go, so the model has the card to itself
    held = torch.cuda.memory_allocated()
    sweep.set_runner_cache_capacity(sweep.set_runner_cache_capacity(1))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{LLAMA4} phase: the runner cache emptied to one entry, card "
          f"memory allocated {held} B before, "
          f"{torch.cuda.memory_allocated()} B after")
    full = get_config(LLAMA4)
    # where the chunk binds: random inputs at llama4's heads, the card
    # still empty
    q, k, v = random_attention(1, LLAMA4_BINDING_SEQ, full.num_heads,
                               full.num_kv_heads, full.head_dim,
                               torch.bfloat16, SEED, device)
    binding = attention_reading(
        f"{LLAMA4} chunked-local layer, random S={LLAMA4_BINDING_SEQ} (the "
        f"{full.window}-token chunk binds)", q, k, v, "chunked", full.window,
        plain=False)
    del q, k, v
    gc.collect()
    torch.cuda.empty_cache()

    cut = dataclasses.replace(full, **LLAMA4_CUT)
    free = torch.cuda.mem_get_info()[0]
    check_fits(cut, free, SERVE_SLOTS, SERVE_CACHE_LEN)
    weights = cut.param_count() * 2
    cache = sum(math.prod(shape) * dtype.itemsize
                for entry in M.cache_spec(cut, SERVE_SLOTS,
                                          SERVE_CACHE_LEN)["layers"]
                for shape, dtype in entry.values())
    # a sharded prefill's largest MoE blocks: the gathered [E, G*C, D]
    # and three [E, G*C, d_ff] (the two products and their gated product)
    blocks = cut.num_experts * LLAMA4_SHARDS * 128 * (
        cut.d_model + 3 * cut.expert_d_ff) * 2
    print(f"{LLAMA4} cut to {cut.num_layers} of its {full.num_layers} "
          f"layers: check_fits passes ({weights} B of bf16 weights, {cache} "
          f"B of cache at {SERVE_SLOTS} x {SERVE_CACHE_LEN}, {free} B free); "
          f"estimated peak {weights + cache + blocks} B with a sharded "
          f"prefill's MoE blocks ({blocks} B)")
    model = full_model(LLAMA4, device, **LLAMA4_CUT)
    cfg, params = model
    extras = M.random_extras(cfg, 1, SEED, device)
    caps = llama4_captures(model, extras, device)
    b4_err = llama4_b4_readings(caps["attn"])
    b3_err = llama4_b3_readings(caps, power)
    del caps
    specs = TF.layer_specs(cfg)
    n_moe = sum(s.is_moe for s in specs)
    n_attn = sum(TF.has_self_attention(s) for s in specs)

    def per_run(st):
        return {"moe_dispatch": n_moe * (st["prefills"] + st["decode_steps"]),
                "flash_attention": n_attn * st["prefills"]}

    def requests():
        return serve_requests(cfg, new_tokens=SLICE9_NEW_TOKENS)

    runs = {"auto": slice9_run(model, device, "auto", requests(), extras),
            "jnp": slice9_run(model, device, "jnp",
                              requests()[:LLAMA4_PLAIN_REQUESTS], extras)}
    for impl, run in runs.items():
        check_serving_run(LLAMA4, cfg, impl, run, SERVE_PROMPT_LENS, per_run)
    peak = torch.cuda.max_memory_allocated()
    llama4_first_token_logits(model, device,
                              requests()[:LLAMA4_PLAIN_REQUESTS], extras,
                              runs)
    sharded = llama4_shards(model, device, extras, requests, per_run)
    n = 2
    wall = slice9_run(model, device, "auto", requests()[:n], extras)["wall"]
    profile_share(f"{LLAMA4} serving, kernel path, the first {n} requests "
                  f"({power})",
                  lambda: slice9_run(model, device, "auto", requests()[:n],
                                     extras)["wall"],
                  wall, ("flash_attention", "moe_dispatch"))
    peak = max(peak, torch.cuda.max_memory_allocated())
    print(f"{LLAMA4} phase: peak card memory {peak} B (estimated "
          f"{weights + cache + blocks} B; {power}); B4 where the chunk "
          f"binds {binding['ms']['kernel']:.6f} ms against "
          f"{binding['ms'][binding['sdpa']]:.6f} ms of {binding['sdpa']}")
    launches = {name: runs["auto"]["launches"][name] + sharded[name]
                for name in ("moe_dispatch", "flash_attention")}
    del model, params, extras, runs
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches, b3_err=b3_err, b4_err=max(b4_err, binding["err"]))


def dist_txns(hot: int, lanes: int):
    """The first ``lanes`` txns of YCSB_FULL at ``hot`` hot keys, each
    row's keys sorted with their modes (canonical order, P2)."""
    import numpy as np

    wl = make_full_workload(dict(YCSB_FULL, num_hot=hot))
    order = np.argsort(wl.keys[:lanes], axis=1, kind="stable")
    return (np.take_along_axis(wl.keys[:lanes], order, 1).astype(np.int32),
            np.take_along_axis(wl.modes[:lanes], order, 1).astype(np.int32))


def dist_run(mesh, cfg, keys, modes, impl):
    """One ``make_engine`` run with B1's launches counted from 0: (per-shard
    commits, launches, wall s including its graph capture)."""
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.kernels.lock_grant import ops

    fn = D.make_engine(mesh, cfg, kernel_impl=impl)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    commits = fn(keys, modes).tolist()
    wall = time.perf_counter() - t0
    return commits, ops.launches, wall


def dist_round(cfg, keys, modes, device, kernel: bool):
    """The one-device form's initial state and round body at DIST_CC
    shards, as ``make_engine`` builds them."""
    import torch

    from repro_torch.core import distributed as D

    me = torch.arange(DIST_CC, dtype=torch.int32, device=device)
    k = torch.from_numpy(keys).to(device).reshape(DIST_CC, -1,
                                                  cfg.keys_per_txn)
    m = torch.from_numpy(modes).to(device).reshape(k.shape)
    state = D.initial_state(cfg, DIST_CC, device)
    return state, D.make_round(cfg, DIST_CC, me, k, m, kernel=kernel)


def dist_round_inputs(cfg, keys, modes, device, rounds: int = 300):
    """The sorted-form inputs of the round with the most requests among
    the first ``rounds`` of an eager kernel-path run (B1 at the
    distributed round's shape)."""
    from repro_torch.core.lockgrant import REQ_NONE
    from repro_torch.kernels.lock_grant import ops

    def run():
        # built under the wrapper: make_round binds lock_grant_sorted
        state, round_ = dist_round(cfg, keys, modes, device, kernel=True)
        for _ in range(rounds):
            round_(state)

    before = ops.launches
    rec = capture_calls([(ops, "lock_grant_sorted", lambda *a: True)],
                        run)[0]
    ops.launches = before
    return max(rec, key=lambda a: int((a[1] != REQ_NONE).sum()))


def dist_profile(label, cfg, keys, modes, impl, device) -> None:
    """The main path's round graph (``D.round_graph``, ROUNDS_PER_REPLAY
    rounds a replay) captured and run DIST_PROFILED rounds, then
    DIST_PROFILED rounds with CUDA events around them (the span
    unprofiled), then DIST_PROFILED more under torch.profiler (CUDA
    activity; CUPTI reports each kernel node of a replay) with CUDA
    events around the same replays: CUDA kernels and device ms a round,
    B1's share, and the busy share of the profiled replays' span, the
    one window (the tracing itself widens the gaps between nodes). Each
    window holds replays only, no copy or capture."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import distributed as D
    from repro_torch.kernels.lock_grant import ops

    state, round_ = dist_round(cfg, keys, modes, device, impl == "auto")
    before = ops.launches
    graph = D.round_graph(round_, state, D.ROUNDS_PER_REPLAY, device)
    replays = DIST_PROFILED // D.ROUNDS_PER_REPLAY
    n = replays * D.ROUNDS_PER_REPLAY

    def span() -> float:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(replays):
            graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    span()
    free_ms = span()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        span_ms = span()
    ops.launches = before
    graph.reset()
    kern = device_activity(prof)
    n_kernels = sum(c for c, _s in kern.values()) / n
    dev_ms = sum(sec for _c, sec in kern.values()) / n * 1e3
    b1 = [(c, sec) for name, (c, sec) in kern.items()
          if "lock_grant_kernel" in name]
    b1_ms = sum(sec for _c, sec in b1) / n * 1e3
    if n_kernels <= 0:
        raise AssertionError(f"{label}: the profiler saw no CUDA kernel")
    if dev_ms > span_ms:
        raise AssertionError(f"{label}: device {dev_ms} ms a round over "
                             f"the replays' span {span_ms} ms")
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:5]
    print(f"profile distributed orthrus {label}: {n_kernels:.1f} CUDA "
          f"kernels a round, device {dev_ms:.6f} ms a round against a "
          f"replay span of {span_ms:.6f} ms a round (busy share "
          f"{dev_ms / span_ms:.4f}; unprofiled span {free_ms:.6f} ms a "
          f"round); B1 {sum(c for c, _s in b1) / n:.2f} "
          f"launches and {b1_ms:.6f} ms a round; top: " + "; ".join(
              f"{name[:50]} {sec / n * 1e6:.2f} us" for name, (_c, sec)
              in top))


def dist_nccl(device) -> int:
    """(c) The process form over NCCL at world size 1 (a file store under
    build/) against the one-device form at n_cc 1. Returns B1's launches
    of the process-form run."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import DistConfig
    from repro_torch.launch.mesh import one_device_mesh, process_mesh

    store = ROOT / "build" / "dist_nccl_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    keys, modes = dist_txns(DIST_HOTS[0], DIST_NCCL["lanes_per_shard"])
    cfg = DistConfig(**DIST_NCCL)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        got, launches, wall = dist_run(process_mesh((1,), ("cc",)), cfg,
                                       keys, modes, "auto")
    finally:
        dist.destroy_process_group()
    want, _, _ = dist_run(one_device_mesh((1,), ("cc",), device), cfg, keys,
                          modes, "auto")
    if got != want or launches != cfg.rounds:
        raise AssertionError(f"NCCL process form {got} ({launches} B1 "
                             f"launches) against one-device {want}")
    print(f"distributed orthrus, process form over NCCL at world size 1, "
          f"{cfg.rounds} rounds (eager, one all_to_all_single each way a "
          f"round): per-shard commits {got} equal the one-device form's; "
          f"B1 {launches} launches; {cfg.rounds / wall:.1f} rounds/s")
    return launches


def main_path_slice12(device) -> dict:
    """Phase 16: distributed ORTHRUS, the one-device form (16 CC shards as
    a leading tensor dimension, the all-to-all a transpose, one B1 sorted
    launch a round for all shards, DIST_ROUNDS rounds as CUDA-graph
    replays) on both paths, held to its CPU run at DIST_CPU_ROUNDS; B1 at
    the round's shape against its plain version; the process form over
    NCCL. Returns the main path's B1 launches and B1's largest error."""
    import dataclasses

    import numpy as np

    from repro_torch.core import distributed as D
    from repro_torch.core.lockgrant import REQ_NONE
    from repro_torch.kernels.lock_grant import ops
    from repro_torch.kernels.lock_grant.ref import lock_grant_ref
    from repro_torch.launch.mesh import one_device_mesh

    power = gpu_name_and_power()
    total = 0
    # (a) the reference test's cell (its draw), kernel and plain paths
    rng = np.random.default_rng(0)
    cfg = D.DistConfig(**DIST_TEST)
    n = 8 * cfg.lanes_per_shard
    keys = np.sort(rng.integers(0, 8 * cfg.keys_per_shard,
                                (n, cfg.keys_per_txn)), axis=1)
    modes = rng.integers(0, 2, keys.shape)
    mesh8 = one_device_mesh((8,), ("cc",), device)
    for impl in ("auto", "jnp"):
        got, launches, wall = dist_run(mesh8, cfg, keys, modes, impl)
        want_launches = cfg.rounds if impl == "auto" else 0
        if got != DIST_TEST_COMMITS or launches != want_launches:
            raise AssertionError(f"distributed orthrus, the reference "
                                 f"test's cell, {impl}: {got}, {launches} "
                                 f"B1 launches")
        total += launches
        print(f"distributed orthrus, tests/test_sharding.py's cell (8 "
              f"shards x 8 lanes, 3 keys, {cfg.rounds} rounds), "
              f"{'kernel' if impl == 'auto' else 'plain'} path: per-shard "
              f"commits {got} as the JAX reference's; B1 {launches} "
              f"launches; {wall:.3f} s")

    # (b) full width, two cells
    mesh = one_device_mesh((DIST_CC,), ("cc",), device)
    cpu_mesh = one_device_mesh((DIST_CC,), ("cc",), "cpu")
    full = D.DistConfig(rounds=DIST_ROUNDS, **DIST_FULL)
    short = dataclasses.replace(full, rounds=DIST_CPU_ROUNDS)
    err = 0
    for hot in DIST_HOTS:
        label = f"hot {hot}" if hot else "uniform"
        keys, modes = dist_txns(hot, DIST_CC * full.lanes_per_shard)
        t0 = time.perf_counter()
        cpu = D.make_engine(cpu_mesh, short, kernel_impl="auto")(
            keys, modes).tolist()
        cpu_s = time.perf_counter() - t0
        for impl in ("auto", "jnp"):
            got, launches, _ = dist_run(mesh, short, keys, modes, impl)
            total += launches
            if got != cpu or launches != (short.rounds if impl == "auto"
                                          else 0):
                raise AssertionError(f"distributed orthrus {label}, "
                                     f"{DIST_CPU_ROUNDS} rounds, {impl}: "
                                     f"{got} against the CPU's {cpu}")
        print(f"distributed orthrus {label}: at {DIST_CPU_ROUNDS} rounds "
              f"both paths on the card equal the CPU run ({cpu}, "
              f"{cpu_s:.3f} s on the CPU)")
        runs = {}
        for impl in ("auto", "jnp"):
            runs[impl] = dist_run(mesh, full, keys, modes, impl)
            total += runs[impl][1]
        (kc, kl, kw), (pc, pl, pw) = runs["auto"], runs["jnp"]
        if kc != pc or kl != full.rounds or pl != 0:
            raise AssertionError(f"distributed orthrus {label}: kernel path "
                                 f"{kc} ({kl} B1 launches), plain {pc} "
                                 f"({pl})")
        print(f"distributed orthrus {label}, {DIST_CC} CC shards x "
              f"{full.lanes_per_shard} exec lanes, {full.keys_per_txn} "
              f"keys a txn, msg_cap {full.msg_cap}, {full.rounds} rounds "
              f"({full.rounds // D.ROUNDS_PER_REPLAY} replays of a "
              f"{D.ROUNDS_PER_REPLAY}-round graph): "
              f"per-shard commits {kc}, identical on both paths, "
              f"{sum(kc) / full.rounds:.4f} commits a round; B1 {kl} "
              f"launches; kernel path {kw:.3f} s ({full.rounds / kw:.1f} "
              f"rounds/s), plain path {pw:.3f} s ({full.rounds / pw:.1f} "
              f"rounds/s) ({power})")
        for impl in runs:
            dist_profile(f"{label}, {'kernel' if impl == 'auto' else 'plain'}"
                         f" path", full, keys, modes, impl, device)
        if hot:
            # B1's sorted form at the distributed round's shape
            args = dist_round_inputs(full, keys, modes, device)
            before = ops.launches
            want = lock_grant_ref(*args)
            err = max(err, max_abs_err(ops.lock_grant_cuda(*args), want))
            res = in_turns({"kernel": lambda: ops.lock_grant_cuda(*args),
                            "plain": lambda: lock_grant_ref(*args)},
                           graph_ms)
            ops.launches = before
            n_ent = args[0].shape[0]
            active = int((args[1] != REQ_NONE).sum())
            # each entry's key, kind, write-free flag and read count read
            # (13 B), its grant and three int32 positions written (13 B)
            n_bytes = n_ent * 26
            print_turns(f"lock_grant sorted form at the distributed round's "
                        f"N={n_ent} ({active} requests, the rest padding; "
                        f"max_abs_err {err})", res)
            print(f"lock_grant sorted form at N={n_ent}: kernel "
                  f"{res['kernel'][1]:.6f} ms, plain {res['plain'][1]:.6f} "
                  f"ms, bound {n_bytes / HBM_BYTES_PER_S * 1e3:.9f} ms "
                  f"(bytes: {n_bytes} B) ({power})")
    if err:
        raise AssertionError(f"B1 at the distributed shape: max_abs_err "
                             f"{err}")
    # (c) the process form over NCCL
    total += dist_nccl(device)
    return dict(lock_grant=total, b1_err=err)


def train_vjp_check(label, via_kernel, plain, inputs, grads_out,
                    holds) -> float:
    """One autograd Function (``kernels.autograd.kernel_call``) at a real
    layer's shape. Its forward outputs (the kernel's) are held to
    ``plain``'s on the same inputs with phase 2's tolerances, one entry
    of ``holds`` an output: "bits" bit-equal (B3's plan), "bf16" FA_TOL
    or one unit in the last place (B4), "f32" RWKV_TOL or RWKV_REL_TOL of
    the largest |value| (B5's o and state). Then the input gradients
    through ``via_kernel`` (the plain version's backward) against
    autograd through ``plain`` on the same output gradients: a check of
    the wiring, the same kernels on both sides. Returns the largest
    gradient difference as a share of the plain gradient's largest
    |value|; raises past TRAIN_VJP_RTOL or where a forward disagrees."""
    import torch

    def run(fn):
        xs = [x.detach().requires_grad_(True) for x in inputs]
        outs = fn(*xs)
        outs = (outs,) if isinstance(outs, torch.Tensor) else tuple(outs)
        pairs = [(o, g) for o, g in zip(outs, grads_out) if g is not None]
        return [o.detach() for o in outs], torch.autograd.grad(
            [o for o, _ in pairs], xs, [g for _, g in pairs],
            allow_unused=True)

    t0 = time.perf_counter()
    outs, got = run(via_kernel)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    outs_plain, want = run(plain)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if len(outs) != len(outs_plain) or len(outs) != len(holds):
        raise AssertionError(f"{label}: {len(outs)} outputs against the "
                             f"plain version's {len(outs_plain)}")
    readings, bad = [], []
    for i, (o, w, hold) in enumerate(zip(outs, outs_plain, holds)):
        if o.shape != w.shape or o.dtype != w.dtype:
            raise AssertionError(f"{label}: output {i} {tuple(o.shape)} "
                                 f"{o.dtype} against {tuple(w.shape)} "
                                 f"{w.dtype}")
        if hold == "bits":
            ok = torch.equal(o, w)
            readings.append(f"output {i} {'bit-equal' if ok else 'differs'}")
        else:
            diff = (o.float() - w.float()).abs()
            if hold == "bf16":
                tol = torch.clamp(bf16_ulp(w.float()),
                                  min=FA_TOL["bfloat16"])
            else:
                tol = max(RWKV_TOL, RWKV_REL_TOL * float(w.abs().max()))
            ratio = float((diff / tol).max())
            ok = ratio <= 1 and bool(torch.isfinite(o).all())
            readings.append(f"output {i} max_abs_err {float(diff.max()):.6g}"
                            f" ({ratio:.4f} of the {hold} tolerance)")
        if not ok:
            bad.append(i)
    err = 0.0
    for g, w in zip(got, want):
        if (g is None) != (w is None):
            raise AssertionError(f"{label}: a gradient on one side only")
        if w is not None:
            err = max(err, float((g.float() - w.float()).abs().max())
                      / max(float(w.abs().max()), 1e-30))
    print(f"train vjp {label}: inputs "
          f"{[tuple(x.shape) for x in inputs]}; the kernel's forward "
          f"against the plain version's: {'; '.join(readings)}; the "
          f"Function's backward against autograd through the plain "
          f"version: max |diff| {err:.3e} of the plain gradient's largest "
          f"|value| (tolerance {TRAIN_VJP_RTOL}); {t1 - t0:.3f} s and "
          f"{t2 - t1:.3f} s")
    if bad:
        raise AssertionError(f"train vjp {label}: the kernel's forward "
                             f"output(s) {bad} disagree with the plain "
                             f"version's")
    if not err <= TRAIN_VJP_RTOL:
        raise AssertionError(f"train vjp {label}: {err} > {TRAIN_VJP_RTOL}")
    return err


def train_vjp_checks(device) -> None:
    """Phase 17's Function checks at the training cells' real layer
    shapes (random inputs at the models' scales): B4 at gemma3-1b's
    global layer (q [4, 2048, 4, 256], k/v one head, full, bf16), B5 at
    rwkv6-1.6b's layer 0 (r/k/v/w [2, 32, 256, 64] f32 as [B,H,S,hd]
    views of [B,S,H,hd], u and the zero state), B3's plan at mixtral's
    layer 0 (2,048 tokens, 8 experts, top 2, capacity 640)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.autograd import kernel_call
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rwkv6_scan import ops as rw_ops
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TF

    gen = torch.Generator(device=device).manual_seed(SEED)

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    g = get_config("gemma3-1b")
    spec = TF.attn_spec(g, g.pattern[-1])  # the global layer
    B, S = 4, 2048
    q = randn((B, S, g.num_heads, g.head_dim), dtype=torch.bfloat16)
    k, v = (randn((B, S, g.num_kv_heads, g.head_dim), dtype=torch.bfloat16)
            for _ in range(2))

    def attend(q_, k_, v_):
        return L._attend_blocked(q_, k_, v_, spec)

    train_vjp_check(
        "flash_attention, gemma3-1b global layer",
        lambda *x: kernel_call(lambda *y: fa_ops.flash_attention(
            *y, kind=spec.kind, window=spec.window), attend, *x,
            name="flash_attention"),
        attend, (q, k, v), (randn(q.shape, dtype=torch.bfloat16),),
        ("bf16",))

    r = get_config("rwkv6-1.6b")
    B, S = next(c[3:5] for c in TRAIN_CELLS if c[0] == "rwkv6-1.6b")
    H, D = r.ssm_heads, r.head_dim
    rkv = [randn((B, S, H, D), 0.2).transpose(1, 2) for _ in range(3)]
    w = torch.exp(-torch.exp(randn((B, S, H, D), 0.5) - 0.5)).transpose(1, 2)
    u = randn((H, D), 0.1)
    s0 = torch.zeros((B, H, D, D), device=device)
    train_vjp_check(
        "rwkv6_scan, rwkv6-1.6b layer 0",
        lambda *x: kernel_call(rw_ops.rwkv6_scan, rwkv6_scan_ref, *x,
                               name="rwkv6_scan"),
        rwkv6_scan_ref, (*rkv, w, u, s0), (randn((B, H, S, D)), None),
        ("f32", "f32"))

    m = get_config("mixtral-8x22b")
    n = 2 * 1024
    cap = MOE.capacity_for(n, m.experts_per_token, m.num_experts,
                           m.capacity_factor)
    probs = torch.softmax(randn((n, m.num_experts)), -1)
    fields = ("slot_token", "slot_weight", "load")

    def plan_of(planner):
        return lambda p: tuple(planner(p, m.experts_per_token, cap)[f]
                               for f in fields)

    train_vjp_check(
        f"moe_dispatch, mixtral-8x22b layer 0's plan (capacity {cap}; "
        f"outputs {', '.join(fields)})",
        plan_of(MOE._kernel_plan), plan_of(MOE.plan_dispatch), (probs,),
        (None, randn((m.num_experts * cap,)), None), ("bits",) * 3)


@contextlib.contextmanager
def nudged_kernels():
    """B4's and B5's outputs (the attention output, the scan's o) moved
    each by one bf16 unit up or down inside the block: the rounding
    yardstick of phase 17's grad check. The signs come from a generator
    seeded with SEED at every call, so a layer's forward and its remat
    recompute (the same call at the same shape) see the same move."""
    import torch

    from repro_torch.models import layers, ssm

    def nudge(o):
        gen = torch.Generator(device=o.device).manual_seed(SEED)
        up = torch.randint(0, 2, o.shape, generator=gen, device=o.device,
                           dtype=torch.bool)
        step = bf16_ulp(o.float())
        return (o.float() + torch.where(up, step, -step)).to(o.dtype)

    fa, rw = layers.flash_attention, ssm.rwkv6_scan
    layers.flash_attention = lambda *a, **kw: nudge(fa(*a, **kw))
    ssm.rwkv6_scan = lambda *a, **kw: (lambda o, st: (nudge(o), st))(
        *rw(*a, **kw))
    try:
        yield
    finally:
        layers.flash_attention, ssm.rwkv6_scan = fa, rw


def grad_gaps(got: dict, want: dict) -> dict:
    """{name: ||got - want|| / ||want||} over matching watched grads."""
    import torch

    return {name: float(torch.linalg.norm(g - want[name])
                        / torch.linalg.norm(want[name]))
            for name, g in got.items()}


def watched_grads(grads) -> dict:
    """The step-0 grads phase 17 holds across the two paths: every
    attention layer's wq/wk/wv, every MoE router, and the rwkv time mix's
    projections, decay and bonus (the ones a kernel without a backward
    would starve). {(its kind, its path): f32 copy}."""
    from torch.utils import _pytree as pytree

    out = {}
    for path, g in pytree.tree_flatten_with_path(grads)[0]:
        kind = grad_group([getattr(k, "key", None) for k in path])
        if kind:
            out[kind, pytree.keystr(path)] = g.float().clone()
    return out


def grad_group(keys) -> str | None:
    """The kind of a watched leaf (its path's keys), each held to its own
    bound in phase 17; None for a leaf not watched."""
    if "attn" in keys and keys[-1] in ("wq", "wk", "wv"):
        return "attention wq/wk/wv"
    if keys[-1] == "router":
        return "routers"
    if "tm" in keys and keys[-1] in ("wr", "wk", "wv"):
        return "time-mix wr/wk/wv"
    if "tm" in keys and keys[-1] in ("w0", "wa", "wb", "u"):
        return "time-mix decay and bonus"
    return None


def grad_bounds(arch, errs: dict, moved: dict) -> dict:
    """Phase 17's grad check, one kind of leaf (``grad_group``) at a
    time: each leaf's ||kernel - plain|| / ||plain|| (``errs``) within
    TRAIN_GRAD_NUDGES x the largest move one bf16 unit of B4's and B5's
    outputs gives a leaf of its kind (``moved``), or TRAIN_GRAD_FLOOR
    where that is larger; the bound below TRAIN_GRAD_POWER, so that a
    missing gradient (about 1) fails. Prints each kind's readings;
    returns {kind: (bound, largest err, its leaf)}; raises."""
    kinds = {}
    for kind, name in errs:
        kinds.setdefault(kind, []).append((kind, name))
    out = {}
    for kind, names in sorted(kinds.items()):
        errs_k = sorted(errs[n] for n in names)
        moved_k = sorted(moved[n] for n in names)
        bound = max(TRAIN_GRAD_NUDGES * moved_k[-1], TRAIN_GRAD_FLOOR)
        worst = max(names, key=errs.get)
        print(f"train {arch}: {kind}, {len(names)} leaves: kernel vs plain "
              f"median {errs_k[len(names) // 2]:.4e}, largest "
              f"{errs[worst]:.4e} ({worst[1]}); one bf16 unit moves them by "
              f"median {moved_k[len(names) // 2]:.4e}, largest "
              f"{moved_k[-1]:.4e}: bound {bound:.4e} (max of "
              f"{TRAIN_GRAD_NUDGES} x and {TRAIN_GRAD_FLOOR}, below "
              f"{TRAIN_GRAD_POWER})")
        if not bound < TRAIN_GRAD_POWER:
            raise AssertionError(f"train {arch}: rounding alone moves the "
                                 f"{kind} grads by {moved_k[-1]}: the check "
                                 f"cannot see a missing gradient")
        if not errs[worst] <= bound:
            raise AssertionError(f"train {arch}: {worst[1]}'s grad differs "
                                 f"from the plain path's by {errs[worst]} "
                                 f"> {bound}")
        out[kind] = (bound, errs[worst], worst[1])
    return out


def check_every_grad(arch, grads) -> None:
    """Every leaf's grad finite with a non-zero entry; an expert bank's
    in each expert."""
    import torch
    from torch.utils import _pytree as pytree

    for path, g in pytree.tree_flatten_with_path(grads)[0]:
        name = pytree.keystr(path)
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"train {arch}: {name}'s grad not finite")
        per = (g.reshape(g.shape[0], -1).abs().amax(1)
               if "moe" in name and g.dim() == 3 else g.abs().max()[None])
        if not bool((per > 0).all()):
            raise AssertionError(f"train {arch}: {name}'s grad is zero "
                                 f"(somewhere: {per.tolist()})")


def profile_train_step(arch, run) -> tuple:
    """``run()``, one kernel-path training step, under torch.profiler (CPU
    and CUDA): the device seconds of its kernels, and of the kernels that
    start inside B4's and B5's plain backwards (their ``record_function``
    ranges on the device), each as a share of the step's kernel time.
    Returns ({"device_s", "shares"}, run's result)."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = run()
    t1 = time.perf_counter()
    kernels, ranges = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if e.is_user_annotation():
            if e.name().endswith("plain backward"):
                ranges.setdefault(e.name(), []).append(
                    (e.start_ns(), e.start_ns() + e.duration_ns()))
        else:
            kernels.append((e.start_ns(), e.duration_ns()))
    total = sum(d for _s, d in kernels) / 1e9
    inside = {}
    for name, rs in ranges.items():
        rs.sort()
        starts = [a for a, _b in rs]
        inside[name] = sum(
            d for s, d in kernels
            if (i := bisect.bisect_right(starts, s) - 1) >= 0
            and s < rs[i][1]) / 1e9
    shares = {k: v / total for k, v in inside.items()}
    print(f"train {arch} profile: {t1 - t0:.3f} s profiled, the trace "
          f"read in {time.perf_counter() - t1:.3f} s")
    print(f"train {arch} profile: one kernel-path step, {len(kernels)} "
          f"device activities, {total:.4f} s of device time; inside the "
          f"plain backwards: "
          + (", ".join(f"{k} {inside[k]:.4f} s in {len(ranges[k])} ranges "
                       f"({shares[k]:.4f} of the step's device time)"
                       for k in sorted(inside))
             or "not measured (no device range in the trace)"))
    return {"device_s": total, "shares": shares}, out


def main_path_slice13(device, cells=TRAIN_CELLS) -> dict:
    """Phase 17: training on one card through ``launch.train``'s
    ``build_trainer`` (TRAIN_CELLS), each cell on the kernel path and the
    plain path (``kernel_impl="jnp"``) from the same seeded weights and
    ``TokenPipeline`` batches. Step 0 is the train step's own parts
    (``loss_and_grads``, then ``opt_update``), so its grads are held:
    finite and non-zero on every leaf on the kernel path, the watched
    ones (``watched_grads``) within the bound of their kind
    (``grad_bounds``: TRAIN_GRAD_NUDGES x the kind's largest move under
    ``nudged_kernels``) of the plain path's, its loss within
    TRAIN_LOSS_TOL; the other steps are ``run_step``.
    TRAIN_CKPT_ARCH's kernel path saves a checkpoint before its last
    step, restored into a fresh trainer whose last step's loss is held
    to the uninterrupted one's. Prints step ms, tokens/s, peak memory,
    the kernel path's step 0 profiled (its device time, the busy share
    against the median step, the plain backwards' shares); the launches
    of B3, B4 and B5 over every path are returned (and checked against
    the layers), with each cell's kernel-path step-0 loss, watched grads,
    grad bounds and median step ms under "step0" (phase 18 holds its
    DTensor trainer to them). Then the Functions at real shapes
    (``train_vjp_checks``), not counted."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import Checkpointer, restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core import sweep
    from repro_torch.launch.mesh import one_device_mesh
    from repro_torch.launch.train import build_trainer, token_pipeline
    from repro_torch.models import transformer as TF
    from repro_torch.optim import OptConfig, opt_update
    from repro_torch.train.train_step import TrainConfig, loss_and_grads

    sweep.set_runner_cache_capacity(sweep.set_runner_cache_capacity(1))
    gc.collect()
    torch.cuda.empty_cache()
    power = gpu_name_and_power()
    mesh = one_device_mesh((1, 1), ("data", "model"), device)
    ops = kernel_ops()
    want = {"flash_attention": 0, "rwkv6_scan": 0, "moe_dispatch": 0}
    rows = []
    step0_refs = {}
    reset_launches()
    for arch, cut, opt_kw, B, S, steps_on in cells:
        cfg = dataclasses.replace(get_config(arch), **cut)
        ocfg = OptConfig(lr=TRAIN_LR, **opt_kw)
        tcfg = TrainConfig(loss_chunk=0, opt=ocfg)  # build_trainer's
        pipe = token_pipeline(cfg, mesh, B, S)
        specs = TF.layer_specs(cfg)
        per_step = {"flash_attention": sum(map(TF.has_self_attention, specs)),
                    "rwkv6_scan": sum(s.mixer == "rwkv" for s in specs),
                    "moe_dispatch": sum(bool(s.is_moe) for s in specs)}
        res = {}
        for impl in ("auto", "jnp"):
            path = "kernel" if impl == "auto" else "plain"
            _cfg, init, run_step, _dev = build_trainer(
                arch, mesh, batch=B, seq=S, mcfg=cfg, device=device,
                kernel_impl=impl, opt=ocfg)
            torch.cuda.reset_peak_memory_stats()
            state = init()
            b0 = {k: torch.from_numpy(v).to(device)
                  for k, v in pipe.batch(0).items()}
            nudge = None
            if impl == "auto":
                # the yardstick first: step 0's grads with B4's and B5's
                # outputs moved by one bf16 unit (launches counted)
                with nudged_kernels():
                    _l, grads = loss_and_grads(cfg, tcfg, state["params"],
                                               b0, kernel_impl=impl)
                nudge = watched_grads(grads)
                del grads, _l
                for k, n in per_step.items():
                    want[k] += 2 * n
            def step0():
                # reads ``state`` when called: a default argument would
                # keep the old params and optimizer state alive after it
                loss, g = loss_and_grads(cfg, tcfg, state["params"], b0,
                                         kernel_impl=impl)
                new = opt_update(ocfg, g, state["opt"], state["params"])
                torch.cuda.synchronize()
                return loss, g, new

            t0 = time.perf_counter()
            # the kernel path's step 0 runs under the profiler: its wall
            # is left out of the median step anyway
            prof, (loss0, grads, new) = (
                profile_train_step(arch, step0) if impl == "auto"
                else (None, step0()))
            times = [time.perf_counter() - t0]
            state = dict(zip(("params", "opt"), new))
            del new
            if impl == "auto":
                check_every_grad(arch, grads)
            watched = watched_grads(grads)
            del grads
            losses = [float(loss0)]
            steps = steps_on[impl == "jnp"]
            ckpt, ckpt_dir = None, None
            for step in range(1, steps):
                if (impl == "auto" and arch == TRAIN_CKPT_ARCH
                        and step == steps - 1):
                    (ROOT / "build").mkdir(exist_ok=True)
                    ckpt_dir = tempfile.mkdtemp(prefix="train_ckpt_",
                                                dir=ROOT / "build")
                    ckpt = Checkpointer(ckpt_dir)
                    t1 = time.perf_counter()
                    ckpt.maybe_save(step - 1, state, force=True)
                    print(f"train {arch}: state after step {step - 1} "
                          f"copied to the host for its checkpoint in "
                          f"{time.perf_counter() - t1:.3f} s")
                t0 = time.perf_counter()
                state, m = run_step(state, pipe.batch(step))
                losses.append(float(m["loss"]))
                times.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
            if impl == "auto":
                for k, n in per_step.items():
                    want[k] += 2 * n * steps
            if not all(np.isfinite(losses)):
                raise AssertionError(f"train {arch} {path}: losses {losses}")
            steady = sorted(times[1:])
            step_s = steady[len(steady) // 2]
            if prof is not None:
                prof["busy"] = prof["device_s"] / step_s
            print(f"train {arch} {path} path: {steps} steps of {B} x {S} "
                  f"tokens, losses {losses}; step s {times} (step 0 the "
                  f"train step's parts, first call included"
                  + (", profiled" if prof else "") + f"); median step "
                  f"{step_s * 1e3:.3f} ms, {B * S / step_s:.1f} tokens/s"
                  + (f", profiled step 0's device time {prof['device_s']:.4f}"
                     f" s of it (busy share {prof['busy']:.4f})" if prof
                     else "")
                  + f"; peak card memory {peak} B; {power}")
            if impl == "auto":
                step0_refs[arch] = dict(loss0=losses[0], watched=watched,
                                        step_ms=step_s * 1e3)
            res[impl] = dict(loss0=losses[0], watched=watched, nudge=nudge,
                             step_ms=step_s * 1e3, tokens_s=B * S / step_s,
                             peak=peak, prof=prof, last=losses[-1])
            if ckpt is not None:
                ckpt.wait()
                target = state
                del state
                gc.collect()
                t1 = time.perf_counter()
                restored = restore_checkpoint(ckpt_dir, steps - 2, target,
                                              device)
                del target
                t2 = time.perf_counter()
                run_fresh = build_trainer(arch, mesh, batch=B, seq=S,
                                          mcfg=cfg, device=device,
                                          kernel_impl=impl, opt=ocfg)[2]
                _st, m = run_fresh(restored, pipe.batch(steps - 1))
                resumed = float(m["loss"])
                want["flash_attention"] += 2 * per_step["flash_attention"]
                want["rwkv6_scan"] += 2 * per_step["rwkv6_scan"]
                want["moe_dispatch"] += 2 * per_step["moe_dispatch"]
                size = sum(f.stat().st_size
                           for f in Path(ckpt_dir).rglob("*.npy"))
                print(f"train {arch}: checkpoint of step {steps - 2} "
                      f"({size} B) restored into a fresh trainer in "
                      f"{t2 - t1:.3f} s; its step {steps - 1} loss "
                      f"{resumed} against the uninterrupted {losses[-1]} "
                      f"(|diff| {abs(resumed - losses[-1]):.3e}, tolerance "
                      f"{TRAIN_RESUME_TOL})")
                if not abs(resumed - losses[-1]) <= TRAIN_RESUME_TOL:
                    raise AssertionError(f"train {arch}: the resumed step's "
                                         f"loss {resumed} != {losses[-1]}")
                del restored, _st
                shutil.rmtree(ckpt_dir)
            else:
                del state
            gc.collect()
            torch.cuda.empty_cache()
        k, p = res["auto"], res["jnp"]
        d_loss = abs(k["loss0"] - p["loss0"])
        errs = grad_gaps(k["watched"], p["watched"])
        moved = grad_gaps(k["nudge"], k["watched"])
        print(f"train {arch}: step 0 loss kernel {k['loss0']} plain "
              f"{p['loss0']} (|diff| {d_loss:.3e}, tolerance "
              f"{TRAIN_LOSS_TOL}); {len(errs)} watched grads, "
              f"||kernel - plain|| / ||plain|| held kind by kind:")
        if not d_loss <= TRAIN_LOSS_TOL:
            raise AssertionError(f"train {arch}: step 0 losses differ")
        bounds = grad_bounds(arch, errs, moved)
        rows.append(dict(arch=arch, kernel_ms=k["step_ms"],
                         plain_ms=p["step_ms"], kernel_tok_s=k["tokens_s"],
                         plain_tok_s=p["tokens_s"], kernel_peak=k["peak"],
                         plain_peak=p["peak"], grad_bounds=bounds,
                         loss_diff=d_loss,
                         busy=(k["prof"] or {}).get("busy"),
                         shares=(k["prof"] or {}).get("shares")))
        del res, k, p
        gc.collect()
    got = {name: ops[name].launches for name in want}
    print(f"train launches over every path: {got} (expected {want}: twice "
          f"a layer a kernel-path step, the forward and the remat "
          f"recompute, the rounding yardstick's step 0 and the resumed "
          f"step included; none on the plain path)")
    if got != want:
        raise AssertionError(f"train launches {got} != {want}")
    print("train summary: " + json.dumps(rows))
    train_vjp_checks(device)
    for row in rows:
        step0_refs[row["arch"]]["bounds"] = row["grad_bounds"]
    return dict(got, step0=step0_refs)


def dtensor_trainer_cells(device, step0) -> dict:
    """(a) Phase 17's training cells through ``build_trainer`` on a
    ``DeviceMesh`` over NCCL at world size 1 (data 1, model 1): the params
    and optimizer state are DTensors, the sharding context is live, B3,
    B4 and B5 launch through ``sharding.ctx.local_call``. Step 0's loss
    and watched grads (the train step's own parts, under the context) are
    held to phase 17's trainer without a mesh (``step0``): bit-equal, or
    within phase 17's bound of each kind, and its update applied, all
    timed as one step (the first DTensor call). Then DT_STEPS more steps
    through ``run_step``; the last one's ms is the DTensor step's.
    Returns the launches and {arch: (DTensor ms, phase 17 ms)}."""
    import dataclasses
    import gc

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.train import build_trainer, token_pipeline
    from repro_torch.optim import OptConfig, opt_update
    from repro_torch.sharding import ctx
    from repro_torch.sharding import policies as SH
    from repro_torch.train.train_step import TrainConfig, loss_and_grads

    store = ROOT / "build" / "train_nccl_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    ops = kernel_ops()
    reset_launches()
    ms = {}
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh_for(None, data=1, model=1)
        for arch, cut, opt_kw, B, S, _steps in TRAIN_CELLS:
            cfg = dataclasses.replace(get_config(arch), **cut)
            ocfg = OptConfig(lr=TRAIN_LR, **opt_kw)
            tcfg = TrainConfig(loss_chunk=0, opt=ocfg)
            _c, init, run_step, _d = build_trainer(
                arch, mesh, batch=B, seq=S, mcfg=cfg, device=device,
                opt=ocfg)
            state = init()
            leaves = torch.utils._pytree.tree_leaves(state)
            if not all(isinstance(t, DTensor) for t in leaves):
                raise AssertionError(f"dtensor {arch}: a plain leaf")
            pipe = token_pipeline(cfg, mesh, B, S)
            rules = SH.rules_for(cfg, "train", B, mesh)
            b0 = {k: DTensor.from_local(torch.from_numpy(v).to(device),
                                        mesh.device_mesh,
                                        [Replicate(), Replicate()])
                  for k, v in pipe.batch(0).items()}
            t0 = time.perf_counter()
            with implicit_replication(), ctx.use(mesh, rules):
                loss, grads = loss_and_grads(cfg, tcfg, state["params"], b0)
                watched = watched_grads(torch.utils._pytree.tree_map(
                    lambda g: g.to_local(), grads))
                new = opt_update(ocfg, grads, state["opt"], state["params"])
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            loss = float(loss.full_tensor())
            state = dict(zip(("params", "opt"), new))
            del grads, new
            ref = step0[arch]
            errs = grad_gaps(watched, ref["watched"])
            worst = max(errs.values())
            kinds = {}
            for (kind, name), e in errs.items():
                kinds[kind] = max(kinds.get(kind, 0.0), e)
            bit = loss == ref["loss0"] and worst == 0.0
            print(f"dtensor {arch}: step 0 under the mesh (loss and grads "
                  f"in {first:.3f} s, the first DTensor call) loss {loss} "
                  f"against phase 17's {ref['loss0']}; watched grads "
                  f"||dtensor - phase 17|| / ||phase 17|| by kind "
                  + json.dumps(kinds)
                  + (": bit-equal" if bit else
                     f"; phase 17's bounds {json.dumps({k: v[0] for k, v in ref['bounds'].items()})}"))
            if not bit:
                for kind, e in kinds.items():
                    if not e <= ref["bounds"][kind][0]:
                        raise AssertionError(f"dtensor {arch}: {kind} grads "
                                             f"differ by {e}")
                if not abs(loss - ref["loss0"]) <= TRAIN_LOSS_TOL:
                    raise AssertionError(f"dtensor {arch}: loss {loss}")
            times = [first]
            for step in range(1, 1 + DT_STEPS.get(arch, 1)):
                t0 = time.perf_counter()
                state, m = run_step(state, pipe.batch(step))
                float(m["loss"])
                times.append(time.perf_counter() - t0)
            step_ms = times[-1]
            ms[arch] = (step_ms * 1e3, ref["step_ms"])
            print(f"dtensor {arch}: step s {times} (step 0 the train step's "
                  f"parts, the first DTensor call; then run_step); DTensor "
                  f"step {step_ms * 1e3:.3f} ms (the last) against phase "
                  f"17's median "
                  f"{ref['step_ms']:.3f} ms ({step_ms * 1e3 / ref['step_ms']:.3f}"
                  f"x); peak card memory {torch.cuda.max_memory_allocated()} B")
            del state
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    finally:
        dist.destroy_process_group()
    got = {k: ops[k].launches for k in
           ("flash_attention", "rwkv6_scan", "moe_dispatch")}
    print(f"dtensor launches: {got}")
    return dict(got, ms=ms)


def gpipe_full_width(device) -> dict:
    """(b) GPipe in the one-device form at full width: gemma3-1b's 24
    grouped layers (its 4 repeats of [5 SWA-512 + 1 global]) as
    PIPE_STAGES stages of 6, PIPE_MICRO microbatches of 1 x PIPE_SEQ
    tokens embedded from the pipeline's batch, bf16, kernel path, forward
    and backward; its outputs bit-equal to the same layers run one
    microbatch at a time, its stage-stacked param grads within
    PIPE_GRAD_RTOL (relative L2, by leaf) of theirs. B4 launches
    layers x microbatches a forward pass."""
    import dataclasses
    import gc

    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.mesh import one_device_mesh
    from repro_torch.models import transformer as TF
    from repro_torch.runtime.pipeline import pipeline_forward

    ops = kernel_ops()
    cfg = get_config("gemma3-1b")
    P = len(cfg.pattern)
    params = TF.init_params(cfg, SEED, device)
    layers = params["layers"][:P * PIPE_STAGES]
    specs = TF.layer_specs(cfg)[:P]
    toks = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    global_batch=PIPE_MICRO,
                                    seq_len=PIPE_SEQ)).batch(0)["tokens"]
    with torch.no_grad():
        x = params["tok_embed"][torch.from_numpy(toks).to(device)]
    x = x.reshape(PIPE_MICRO, 1, PIPE_SEQ, cfg.d_model)
    del params
    stacked = [pytree.tree_map(lambda *ts: torch.stack(ts).requires_grad_(),
                               *[layers[s * P + i] for s in range(PIPE_STAGES)])
               for i in range(P)]

    def stage(p, h):
        for i in range(P):
            h, _a, _c = TF.apply_layer(h, p[i], cfg, specs[i])
        return h

    mesh = one_device_mesh((PIPE_STAGES,), ("stage",), device)
    fa = ops["flash_attention"]
    before = fa.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = pipeline_forward(stage, stacked, x, mesh=mesh)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fwd_launches = fa.launches - before
    outs.float().square().mean().backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    outs = outs.detach()
    pipe_grads = [pytree.tree_map(lambda v: v.grad, st) for st in stacked]
    del stacked
    gc.collect()
    ref_layers = [pytree.tree_map(lambda v: v.detach().requires_grad_(), lp)
                  for lp in layers]
    del layers
    t3 = time.perf_counter()
    want = []
    for m in range(PIPE_MICRO):
        h = x[m]
        for j, lp in enumerate(ref_layers):
            h, _a, _c = TF.apply_layer(h, lp, cfg, specs[j % P])
        want.append(h)
    want = torch.stack(want)
    want.float().square().mean().backward()
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    equal = torch.equal(outs, want.detach())
    worst = 0.0
    for i in range(P):
        for s in range(PIPE_STAGES):
            for g, r in zip(pytree.tree_leaves(pipe_grads[i]),
                            pytree.tree_leaves(ref_layers[s * P + i])):
                e = float(torch.linalg.norm(g[s].float() - r.grad.float())
                          / torch.linalg.norm(r.grad.float()))
                worst = max(worst, e)
    print(f"gpipe gemma3-1b: {PIPE_STAGES} stages x {P} layers, "
          f"{PIPE_MICRO} microbatches of 1 x {PIPE_SEQ}, bf16, one-device "
          f"form: forward {(t1 - t0) * 1e3:.3f} ms, backward "
          f"{(t2 - t1) * 1e3:.3f} ms; the layers in sequence forward and "
          f"backward {(t4 - t3) * 1e3:.3f} ms; outputs bit-equal: {equal}; "
          f"B4 launches in the pipeline's forward {fwd_launches} (expected "
          f"{P * PIPE_STAGES * PIPE_MICRO}); param grads, largest relative "
          f"L2 gap {worst:.3e} (tolerance {PIPE_GRAD_RTOL}); peak card "
          f"memory {torch.cuda.max_memory_allocated()} B")
    if not equal:
        raise AssertionError("gpipe: outputs differ from the layers run in "
                             "sequence")
    if fwd_launches != P * PIPE_STAGES * PIPE_MICRO:
        raise AssertionError(f"gpipe: B4 {fwd_launches} launches")
    if not worst <= PIPE_GRAD_RTOL:
        raise AssertionError(f"gpipe: grads differ by {worst}")
    del pipe_grads, ref_layers, want, outs, x
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention": fwd_launches}


def train_rooflines(ms) -> None:
    """(c) The roofline of phase 17's cells on one card: each step traced
    on ``meta`` (no allocation) under ``launch.roofline.DeviceCounter``
    at 1 and 2 pattern repeats and counted over all of them
    (``launch.roofline.over_repeats``), its compute and memory lower
    bounds at the H100's peaks printed
    beside the measured ms a step (phase 17's, and the DTensor trainer's
    of (a)) and their ratio."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import (
        DeviceCounter,
        analyze_counts,
        local_bytes,
        over_repeats,
    )
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step

    def trace(cfg, tcfg, B, S):
        params = M.abstract_params(cfg)
        opt = init_opt_state(tcfg.opt, params)
        batch = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
                 for k in ("tokens", "targets")}
        counter = DeviceCounter()
        with counter:
            out = make_train_step(cfg, tcfg)(params, opt, batch)
        return {**counter.counts(), "param_bytes": local_bytes(params),
                "arg_bytes": local_bytes((params, opt, batch)),
                "out_bytes": local_bytes(out)}

    for arch, cut, opt_kw, B, S, _steps in TRAIN_CELLS:
        cfg = dataclasses.replace(get_config(arch), **cut)
        tcfg = TrainConfig(loss_chunk=0,
                           opt=OptConfig(lr=TRAIN_LR, **opt_kw))
        t0 = time.perf_counter()
        c = over_repeats(lambda r: trace(dataclasses.replace(
            cfg, pattern_repeats=r), tcfg, B, S), cfg.pattern_repeats)
        counter = DeviceCounter()
        counter.add(c)
        meta = dict(arch=arch, kind="train", seq_len=S, global_batch=B,
                    params=cfg.param_count(),
                    active_params=cfg.active_param_count())
        a = analyze_counts(counter, meta, chips=1,
                           param_bytes=int(c["param_bytes"]),
                           arg_bytes=int(c["arg_bytes"]),
                           out_bytes=int(c["out_bytes"]))
        bound = max(a["compute_seconds"], a["memory_seconds"]) * 1e3
        dt_ms, p17_ms = ms[arch]
        print(f"roofline {arch} ({B} x {S}, traced on meta in "
              f"{time.perf_counter() - t0:.3f} s): {a['flops_per_device']:.4e}"
              f" FLOPs a step (model 6ND {a['model_flops']:.4e}), compute "
              f"bound {a['compute_seconds'] * 1e3:.3f} ms at 989 TFLOP/s; "
              f"{a['mem_traffic_per_device']:.4e} B of HBM traffic, memory "
              f"bound {a['memory_seconds'] * 1e3:.3f} ms at 3.35 TB/s; "
              f"measured {p17_ms:.3f} ms a step (phase 17), "
              f"{p17_ms / bound:.3f}x the larger bound; the DTensor "
              f"trainer's {dt_ms:.3f} ms, {dt_ms / bound:.3f}x")


def main_path_slice14(device, step0) -> dict:
    """Phase 18: (a) the DTensor trainer on a one-card NCCL mesh
    (``dtensor_trainer_cells``), (b) GPipe at full width
    (``gpipe_full_width``), (c) the roofline of phase 17's cells
    (``train_rooflines``). Returns the kernels' launches."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    a = dtensor_trainer_cells(device, step0)
    reset_launches()
    b = gpipe_full_width(device)
    train_rooflines(a["ms"])
    return {"flash_attention": a["flash_attention"] + b["flash_attention"],
            "rwkv6_scan": a["rwkv6_scan"],
            "moe_dispatch": a["moe_dispatch"]}


def split_decode_attention(x, p, spec, cache_k, cache_v, pos, ring=False,
                           cache_kpos=None, blocks=SEQ_DECODE_BLOCKS):
    """``layers.decode_attention`` with the cache's rows cut into
    ``blocks`` row blocks on one card, as ``blocks`` ranks along
    ``cache_seq`` hold them: each block through ``layers.decode_rows``
    (the blocks folded into the batch, so one call runs them all), the
    blocks' row max and row sum of exp combined by a max and a sum over
    the blocks in f32, their weighted V partial sums added in the
    activations' dtype, one add at a time, as the collectives do."""
    import torch

    from repro_torch.models import layers as L

    q, positions = L._decode_write(x, p, spec, cache_k, cache_v, pos, ring,
                                   cache_kpos)
    B, S, NKV, HD = cache_k.shape
    t = S // blocks
    G = spec.num_heads // NKV

    def cut(a):  # [B, S, ...] -> [blocks * B, t, ...], block-major
        return a.reshape(B, blocks, t, *a.shape[2:]).transpose(0, 1).reshape(
            blocks * B, t, *a.shape[2:])

    kpos = cut(cache_kpos) if ring else None
    valid = torch.cat([L._valid_rows(
        spec, positions, ring, kpos[i * B:(i + 1) * B] if ring else None,
        i * t, t) for i in range(blocks)])

    def over_blocks(reduce):
        def f(a):
            a = a.reshape(blocks, B, *a.shape[1:])
            return reduce(a).expand_as(a).reshape(blocks * B, *a.shape[2:])
        return f

    qg = q.reshape(B, 1, NKV, G, HD).repeat(blocks, 1, 1, 1, 1)
    parts = L.decode_rows(
        qg, cut(cache_k), cut(cache_v), valid, x.dtype,
        reduce_max=over_blocks(lambda a: a.amax(0, keepdim=True)),
        reduce_sum=over_blocks(lambda a: a.sum(0, keepdim=True)))
    parts = parts.reshape(blocks, B, *parts.shape[1:])
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return L.proj_out(out, p["wo"])


def main_path_slice16(device) -> int:
    """Phase 19: gemma3-1b's decode over a cache cut into row blocks, as
    a sequence-sharded mesh holds it, against the unsplit decode on one
    card (``split_decode_attention``). Returns B4's launches (the
    prefill's)."""
    import copy
    import gc

    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    gc.collect()
    torch.cuda.empty_cache()
    cfg, params = full_model("gemma3-1b", device)
    gen = torch.Generator().manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size, (1, SEQ_DECODE_ROWS - 1),
                           generator=gen).to(device)
    reset_launches()
    t0 = time.time()
    with torch.no_grad():
        logits, cache = M.prefill(params, cfg, prompt,
                                  cache_len=SEQ_DECODE_ROWS)
        torch.cuda.synchronize()
    launches = fa_ops.launches
    if launches != cfg.num_layers:
        raise AssertionError(f"prefill launched flash_attention {launches} "
                             f"times, not {cfg.num_layers}")
    print(f"seq decode: gemma3-1b prefill of {prompt.shape[1]} tokens into "
          f"a {SEQ_DECODE_ROWS}-row cache in {time.time() - t0:.3f} s, "
          f"flash_attention launches {launches}")
    token = logits.argmax(-1)
    pos = cache["pos"].clone()

    def step(attention):
        c = copy.deepcopy(cache)
        orig = L.decode_attention
        L.decode_attention = attention
        try:
            with torch.no_grad():
                out, _ = M.decode_step(params, cfg, c, token)
                ms = []
                for _ in range(SEQ_DECODE_REPEATS):
                    c["pos"].copy_(pos)  # the same token at the same row
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    M.decode_step(params, cfg, c, token)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t) * 1e3)
        finally:
            L.decode_attention = orig
        return out.float(), sorted(ms)[len(ms) // 2]

    whole, whole_ms = step(L.decode_attention)
    split, split_ms = step(split_decode_attention)
    err = (whole - split).abs().max().item()
    print(f"seq decode: one step, batch 1 at row {int(pos[0])} of "
          f"{SEQ_DECODE_ROWS}, median of {SEQ_DECODE_REPEATS}: unsplit "
          f"{whole_ms:.3f} ms, {SEQ_DECODE_BLOCKS} row blocks through "
          f"decode_rows {split_ms:.3f} ms; logits |diff| {err:.6f} "
          f"(largest |logit| {whole.abs().max().item():.4f}, tolerance "
          f"{FIRST_LOGIT_TOL}); {gpu_name_and_power()}")
    if not err <= FIRST_LOGIT_TOL:
        raise AssertionError(f"split decode logits differ by {err}")
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def load_example(name: str):
    """examples/<name>.py as a module (its ``main`` is not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_run(label, fn):
    """``fn()`` with every kernel's count set to 0 just before it; prints
    its wall time and launches per kernel. (fn's result, the counts)."""
    import torch

    reset_launches()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    counts = {name: ops.launches for name, ops in kernel_ops().items()}
    print(f"example {label}: {time.time() - t0:.3f} s, kernel launches "
          f"{counts}; {gpu_name_and_power()}")
    return out, counts


def example_quickstart(device) -> tuple:
    """examples/torch_quickstart.py at its own sizes: section 1's orthrus
    cell (B1 once a step) equal to its plain path's, section 2's plan (one
    B3 launch) equal to ``plan_dispatch``'s. (launches, B3's largest
    slot-weight difference)."""
    import torch

    from repro_torch.core.engine import EngineConfig, run_simulation
    from repro_torch.core.workloads import WorkloadConfig, make_workload
    from repro_torch.models.moe import plan_dispatch

    q = load_example("torch_quickstart")
    probs = q.router_probs(device)

    def run():
        return q.contention(device), q.dispatch(probs)

    (cells, got), counts = example_run("torch_quickstart", run)
    label = "ORTHRUS (P1+P2)"
    steps = cells[label].raw["steps_executed"]
    plain = run_simulation(
        EngineConfig(**q.ENGINES[label], **q.SIM, kernel_impl="jnp"),
        make_workload(WorkloadConfig(**q.WORKLOAD)), device=device)
    same = fingerprint(cells[label], True) == fingerprint(plain, True)
    print(f"example torch_quickstart: orthrus {steps} steps, lock_grant "
          f"launches {counts['lock_grant']}, kernel and plain fingerprints "
          f"{'identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("quickstart's orthrus cell differs on the "
                             "plain path")
    want = plan_dispatch(probs, 1, q.CAPACITY)
    equal = all(torch.equal(got[k], want[k]) for k in ("slot_token", "load"))
    w_err = float((got["slot_weight"] - want["slot_weight"]).abs().max())
    empty = int((got["slot_token"] < 0).sum())
    print(f"example torch_quickstart: B3's plan (N {probs.shape[0]}, E "
          f"{probs.shape[1]}, top 1, capacity {q.CAPACITY}; {empty} empty "
          f"slots) against plan_dispatch: slot_token and load "
          f"{'equal' if equal else 'DIFFER'}, slot_weight max |diff| "
          f"{w_err} (tolerance {EXAMPLE_PLAN_WEIGHT_TOL}); moe_dispatch "
          f"launches {counts['moe_dispatch']}")
    if not (equal and w_err <= EXAMPLE_PLAN_WEIGHT_TOL):
        raise AssertionError("quickstart's plan differs from plan_dispatch's")
    if counts["lock_grant"] != steps or counts["moe_dispatch"] != 1:
        raise AssertionError("quickstart: lock_grant did not launch once a "
                             "step, or moe_dispatch not once")
    return counts, w_err


def example_demo(device) -> dict:
    """examples/torch_oltp_contention_demo.py at its REPRO_DEMO_FAST
    budget: every dgcc and quecc cell (B2 once a step) equal to the same
    cell on the plain path."""
    import dataclasses

    from repro_torch.core.engine import run_simulation
    from repro_torch.core.workloads import make_workload

    d = load_example("torch_oltp_contention_demo")
    stanzas, counts = example_run("torch_oltp_contention_demo (fast)",
                                  lambda: d.demo(device, fast=True))
    workloads, steps, held = {}, 0, 0
    for name, cells in stanzas.items():
        for cfg, wcfg, res in cells:
            if not cfg.is_batch_planned:
                continue
            steps += res.raw["steps_executed"]
            if wcfg not in workloads:
                workloads[wcfg] = make_workload(wcfg)
            plain = run_simulation(dataclasses.replace(cfg, kernel_impl="jnp"),
                                   workloads[wcfg], device=device)
            if fingerprint(res, True) != fingerprint(plain, True):
                raise AssertionError(f"demo {name}: {cfg.protocol} cell "
                                     f"differs on the plain path")
            held += 1
    print(f"example torch_oltp_contention_demo: {held} dgcc and quecc cells "
          f"identical on the plain path (metrics incl.); dep_wavefront "
          f"launches {counts['dep_wavefront']} in {steps} steps")
    if counts["dep_wavefront"] != steps or steps == 0:
        raise AssertionError("dep_wavefront did not launch once a step")
    return counts


def example_serve(device) -> dict:
    """examples/torch_serve_lm.py: its ``main`` (SMOKE mixtral-8x22b, bf16,
    10 requests through 4 slots) on the kernel path, then the same
    weights in float32 on the kernel and the plain path: the same
    tokens; where one differs, the two paths' logits at that token
    within SLICE9_F32_TOL (a near tie)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M

    s = load_example("torch_serve_lm")
    _, counts = example_run("torch_serve_lm", lambda: s.main([]))
    cfg = get_smoke_config(s.ARCH)
    f32 = dataclasses.replace(cfg, dtype="float32")
    params = M.init_params(f32, 0, device)
    outs = {}
    for impl in ("auto", "jnp"):
        done, _ = s.serve(f32, params, device, s.make_requests(f32),
                          kernel_impl=impl)
        outs[impl] = {r.rid: (r.prompt, r.output) for r in done}
    gaps = []
    for rid, (prompt, toks) in outs["auto"].items():
        plain = outs["jnp"][rid][1]
        if toks == plain:
            continue
        t = next(i for i, (a, b) in enumerate(zip(toks, plain)) if a != b)
        seq = torch.as_tensor([list(prompt) + toks[:t]], device=device)
        with torch.no_grad():
            last = [M.prefill(params, f32, seq, kernel_impl=impl)[0][0, -1]
                    for impl in ("auto", "jnp")]
        gap = float((last[0] - last[1]).abs().max())
        gaps.append(gap)
        print(f"example torch_serve_lm f32: request {rid} differs at token "
              f"{t} ({toks[t]} against {plain[t]}): logits |diff| {gap}")
        if not gap <= SLICE9_F32_TOL:
            raise AssertionError(f"serve_lm f32: request {rid}'s logits "
                                 f"differ by {gap} > {SLICE9_F32_TOL}")
    print(f"example torch_serve_lm f32: {len(outs['auto']) - len(gaps)} of "
          f"{len(outs['auto'])} requests token for token on the kernel and "
          f"the plain path")
    layers = cfg.num_layers
    print(f"example torch_serve_lm: {layers} layers, flash_attention "
          f"launches {counts['flash_attention']} (= {layers} x "
          f"{s.N_REQUESTS} prefills), moe_dispatch {counts['moe_dispatch']}")
    if counts["flash_attention"] != layers * s.N_REQUESTS or \
            counts["moe_dispatch"] <= layers * s.N_REQUESTS or \
            counts["moe_dispatch"] % layers:
        raise AssertionError("serve_lm: B3 or B4 launched other than once "
                             "a layer a prefill (and, B3, a decode step)")
    return counts


def example_train(device, steps=EXAMPLE_TRAIN_STEPS) -> dict:
    """examples/torch_train_lm.py (SMOKE gemma3-1b, batch 8 x 64) for
    ``steps`` steps: B4 twice a self-attention layer a step; the state
    restored halfway equal, leaf for leaf and bit for bit, to the state
    saved at that step; the loss falls."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_smoke_config

    t = load_example("torch_train_lm")

    class Recording(Checkpointer):
        saved, restored = {}, None

        def maybe_save(self, step, tree, force=False):
            done = super().maybe_save(step, tree, force)
            if done:
                Recording.saved[step] = pytree.tree_map(torch.clone, tree)
            return done

        def restore_latest(self, target_tree, device=None):
            step, tree = super().restore_latest(target_tree, device)
            Recording.restored = (step, pytree.tree_map(torch.clone, tree))
            return step, tree

    out, counts = example_run(
        "torch_train_lm", lambda: t.train(
            t.parse_args(["--steps", str(steps)]), checkpointer=Recording))
    step, tree = Recording.restored
    got, want = pytree.tree_leaves(tree), pytree.tree_leaves(
        Recording.saved[step])
    same = len(got) == len(want) and all(
        a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
        for a, b in zip(got, want))
    layers = get_smoke_config(t.parse_args([]).arch).num_layers
    print(f"example torch_train_lm: {steps} steps, loss {out['first']:.4f} "
          f"-> {out['last']:.4f}; resumed from step {step}: {len(got)} "
          f"leaves {'bit-equal' if same else 'DIFFER'} to the saved state; "
          f"flash_attention launches {counts['flash_attention']} (2 x "
          f"{layers} layers x {steps} steps)")
    if not same or out["resumed_from"] != step:
        raise AssertionError("train_lm: the resumed state is not the saved "
                             "state")
    if not out["last"] < out["first"]:
        raise AssertionError("train_lm: the loss did not fall")
    if counts["flash_attention"] != 2 * layers * steps:
        raise AssertionError("train_lm: flash_attention did not launch "
                             "twice a layer a step")
    return counts


def main_path_slice17(device) -> dict:
    """Phase 20: the four examples in-process on the card, each held as
    the functions above say. Returns each kernel's launches over the
    four and B3's largest slot-weight difference."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    quick, b3_err = example_quickstart(device)
    runs = [quick, example_demo(device), example_serve(device),
            example_train(device)]
    total = {name: sum(c[name] for c in runs) for name in runs[0]}
    for name in ("lock_grant", "dep_wavefront", "flash_attention",
                 "moe_dispatch"):
        if total[name] == 0:
            raise AssertionError(f"the examples never launched {name}")
    print(f"slice 17 examples: kernel launches {total}")
    return dict(total, b3_err=b3_err)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> None:
    """Phase 1: every kernel's library, one nvcc per source, together."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    from repro_torch.kernels.dep_wavefront import ops as dw_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.lock_grant import ops as lg_ops
    from repro_torch.kernels.moe_dispatch import ops as md_ops
    from repro_torch.kernels.rwkv6_scan import ops as rw_ops

    t0 = time.time()
    builds = {"lock_grant": lg_ops._library,
              "lock_grant_tile": lg_ops._tile_library,
              "dep_wavefront": dw_ops._library,
              "dep_wavefront_tile": dw_ops._tile_library,
              "flash_attention": fa_ops._library,
              "flash_attention_simt": fa_ops._simt_library,
              "rwkv6_scan": rw_ops._library,
              "rwkv6_scan_chain": rw_ops._chain_library,
              "moe_dispatch": md_ops._library}
    with ThreadPoolExecutor(len(builds)) as pool:
        for f in [pool.submit(build) for build in builds.values()]:
            f.result()
    for name in builds:
        secs, log = _build.BUILD_LOG.get(name, (0.0, "(cached)"))
        print(f"build: lib{name} in {secs:.3f} s\n{log.strip()}")
    print(f"build: all five kernels (B4 as two libraries: bf16 on the "
          f"tensor cores, f32 on the CUDA cores; B1, B2 and B5 beside "
          f"their earlier designs) built and loaded in "
          f"{time.time() - t0:.3f} s")


def main() -> int:
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch.kernels  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package is missing ({exc})",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    power = gpu_name_and_power()
    print(power)

    t_all = time.time()

    def phase(name, fn, *args, **kw):
        t0 = time.time()
        out = fn(*args, **kw)
        print(f"phase {name}: {time.time() - t0:.3f} s")
        return out

    phase("build", build_kernels)
    model = phase("model: gemma3-1b", full_model, "gemma3-1b", device)
    rwkv = phase("model: rwkv6-1.6b", full_model, "rwkv6-1.6b", device)
    mixtral = phase("model: mixtral-8x22b", full_model, "mixtral-8x22b",
                    device, **MIXTRAL_CUT)
    caps = phase("capture: mixtral-8x22b", capture_mixtral, device, mixtral)
    rows = [phase("kernels: lock_grant", check_lock_grant, device),
            phase("kernels: dep_wavefront", check_dep_wavefront, device),
            phase("kernels: flash_attention", check_flash_attention, device,
                  model, caps["attn"]),
            phase("kernels: rwkv6_scan", check_rwkv6_scan, device, rwkv),
            phase("kernels: moe_dispatch", check_moe_dispatch, device, caps)]
    del caps
    phase("goldens", replay_goldens, device)
    rows[0]["launches"] = phase("main path, slice 1", main_path_slice1,
                                device)
    rows[1]["launches"] = phase("main path, slice 2", main_path_slice2,
                                device)
    rows[2]["launches"] = phase("main path, slice 3", main_path_slice3,
                                device, model)
    rows[3]["launches"] = phase("main path, slice 4", main_path_slice4,
                                device, rwkv)
    slice5 = phase("main path, slice 5", main_path_slice5, device, mixtral)
    rows[4]["launches"] = slice5["moe_dispatch"]
    rows[2]["launches"] += slice5["flash_attention"]
    # phase 13 needs the card to itself (qwen3-32b's 65.5 GB of weights)
    del model, rwkv, mixtral
    gc.collect()
    torch.cuda.empty_cache()
    phase("main path, slice 7", main_path_slice7, device)
    open_counts = phase("main path, slice 7: open arrival",
                        main_path_slice7_open, device)
    rows[0]["launches"] += open_counts["lock_grant"]
    rows[1]["launches"] += open_counts["dep_wavefront"]
    k_counts = phase("main path, slice 7: K-fused dispatch",
                     main_path_slice7_kfused, device)
    rows[0]["launches"] += k_counts["lock_grant"]
    rows[1]["launches"] += k_counts["dep_wavefront"]
    sweep_counts = phase("main path, slice 8: the multi-cell sweep",
                         main_path_slice8_sweep, device)
    rows[0]["launches"] += sweep_counts["lock_grant"]
    rows[1]["launches"] += sweep_counts["dep_wavefront"]
    rows[2]["launches"] += phase("main path, slice 9: the other archs' "
                                 "serving", main_path_slice9, device)
    legacy_counts = phase("main path, slice 10: the legacy layout and the "
                          "latency oracle", main_path_slice10, device)
    rows[0]["launches"] += legacy_counts["lock_grant"]
    rows[1]["launches"] += legacy_counts["dep_wavefront"]
    slice11 = phase("main path, slice 11: llama4-maverick and per-shard MoE "
                    "dispatch", main_path_slice11, device)
    rows[4]["launches"] += slice11["moe_dispatch"]
    rows[2]["launches"] += slice11["flash_attention"]
    rows[4]["max_abs_err"] = max(rows[4]["max_abs_err"], slice11["b3_err"])
    rows[2]["max_abs_err"] = max(rows[2]["max_abs_err"], slice11["b4_err"])
    slice12 = phase("main path, slice 12: distributed ORTHRUS",
                    main_path_slice12, device)
    rows[0]["launches"] += slice12["lock_grant"]
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"], slice12["b1_err"])
    slice13 = phase("main path, slice 13: training", main_path_slice13,
                    device)
    rows[2]["launches"] += slice13["flash_attention"]
    rows[3]["launches"] += slice13["rwkv6_scan"]
    rows[4]["launches"] += slice13["moe_dispatch"]
    slice14 = phase("main path, slice 14: the DTensor trainer, GPipe and "
                    "the roofline", main_path_slice14, device,
                    slice13["step0"])
    rows[2]["launches"] += slice14["flash_attention"]
    rows[3]["launches"] += slice14["rwkv6_scan"]
    rows[4]["launches"] += slice14["moe_dispatch"]
    rows[2]["launches"] += phase("main path, slice 16: decode over a "
                                 "sequence-sharded cache", main_path_slice16,
                                 device)
    slice17 = phase("main path, slice 17: the examples", main_path_slice17,
                    device)
    for row in rows:
        row["launches"] += slice17[row["name"]]
    rows[4]["max_abs_err"] = max(rows[4]["max_abs_err"], slice17["b3_err"])
    print(f"all phases: {time.time() - t_all:.3f} s")

    print(json.dumps({"kernels": rows}))
    print(power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
