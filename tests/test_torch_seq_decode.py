"""Decode over a sequence-sharded KV cache: the port's flash-decode plan.

Where the sharding rules shard the cache along its rows (``cache_seq``:
KV heads that do not divide ``model``, or a batch that does not divide
the data axes), ``layers.decode_attention`` runs each rank's rows through
``layers.decode_rows``: the row max and the row sum of exp reduced once
each in f32, the weighted V partial sum once in the activation dtype, as
the JAX package's compiled step partitions its softmax.

* gemma3-1b SMOKE's decode_32k cell (1 KV head: the cache's rows shard
  over ``model``) on a 2 x 2 (``data``, ``model``) mesh, the port's dry
  run against the JAX package's compiled step
  (``tools/torch_collective_compare.py``): collective bytes per device
  between 0.5x and 1.10x of the reference's at its own dtypes, FLOPs
  within 5%. Measured: 2.928e5 against 3.545e5 (0.826x); 4.221e7
  (119x) while DTensor's softmax gathered the f32 scores.
* On a ``fake`` 2 x 2 mesh under ``launch.roofline.DeviceCounter``, the
  same cell with its cache's rows over ``model``, over the data axes and
  ``model`` (the rules' tiny-batch layout), and with ring caches for the
  SWA layers: no all-gather, all-reduce or reduce-scatter carries a
  tensor whose last dimension is a cache's row count (whole or a rank's
  share), and every f32 collective is a row statistic (last dims 1, 1).
* On 4 gloo ranks at (2, 2) in float32, three decode steps after a
  prefill: the sharded step's logits equal the unsharded step's within
  1e-5 of their largest value, for the cache's rows over ``model`` and
  over the data axes and ``model``, each with linear and with ring SWA
  caches (the ring wrapped: 20 prompt tokens, window 16).
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from tools.torch_collective_compare import compare  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
FLOPS_RTOL = 0.05
RATIO = (0.5, 1.10)  # port / reference collective bytes, decode
LOGIT_RTOL = 1e-5


def test_gemma_seq_sharded_decode_sends_what_jax_sends(runs):
    port, ref = runs["compare"]
    got, want = port["gemma3-1b/decode_32k"], ref["gemma3-1b/decode_32k"]
    lo, hi = RATIO
    assert want["coll_own"] > 0
    assert lo * want["coll_own"] <= got["coll"] <= hi * want["coll_own"], (
        got, want)
    assert abs(got["flops"] - want["flops"]) <= FLOPS_RTOL * want["flops"], (
        got["flops"], want["flops"])


FAKE_RUN = """
import dataclasses, json, sys
sys.path.insert(0, {src!r})
import torch
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.launch import dryrun as D
from repro_torch.launch.roofline import DeviceCounter
from repro_torch.sharding import ctx


class Log(DeviceCounter):
    # each counted collective: [kind, dtype, output shape]
    def __init__(self):
        super().__init__()
        self.log = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        n = self.collective_instructions
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self.collective_instructions > n:
            self.log.append([self.collectives[func][0],
                             str(out.dtype).split(".")[-1], list(out.shape)])
        return out


mesh = D.fake_mesh((2, 2), ("data", "model"))
cfg = D.get_smoke_config("gemma3-1b")
cases = {{
    "model": {{}},
    "data": {{"rules_override": {{"batch": None,
                                "cache_seq": ("pod", "data", "model")}}}},
    "ring": {{"mcfg_override": dataclasses.replace(cfg,
                                                  swa_ring_cache=True)}},
}}
out = {{}}
for name, kw in cases.items():
    fn, args, rules, _, c, _ = D.build_cell("gemma3-1b", "decode_32k", mesh,
                                            smoke=True, **kw)
    caches = [e["k"] for e in args[1]["layers"]]
    shares = []
    for k in caches:
        n = 1
        for m, p in enumerate(k.placements):
            if p.is_shard(1):
                n *= mesh.device_mesh.shape[m]
        shares.append(n)
    log = Log()
    with implicit_replication(), ctx.use(mesh, rules), log:
        fn(log, *args)
    out[name] = {{"log": log.log,
                 "rows": sorted({{k.shape[1] for k in caches}}
                                | {{k.shape[1] // n for k, n in
                                   zip(caches, shares)}}),
                 "shares": shares}}
print("FAKE " + json.dumps(out))
"""


@pytest.mark.parametrize("case", ["model", "data", "ring"])
def test_no_collective_carries_cache_rows(runs, case):
    res = runs["fake"][case]
    # the case shards every layer's cache along its rows
    assert all(n > 1 for n in res["shares"]), res["shares"]
    rows = set(res["rows"])
    moved = [e for e in res["log"] if e[0] in ("all-gather", "all-reduce",
                                               "reduce-scatter")]
    assert moved
    for kind, dt, shape in moved:
        assert not shape or shape[-1] not in rows, (case, kind, dt, shape)


@pytest.mark.parametrize("case", ["model", "data", "ring"])
def test_f32_collectives_are_row_statistics(runs, case):
    # the row max and the row sum of exp, [b, kv, g, 1, 1]; the weighted
    # V partial sum and the rest in the activations' bf16
    log = runs["fake"][case]["log"]
    f32 = [e for e in log if e[1] == "float32"]
    assert f32 and all(e[0] == "all-reduce" and e[2][-2:] == [1, 1]
                       for e in f32), f32
    assert any(e[0] == "all-reduce" and e[1] == "bfloat16"
               and len(e[2]) == 4 for e in log), log


GLOO_RUN = """
import dataclasses
import json
import sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, {src!r})


def work(rank, store, q):
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=4)
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import process_mesh
    from repro_torch.models import model as M
    from repro_torch.sharding import ctx
    from repro_torch.sharding import policies as SH
    mesh = process_mesh((2, 2), ("data", "model"))
    base = dataclasses.replace(get_smoke_config("gemma3-1b"),
                               dtype="float32")
    res = {{}}
    # batch 2 divides data: the rows over model (1 kv head); batch 1
    # does not: the rows over the data axes and model
    for ring in (False, True):
        cfg = dataclasses.replace(base, swa_ring_cache=ring)
        params = M.init_params(cfg, seed=0, device="cpu")
        for batch in (2, 1):
            name = f"b{{batch}}" + ("_ring" if ring else "")
            gen = torch.Generator().manual_seed(batch)
            prompt = torch.randint(0, cfg.vocab_size, (batch, 20),
                                   generator=gen)
            steps = torch.randint(0, cfg.vocab_size, (3, batch, 1),
                                  generator=gen)
            _, cache = M.prefill(params, cfg, prompt, cache_len=32)
            rules = SH.rules_for(cfg, "decode", batch, mesh)
            dparams = SH.distribute(params, SH.params_sharding(
                cfg, mesh, rules, params))
            # a copy: a replicated DTensor shares its tensor's storage,
            # and the unsharded steps below write their cache in place
            dcache = SH.distribute(pytree.tree_map(torch.clone, cache),
                                   SH.cache_sharding(cfg, mesh, rules,
                                                     cache))
            shards = [sum(p.is_shard(1) for p in e["k"].placements)
                      for e in dcache["layers"]]
            errs = []
            for tok in steps:
                want, cache = M.decode_step(params, cfg, cache, tok)
                dtok = SH.distribute({{"t": tok}}, SH.batch_sharding(
                    mesh, rules, {{"t": tok}}))["t"]
                with implicit_replication(), ctx.use(mesh, rules):
                    got, dcache = M.decode_step(dparams, cfg, dcache, dtok)
                errs.append(((got.full_tensor() - want).abs().max()
                             / want.abs().max()).item())
            res[name] = {{"errs": errs, "shards": shards,
                         "cache_seq": rules["cache_seq"]}}
    q.put((rank, res))
    dist.destroy_process_group()


if __name__ == "__main__":
    ctx_ = mp.get_context("spawn")
    q = ctx_.Queue()
    ps = [ctx_.Process(target=work, args=(r, sys.argv[1], q))
          for r in range(4)]
    for p in ps:
        p.start()
    res = dict(q.get(timeout=240) for _ in ps)
    for p in ps:
        p.join(30)
    print("GLOO " + json.dumps([res[r] for r in range(4)]))
"""


@pytest.mark.parametrize("case", ["b2", "b1", "b2_ring", "b1_ring"])
def test_sharded_decode_equals_unsharded(runs, case):
    for rank in runs["gloo"]:
        res = rank[case]
        # every layer's cache sharded along its rows: over model (one
        # mesh axis) at batch 2, over data and model at batch 1
        assert all(n == (1 if case.startswith("b2") else 2)
                   for n in res["shards"]), res
        assert len(res["errs"]) == 3
        assert all(e <= LOGIT_RTOL for e in res["errs"]), res


def _script(tmp, name, text, tag, *args):
    """Run ``text`` (formatted with the source path) as a script and
    return what it printed after ``tag``."""
    script = tmp / f"{name}.py"
    script.write_text(textwrap.dedent(text.format(src=SRC)))
    r = subprocess.run([sys.executable, str(script), *args],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout + r.stderr[-4000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith(tag + " ")]
    return json.loads(line[-1][len(tag) + 1:])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three runs side by side: the gemma3-1b comparison (two
    subprocesses), the fake mesh's script and the gloo spawn."""
    tmp = tmp_path_factory.mktemp("seq_decode")
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        jobs = {
            "compare": pool.submit(compare, ["gemma3-1b"], ["decode_32k"],
                                   workdir=str(tmp)),
            "fake": pool.submit(_script, tmp, "fake", FAKE_RUN, "FAKE"),
            "gloo": pool.submit(_script, tmp, "gloo", GLOO_RUN, "GLOO",
                                str(tmp / "store"))}
        return {k: f.result() for k, f in jobs.items()}
