"""The port's collective plan under a mesh: what each sharded site sends.

* mixtral-8x22b SMOKE's train, prefill and decode cells on a 2 x 2
  (``data``, ``model``) mesh, the port's dry run against the JAX
  package's compiled step (``tools/torch_collective_compare.py``: the two
  side by side in subprocesses; the reference's bytes at the dtypes its
  collectives had before XLA's CPU backend promoted bf16 ones to f32, as
  a TPU or GPU compile keeps them): the port's collective bytes per
  device between 0.5x and 1.25x (train) or 1.10x (prefill, decode) of
  the reference's, and its FLOPs per device within 5%. Measured:
  2.436e9 against 2.594e9 (0.939x), 5.957e8 against 9.145e8 (0.651x),
  2.213e5 against 2.492e5 (0.888x); before the port reduced each partial
  sum once and moved only the MoE's slots, 2.972x, 1.982x and 2.310x.
* On a ``fake`` 2 x 2 mesh, every tensor on ``meta``, under
  ``launch.roofline.DeviceCounter`` (each collective's kind, dtype and
  shape logged): a ``local_call`` with a contracted axis returns no
  ``Partial`` placement and reduces once, in the bf16 it was given;
  ``_token_ce`` gives the unsharded shape and dtype and moves no tensor
  of the logits' [s, V/model] trailing shape, forward or backward; no
  all-reduce or reduce-scatter of an activation (the model's width
  last) runs in f32 in the six SMOKE cells of qwen3-32b and
  mixtral-8x22b (their params are bf16); and the MoE gathers neither its
  tokens nor its slot blocks.
* On 4 gloo ranks at (2, 2) in float32: ``_token_ce`` and its gradient
  under the context equal the unsharded ones within 1e-6,
  ``proj_out``'s reduced output equals the unsharded product, and
  mixtral's MoE layer (its output, and its input's and weights'
  gradients relative to their largest) equals the unsharded layer within
  1e-5 under both of ``moe._sharded_slots``'s combines.
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from tools.torch_collective_compare import CELLS, compare  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
FLOPS_RTOL = 0.05
# the port's collective bytes per device over the reference's (at its
# own dtypes), by cell
MIXTRAL_RATIO = {"train_4k": (0.5, 1.25), "prefill_32k": (0.5, 1.10),
                 "decode_32k": (0.5, 1.10)}


@pytest.mark.parametrize("cell", CELLS)
def test_mixtral_smoke_cell_sends_what_jax_sends(runs, cell):
    port, ref = runs["mixtral"]
    got, want = port[f"mixtral-8x22b/{cell}"], ref[f"mixtral-8x22b/{cell}"]
    lo, hi = MIXTRAL_RATIO[cell]
    assert want["coll_own"] > 0
    assert lo * want["coll_own"] <= got["coll"] <= hi * want["coll_own"], (
        cell, got, want)
    assert abs(got["flops"] - want["flops"]) <= FLOPS_RTOL * want["flops"], (
        cell, got["flops"], want["flops"])


FAKE_RUN = """
import json, sys
sys.path.insert(0, {src!r})
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.launch import dryrun as D
from repro_torch.launch.roofline import DeviceCounter
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as TF
from repro_torch.optim import OptConfig
from repro_torch.sharding import ctx
from repro_torch.train import TrainConfig


class Log(DeviceCounter):
    # each counted collective: [kind, dtype, output shape, site], the site
    # "moe" inside apply_moe's forward (or its recompute), else ""
    site = []

    def __init__(self):
        super().__init__()
        self.log = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        n = self.collective_instructions
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self.collective_instructions > n:
            self.log.append([self.collectives[func][0],
                             str(out.dtype).split(".")[-1], list(out.shape),
                             "".join(self.site[-1:])])
        return out


def at_site(fn, name):
    def wrapped(*a, **k):
        Log.site.append(name)
        try:
            return fn(*a, **k)
        finally:
            Log.site.pop()
    return wrapped


MOE.apply_moe = at_site(MOE.apply_moe, "moe")


mesh = D.fake_mesh((2, 2), ("data", "model"))
dm = mesh.device_mesh
out = {{}}


def meta(shape, placements, dtype=torch.bfloat16):
    return distribute_tensor(torch.empty(shape, dtype=dtype, device="meta"),
                             dm, placements, src_data_rank=None)


_, args, rules, _, cfg, _ = D.build_cell("qwen3-32b", "train_4k", mesh,
                                         smoke=True)
params = args[0]
with implicit_replication(), ctx.use(mesh, rules):
    # proj_out: heads sharded over model, a partial sum over them
    o = meta((8, 16, 4, 16), [Shard(0), Shard(2)])
    w = meta((4, 16, 64), [Replicate(), Shard(0)])
    log = Log()
    with log:
        y = L.proj_out(o, w)
    out["proj_out"] = {{"placements": [str(p) for p in y.placements],
                       "dtype": str(y.dtype).split(".")[-1],
                       "log": log.log}}
    # one chunk's cross entropy, forward and backward
    B, s, V = 16, 512, cfg.vocab_size
    x = meta((B, s, cfg.d_model), [Shard(0), Replicate()]).requires_grad_()
    t = meta((B, s), [Shard(0), Replicate()], torch.int32)
    log = Log()
    with log:
        ce = TF._token_ce(params, cfg, x, t)
        (g,) = torch.autograd.grad(ce.sum(), x)
    out["ce"] = {{"shape": list(ce.shape),
                 "dtype": str(ce.dtype).split(".")[-1],
                 "grad": list(g.shape), "V": V, "s": s,
                 "model": mesh.shape["model"], "log": log.log}}

# the six SMOKE cells' collectives
tcfg = TrainConfig(microbatches=8, remat_policy="dots", opt=OptConfig())
logs = {{}}
for arch in ("qwen3-32b", "mixtral-8x22b"):
    c = D.get_smoke_config(arch)
    for cell in ("train_4k", "prefill_32k", "decode_32k"):
        fn, args, rules, _, _, _ = D.build_cell(arch, cell, mesh, smoke=True,
                                                tcfg=tcfg)
        counter = Log()
        with implicit_replication(), ctx.use(mesh, rules), counter:
            fn(counter, *args)
        logs[arch + "/" + cell] = {{"log": counter.log, "D": c.d_model}}
out["cells"] = logs
print("FAKE " + json.dumps(out))
"""


def test_local_call_reduces_a_partial_sum_once_in_its_dtype(runs):
    res = runs["fake"]["proj_out"]
    assert not any("Partial" in p for p in res["placements"]), res
    assert res["dtype"] == "bfloat16"
    reduces = [e[:3] for e in res["log"] if e[0] != "all-gather"]
    # one all-reduce of the [B, S, D] output over the model axis, in bf16
    assert reduces == [["all-reduce", "bfloat16", [4, 16, 64]]], res["log"]


def test_token_ce_moves_no_logits(runs):
    res = runs["fake"]["ce"]
    assert res["shape"] == [16, 512] and res["dtype"] == "float32"
    assert res["grad"] == [16, 512, 64]
    s, V, n = res["s"], res["V"], res["model"]
    for kind, _dt, shape, _site in res["log"]:
        assert tuple(shape[-2:]) not in ((s, V // n), (s, V)), (kind, shape)
    # what the loss itself reduces: rows of numbers, never logits
    rows = [e for e in res["log"] if e[2][-1] not in (V // n, V)
            and len(e[2]) == 2]
    assert rows and all(e[1] == "float32" for e in rows), res["log"]


@pytest.mark.parametrize("cell", [f"{a}/{c}" for a in ("qwen3-32b",
                                                        "mixtral-8x22b")
                                  for c in CELLS])
def test_no_activation_sized_reduction_runs_in_f32(runs, cell):
    # an activation: the model's width D last (a weight's gradient, the
    # router's f32 slot weights and the loss's rows are not)
    entry = runs["fake"]["cells"][cell]
    acts = [e for e in entry["log"] if e[0] in ("all-reduce",
                                                "reduce-scatter")
            and len(e[2]) > 1 and e[2][-1] == entry["D"]]
    assert acts, entry["log"]
    assert all(e[1] == "bfloat16" for e in acts), (cell, acts)


@pytest.mark.parametrize("cell", CELLS)
def test_the_moe_gathers_no_tokens_and_no_outputs(runs, cell):
    # in apply_moe's forward the gathers are the probabilities' ([tokens,
    # E]) and the expert weights' (along D, or their hidden units); the
    # slots move by a reduce-scatter and the outputs by a reduction onto
    # their tokens' ranks
    entry = runs["fake"]["cells"][f"mixtral-8x22b/{cell}"]
    D = entry["D"]
    moe = [e for e in entry["log"] if e[3] == "moe"]
    assert any(e[0] == "reduce-scatter" for e in moe), moe
    for kind, _dt, shape, _site in moe:
        if kind == "all-gather":
            assert not (len(shape) == 2 and shape[-1] in (D, D // 2)), (
                cell, shape)  # tokens
            assert not (len(shape) == 3 and shape[-1] == D), (
                cell, shape)  # slot blocks


GLOO_CE = """
import json
import sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, {src!r})


def work(rank, store, q):
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=4)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import process_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TF
    from repro_torch.models.model import init_params
    from repro_torch.sharding import ctx
    from repro_torch.sharding import policies as SH
    import dataclasses
    mesh = process_mesh((2, 2), ("data", "model"))
    dm = mesh.device_mesh
    cfg = dataclasses.replace(get_smoke_config("qwen3-32b"),
                              dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    rules = SH.rules_for(cfg, "train", 4, mesh)
    dparams = SH.distribute(params, SH.params_sharding(cfg, mesh, rules,
                                                       params))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, 32, cfg.d_model, generator=gen)
    t = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen)
    x.requires_grad_()
    want = TF._token_ce(params, cfg, x, t)
    (gwant,) = torch.autograd.grad(want.sum(), x)
    rows = (Shard(0), Replicate())  # batch over data
    xd = distribute_tensor(x.detach(), dm, rows).requires_grad_()
    td = distribute_tensor(t, dm, rows)
    o = torch.randn(4, 32, cfg.num_heads, cfg.head_dim, generator=gen)
    wo = params["layers"][0]["attn"]["wo"]
    with implicit_replication(), ctx.use(mesh, rules):
        got = TF._token_ce(dparams, cfg, xd, td)
        (ggot,) = torch.autograd.grad(got.sum(), xd)
        od = ctx.constrain(distribute_tensor(o, dm, rows),
                           ("batch", "seq", "heads_act", "head_dim"))
        y = L.proj_out(od, dparams["layers"][0]["attn"]["wo"])
    ce_err = (got.full_tensor() - want).abs().max().item()
    g_err = (ggot.full_tensor() - gwant).abs().max().item()
    y_err = (y.full_tensor() - torch.einsum("bsnh,nhd->bsd", o, wo)
             ).abs().max().item()
    partial = any(p.is_partial() for p in y.placements)
    # the MoE layer: its output and its input's and weights' gradients,
    # at a capacity factor whose slots a rank holds are fewer than the
    # tokens (the outputs gathered) and at one where they are more (the
    # sum reduce-scattered)
    mcfg = dataclasses.replace(get_smoke_config("mixtral-8x22b"),
                               dtype="float32")
    mp_ = init_params(mcfg, seed=0, device="cpu")["layers"][0]["moe"]
    mrules = SH.rules_for(mcfg, "train", 4, mesh)
    maxes = {{"router": ("embed", "experts"),
             "wi": ("experts", "embed", "expert_mlp"),
             "wo": ("experts", "expert_mlp", "embed"),
             "wg": ("experts", "embed", "expert_mlp")}}
    xm = torch.randn(4, 256, mcfg.d_model, generator=gen)
    moe_err = []
    for cf in (0.25, 1.25):
        def run(x_, p_):
            out, aux = MOE.apply_moe(x_, p_, top_k=2, capacity_factor=cf)
            return out, torch.autograd.grad(
                (out * out).sum() + aux, [x_, *p_.values()])
        xw = xm.clone().requires_grad_()
        pw = {{k: v.clone().requires_grad_() for k, v in mp_.items()}}
        want_o, want_g = run(xw, pw)
        xs = distribute_tensor(xm, dm, rows).requires_grad_()
        ps = {{k: distribute_tensor(v, dm, SH.spec_for(
            maxes[k], tuple(v.shape), mesh, mrules).placements()
        ).requires_grad_() for k, v in mp_.items()}}
        with implicit_replication(), ctx.use(mesh, mrules):
            got_o, got_g = run(xs, ps)
        moe_err.append(max([(got_o.full_tensor() - want_o).abs().max().item()]
                           + [((a.full_tensor() - b).abs().max()
                               / b.abs().max()).item()
                              for a, b in zip(got_g, want_g)]))
    q.put((rank, (ce_err, g_err, y_err, partial, moe_err)))
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


def test_token_ce_and_proj_out_equal_the_unsharded_values(runs):
    for ce_err, g_err, y_err, partial, _moe in runs["gloo"]:
        assert ce_err <= 1e-6 and g_err <= 1e-6, (ce_err, g_err)
        assert y_err <= 1e-5 and not partial, (y_err, partial)


def test_moe_slots_equal_the_unsharded_layer_both_ways(runs):
    # f32: the same sums in another order (the expert shards' outputs
    # added by the reduction, each rank's rows by its own index_add)
    for moe_err in (r[4] for r in runs["gloo"]):
        assert all(e <= 1e-5 for e in moe_err), moe_err


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
    """The three runs side by side: the mixtral comparison (two
    subprocesses), the fake mesh's script and the gloo spawn."""
    tmp = tmp_path_factory.mktemp("collectives")
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        jobs = {
            "mixtral": pool.submit(compare, ["mixtral-8x22b"], CELLS,
                                   workdir=str(tmp)),
            "fake": pool.submit(_script, tmp, "fake", FAKE_RUN, "FAKE"),
            "gloo": pool.submit(_script, tmp, "gloo", GLOO_CE, "GLOO",
                                str(tmp / "store"))}
        return {k: f.result() for k, f in jobs.items()}
