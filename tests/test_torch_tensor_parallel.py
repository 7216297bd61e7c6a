"""Training under a ``model`` axis (tensor parallelism) in DTensor form,
on 4 gloo ranks spawned once, which host a (``data`` 2, ``model`` 2) and
a (``model`` 4) mesh.

* gemma3-1b SMOKE at (2, 2), 2 steps in float32 from the same weights,
  against the JAX package's ``build_trainer`` on a (2, 2) mesh of 4 host
  devices (one subprocess, run beside the spawn): both steps' losses and
  grad norms within 1e-5 relative, the optimizer state within 5e-5 of
  each leaf's largest |value|, each param leaf's update within 1e-3 of
  the reference's in L2 norm (``tests/test_torch_train_step.py``'s
  tolerances and the reasons given there; its 1e-5 on the state is 5e-5
  here: each rank's gradient is a partial sum over its rows and heads,
  reduced over the mesh in another order than one device sums them, and
  v is quadratic in the gradient; measured 1.6e-5 of the largest |v|).
* mixtral-8x22b and rwkv6-1.6b SMOKE at (2, 2), mixtral also with 2
  microbatches (each the global rows i B/2 .. (i + 1) B/2 - 1, as one
  device splits them: the MoE plans its capacity and its aux loss per
  microbatch, so another grouping of rows gives another loss), and
  qwen3-32b SMOKE at ``model`` 4 (4 query heads over 2 KV heads: each
  rank holds one query head and reads its own KV head), one step
  against the port's one-device step: the loss and grad norm within
  1e-5 relative, each param leaf's update within 1e-3 of the one-device
  update in L2 norm (the same sums in another order: shards reduced
  over ranks; AdamW divides by |g| + eps, so an element whose |g| is
  near eps moves by a sizeable part of lr under such rounding).
* The sharded state saved by rank 0 and restored into DTensors equals
  the saved state bit for bit.
* Each model's forward with a context on a mesh without a
  ``DeviceMesh`` (the constraints inactive) is bit-equal to it without.
* B3's, B4's and B5's wrappers refuse a DTensor.

The kernels' wrappers run their plain versions on the CPU, on each
rank's local shards (``sharding.ctx.local_call``), as the card's kernels
would.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import host_mesh  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    opt_state_from_numpy,
    params_from_numpy,
)
from repro_torch.optim.optimizers import _like  # noqa: E402
from repro_torch.sharding import ctx  # noqa: E402
from repro_torch.sharding import policies as SH  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

B, S = 4, 32
RTOL = 1e-5
STATE_TOL = 5e-5  # of the leaf's largest |value|
UPDATE_RTOL = 1e-3  # of the update's L2 norm, by leaf
# (name, arch, data, model, steps, microbatches); gemma's run is also
# held to JAX's
CASES = (("gemma3-1b", "gemma3-1b", 2, 2, 2, 1),
         ("mixtral-8x22b", "mixtral-8x22b", 2, 2, 1, 1),
         ("mixtral-8x22b-mb2", "mixtral-8x22b", 2, 2, 1, 2),
         ("rwkv6-1.6b", "rwkv6-1.6b", 2, 2, 1, 1),
         ("qwen3-32b", "qwen3-32b", 1, 4, 1, 1))
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


PROCESS = """
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, {src!r})
CASES = {cases!r}

def work(rank, world, store, out, q):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    from torch.utils import _pytree as pytree
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh_for
    res = {{}}
    for name, arch, data, model, steps, micro in CASES:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        mesh = make_mesh_for(None, data=data, model=model)
        _c, init, run_step, _d = T.build_trainer(
            None, mesh, batch={batch}, seq={seq}, microbatches=micro,
            mcfg=cfg, kernel_impl="pallas")
        pipe = T.token_pipeline(cfg, mesh, {batch}, {seq}, seed=7)
        state = init()
        losses, gnorms = [], []
        for step in range(steps):
            state, m = run_step(state, pipe.batch(step))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        full = [t.full_tensor().numpy()
                for t in pytree.tree_leaves(state)]
        if rank == 0:
            np.savez(out + "_" + name + ".npz", *full)
        res[name] = {{"loss": losses, "gnorm": gnorms}}
        if name == CASES[0][0]:
            ck = Checkpointer(out + "_ckpt", interval=1)
            ck.maybe_save(steps, state)
            ck.wait()
            dist.barrier()
            _s, back = ck.restore_latest(init())
            res["restored"] = all(
                torch.equal(a.full_tensor(), b.full_tensor())
                and tuple(a.placements) == tuple(b.placements)
                for a, b in zip(pytree.tree_leaves(state),
                                pytree.tree_leaves(back)))
    q.put((rank, res))
    dist.destroy_process_group()

if __name__ == "__main__":
    world, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    ps = [ctx.Process(target=work, args=(r, world, store, out, q))
          for r in range(world)]
    for p in ps:
        p.start()
    res = dict(q.get(timeout=300) for _ in ps)
    for p in ps:
        p.join(30)
    print("PROC " + json.dumps(res))
"""

JAX_REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {src!r})
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.data import DataConfig, TokenPipeline
from repro.launch.mesh import host_mesh
from repro.launch.train import build_trainer
from repro.optim import OptConfig, init_opt_state

assert len(jax.devices()) == 4
cfg = dataclasses.replace(get_smoke_config({arch!r}), dtype="float32")
mesh = host_mesh(data=2, model=2)
_c, _init, run_step, shardings, _r = build_trainer(
    None, mesh, batch={batch}, seq={seq}, mcfg=cfg)
z = np.load(sys.argv[1])
flat = [z["arr_%d" % i] for i in range(len(z.files))]
tree = jax.tree.unflatten(jax.tree.structure(_init()["params"]), flat)
params = jax.tree.map(jax.device_put, tree, shardings["params"])
opt = jax.tree.map(jax.device_put, init_opt_state(OptConfig(lr=1e-3), params),
                   shardings["opt"])
state = {{"params": params, "opt": opt}}
pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                global_batch={batch}, seq_len={seq}, seed=7))
losses, gnorms = [], []
for step in range({steps}):
    state, m = run_step(state, pipe.batch(step))
    losses.append(float(m["loss"]))
    gnorms.append(float(m["grad_norm"]))
leaves = {{"p%d" % i: np.asarray(a)
          for i, a in enumerate(jax.tree.leaves(state["params"]))}}
leaves.update({{"m%d" % i: np.asarray(a)
               for i, a in enumerate(jax.tree.leaves(state["opt"]["mu"]))}})
np.savez(sys.argv[2], **leaves)
print("JAX", losses, gnorms)
"""


def _jax_layout(cfg, params):
    """The port's params as numpy in the JAX layout: each pattern
    position's layers stacked over the repeats, then the tail."""
    P, R = len(cfg.pattern), cfg.pattern_repeats
    layers = params["layers"]
    tree = {k: pytree.tree_map(lambda t: t.numpy(), v)
            for k, v in params.items() if k != "layers"}
    tree["groups"] = {
        f"l{i}": pytree.tree_map(lambda *ts: np.stack([t.numpy()
                                                      for t in ts]),
                                 *[layers[r * P + i] for r in range(R)])
        for i in range(P)}
    tree["tail"] = {f"l{i}": pytree.tree_map(lambda t: t.numpy(), layer)
                    for i, layer in enumerate(layers[P * R:])}
    return tree


def _one_device(arch, steps, microbatches):
    cfg = _cfg(arch)
    _c, init, run_step, _d = launch_train.build_trainer(
        None, host_mesh(), batch=B, seq=S, microbatches=microbatches,
        mcfg=cfg, device="cpu", kernel_impl="pallas")
    pipe = launch_train.token_pipeline(cfg, host_mesh(), B, S, seed=7)
    state = init()
    out = []
    for step in range(steps):
        state, m = run_step(state, pipe.batch(step))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return init(), state, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank spawn and the JAX reference, run side by side."""
    tmp = tmp_path_factory.mktemp("tp")
    _n, arch, _d, _m, steps, _mb = CASES[0]
    cfg = _cfg(arch)
    p0 = TF.init_params(cfg, 0, "cpu")
    jtree = _jax_layout(cfg, p0)
    import jax

    flat = jax.tree.leaves(jtree)
    np.savez(tmp / "p0.npz", *flat)
    proc = tmp / "proc.py"
    proc.write_text(textwrap.dedent(PROCESS.format(src=SRC, cases=CASES,
                                                   batch=B, seq=S)))
    ref = tmp / "ref.py"
    ref.write_text(textwrap.dedent(JAX_REF.format(src=SRC, arch=arch,
                                                  batch=B, seq=S,
                                                  steps=steps)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    spawn = subprocess.Popen(
        [sys.executable, str(proc), "4", str(tmp / "store"), str(tmp / "tp")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    jref = subprocess.run([sys.executable, str(ref), str(tmp / "p0.npz"),
                           str(tmp / "jax.npz")], capture_output=True,
                          text=True, timeout=240, env=env)
    out, err = spawn.communicate(timeout=300)
    assert spawn.returncode == 0, out + "\n" + err[-4000:]
    assert jref.returncode == 0, jref.stdout + "\n" + jref.stderr[-4000:]
    line = [ln for ln in out.splitlines() if ln.startswith("PROC ")][-1]
    res = json.loads(line[5:])
    jline = [ln for ln in jref.stdout.splitlines() if ln.startswith("JAX")]
    jl, jg = json.loads("[" + jline[-1][4:].replace("] [", "], [") + "]")
    return {"tmp": tmp, "ranks": res, "jax_loss": jl, "jax_gnorm": jg}


def _close_updates(new, want, old):
    """Each leaf's update new - old within UPDATE_RTOL of want - old."""
    for n, w, o in zip(pytree.tree_leaves(new), pytree.tree_leaves(want),
                       pytree.tree_leaves(old), strict=True):
        d_got, d_want = n.double() - o.double(), w.double() - o.double()
        assert float(torch.linalg.norm(d_got - d_want)) <= UPDATE_RTOL * max(
            float(torch.linalg.norm(d_want)), 1e-30)


def _port_state(tmp, name, template):
    z = np.load(tmp / f"tp_{name}.npz")
    flat = [torch.from_numpy(z[f"arr_{i}"]) for i in range(len(z.files))]
    return pytree.tree_unflatten(flat, pytree.tree_structure(template))


def test_gemma_data_and_model_axes_match_jax_sharded_trainer(runs):
    arch = CASES[0][0]
    cfg = _cfg(arch)
    for rank in ("0", "1", "2", "3"):
        r = runs["ranks"][rank][arch]
        np.testing.assert_allclose(r["loss"], runs["jax_loss"], rtol=RTOL)
        np.testing.assert_allclose(r["gnorm"], runs["jax_gnorm"], rtol=RTOL)
    z = np.load(runs["tmp"] / "jax.npz")
    p0 = TF.init_params(cfg, 0, "cpu")
    jtree = _jax_layout(cfg, p0)
    import jax

    spec = jax.tree.structure(jtree)
    n = spec.num_leaves
    jp = params_from_numpy(cfg, jax.tree.unflatten(
        spec, [z[f"p{i}"] for i in range(n)]), "cpu")
    template = {"params": p0, "opt": launch_train.init_opt_state(
        launch_train.OptConfig(lr=1e-3), p0)}
    got = _port_state(runs["tmp"], arch, template)
    _close_updates(got["params"], _like(jp, p0), p0)
    mu_spec = jax.tree.structure(
        {"mu": jax.tree.map(lambda a: {"m": a, "v": a}, jtree)})
    nm = mu_spec.num_leaves
    jo = opt_state_from_numpy(
        cfg, launch_train.OptConfig(lr=1e-3),
        {"step": np.int32(2), "mu": jax.tree.unflatten(
            mu_spec, [z[f"m{i}"] for i in range(nm)])["mu"]}, "cpu")
    for g, w in zip(pytree.tree_leaves(got["opt"]["mu"]),
                    pytree.tree_leaves(_like(jo["mu"], got["opt"]["mu"]))):
        w = w.float().numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=STATE_TOL * np.abs(w).max())
    assert int(got["opt"]["step"]) == 2


@pytest.mark.parametrize("name", [c[0] for c in CASES[1:]])
def test_sharded_step_matches_one_device_step(runs, name):
    _n, arch, _d, _m, steps, micro = {c[0]: c for c in CASES}[name]
    init, state, want = _one_device(arch, steps, micro)
    for rank in ("0", "1", "2", "3"):
        r = runs["ranks"][rank][name]
        np.testing.assert_allclose(r["loss"], [w[0] for w in want],
                                   rtol=RTOL)
        np.testing.assert_allclose(r["gnorm"], [w[1] for w in want],
                                   rtol=RTOL)
    got = _port_state(runs["tmp"], name, state)
    _close_updates(got["params"], state["params"], init["params"])


def test_sharded_state_restores_bit_equal(runs):
    assert all(runs["ranks"][r]["restored"] for r in ("0", "1", "2", "3"))


@pytest.mark.parametrize("arch", sorted({c[1] for c in CASES}))
def test_forward_is_bit_equal_under_an_inactive_context(arch):
    cfg = _cfg(arch)
    params = TF.init_params(cfg, 1, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(3))
    want, aux = TF.forward(params, cfg, tokens, kernel_impl="pallas")
    mesh = host_mesh(data=2, model=2)
    with ctx.use(mesh, SH.rules_for(cfg, "train", 2, mesh)):
        got, aux2 = TF.forward(params, cfg, tokens, kernel_impl="pallas")
    assert torch.equal(got, want) and float(aux2) == float(aux)


def test_kernel_wrappers_reject_a_dtensor(tmp_path):
    """B3's, B4's and B5's wrappers raise a TypeError that names
    ``local_call`` for a DTensor (its ``data_ptr`` is its local shard's),
    on the CPU as a CUDA launch would, instead of computing on it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.moe_dispatch.ops import moe_dispatch_plan
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        dm = init_device_mesh("cpu", (1,))

        def dt(*shape):
            return DTensor.from_local(torch.ones(shape), dm, [Replicate()])

        q = dt(1, 8, 2, 64)
        r = dt(1, 2, 8, 64)
        calls = (
            lambda: flash_attention(q, q, q),
            lambda: rwkv6_scan(r, r, r, r, dt(2, 64), dt(1, 2, 64, 64)),
            lambda: moe_dispatch_plan(dt(8, 4), top_k=2, capacity=4),
        )
        for call in calls:
            with pytest.raises(TypeError, match="local_call"):
                call()
    finally:
        dist.destroy_process_group()
