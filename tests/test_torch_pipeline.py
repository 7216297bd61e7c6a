"""GPipe (``repro_torch.runtime.pipeline``) against the JAX package's
``pipeline_forward`` and ``jax.grad`` of its ``pipeline_loss_fn``.

The reference's cell (``tests/test_sharding.py``'s pipeline test): S = 4
stages of ``tanh(h @ w + b)``, M = 6 microbatches of 2 rows, D = 16,
float32, inputs drawn from a numpy seed. Both forms, the one-device form
and the process form on 4 spawned gloo ranks (one stage each), give the
outputs and the gradients of the mean squared error within 1e-5 of JAX's
on 4 host devices (one subprocess) and of autograd through the
sequential model. A gemma3-1b SMOKE pipeline (S = 2 stages of one
[sliding-window, global] pattern each, M = 3 microbatches) in the
one-device form is bit-equal to its layers run one microbatch at a time
in sequence, its gradients within 1e-5 of theirs.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import one_device_mesh  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.runtime.pipeline import (  # noqa: E402
    pipeline_forward,
    pipeline_loss_fn,
)
from torch.utils import _pytree as pytree  # noqa: E402

S, M, MB, D = 4, 6, 2, 16
TOL = 1e-5
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _cell():
    rng = np.random.default_rng(0)
    f = np.float32
    return ({"w": (rng.standard_normal((S, D, D)) * 0.3).astype(f),
             "b": (rng.standard_normal((S, D)) * 0.1).astype(f)},
            rng.standard_normal((M, MB, D)).astype(f),
            rng.standard_normal((M, MB, D)).astype(f))


def stage_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def mse(h, t):
    return torch.mean((h - t) ** 2)


def _sequential(params, x):
    h = x
    for s in range(S):
        h = torch.tanh(h @ params["w"][s] + params["b"][s])
    return h


def _torch(params):
    return {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in params.items()}


JAX_REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {src!r})
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.runtime.pipeline import pipeline_forward, pipeline_loss_fn

z = np.load(sys.argv[1])
params = {{"w": jnp.asarray(z["w"]), "b": jnp.asarray(z["b"])}}
x, t = jnp.asarray(z["x"]), jnp.asarray(z["t"])
mesh = Mesh(np.array(jax.devices()[:{S}]).reshape({S}), ("stage",))

def stage_fn(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])

outs = pipeline_forward(stage_fn, params, x, mesh=mesh)
loss = pipeline_loss_fn(stage_fn, lambda h, t_: jnp.mean((h - t_) ** 2),
                        mesh=mesh)
g = jax.grad(loss)(params, x, t)
np.savez(sys.argv[2], outs=np.asarray(outs), gw=np.asarray(g["w"]),
         gb=np.asarray(g["b"]))
print("JAX OK")
"""

PROCESS = """
import sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, {src!r})

def work(rank, store, data, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size={S})
    from repro_torch.launch.mesh import process_mesh
    from repro_torch.runtime.pipeline import pipeline_forward, pipeline_loss_fn
    z = np.load(data)
    mesh = process_mesh(({S},), ("stage",))
    stage_fn = lambda p, h: torch.tanh(h @ p["w"] + p["b"])
    params = {{k: torch.from_numpy(z[k]).requires_grad_(True)
              for k in ("w", "b")}}
    x, t = torch.from_numpy(z["x"]), torch.from_numpy(z["t"])
    with torch.no_grad():
        outs = pipeline_forward(stage_fn, params, x, mesh=mesh)
    loss = pipeline_loss_fn(stage_fn, lambda h, t_: torch.mean((h - t_) ** 2),
                            mesh=mesh)(params, x, t)
    loss.backward()
    np.savez(out + "_%d.npz" % rank, outs=outs.numpy(),
             loss=loss.detach().numpy(), gw=params["w"].grad[rank].numpy(),
             gb=params["b"].grad[rank].numpy())
    dist.destroy_process_group()

if __name__ == "__main__":
    mp.spawn(work, args=tuple(sys.argv[1:4]), nprocs={S})
    print("PROC OK")
"""


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """JAX's outputs and grads, and the process form's, side by side."""
    tmp = tmp_path_factory.mktemp("pp")
    params, x, t = _cell()
    np.savez(tmp / "cell.npz", x=x, t=t, **params)
    ref = tmp / "ref.py"
    ref.write_text(textwrap.dedent(JAX_REF.format(src=SRC, S=S)))
    proc = tmp / "proc.py"
    proc.write_text(textwrap.dedent(PROCESS.format(src=SRC, S=S)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    spawn = subprocess.Popen(
        [sys.executable, str(proc), str(tmp / "store"), str(tmp / "cell.npz"),
         str(tmp / "rank")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    jref = subprocess.run([sys.executable, str(ref), str(tmp / "cell.npz"),
                           str(tmp / "jax.npz")], capture_output=True,
                          text=True, timeout=180, env=env)
    out, err = spawn.communicate(timeout=180)
    assert jref.returncode == 0 and "JAX OK" in jref.stdout, jref.stderr
    assert spawn.returncode == 0 and "PROC OK" in out, out + err[-3000:]
    ranks = [np.load(tmp / f"rank_{r}.npz") for r in range(S)]
    return np.load(tmp / "jax.npz"), ranks


def _sequential_grads(params, x, t):
    p = _torch(params)
    losses = [mse(h, tt) for h, tt in zip(_sequential(p, torch.from_numpy(x)),
                                          torch.from_numpy(t))]
    torch.stack(losses).mean().backward()
    return p["w"].grad.numpy(), p["b"].grad.numpy()


def test_one_device_form_matches_jax_and_the_sequential_model(refs):
    jax_ref, _ranks = refs
    params, x, t = _cell()
    mesh = one_device_mesh((S,), ("stage",), "cpu")
    with torch.no_grad():
        outs = pipeline_forward(stage_fn, _torch(params), torch.from_numpy(x),
                                mesh=mesh)
    np.testing.assert_allclose(outs.numpy(), jax_ref["outs"], atol=TOL)
    seq = _sequential(_torch(params), torch.from_numpy(x)).detach()
    np.testing.assert_allclose(outs.numpy(), seq.numpy(), atol=TOL)
    p = _torch(params)
    pipeline_loss_fn(stage_fn, mse, mesh=mesh)(
        p, torch.from_numpy(x), torch.from_numpy(t)).backward()
    gw, gb = _sequential_grads(params, x, t)
    for got, want, seq_g in ((p["w"].grad, jax_ref["gw"], gw),
                             (p["b"].grad, jax_ref["gb"], gb)):
        np.testing.assert_allclose(got.numpy(), want, atol=TOL)
        np.testing.assert_allclose(got.numpy(), seq_g, atol=TOL)


def test_process_form_matches_jax_and_the_sequential_model(refs):
    jax_ref, ranks = refs
    params, x, t = _cell()
    gw, gb = _sequential_grads(params, x, t)
    for r, got in enumerate(ranks):  # every rank has the outputs
        np.testing.assert_allclose(got["outs"], jax_ref["outs"], atol=TOL)
        # rank r holds stage r's gradient
        np.testing.assert_allclose(got["gw"], jax_ref["gw"][r], atol=TOL)
        np.testing.assert_allclose(got["gb"], jax_ref["gb"][r], atol=TOL)
        np.testing.assert_allclose(got["gw"], gw[r], atol=TOL)
        np.testing.assert_allclose(got["gb"], gb[r], atol=TOL)
    assert len({float(g["loss"]) for g in ranks}) == 1


def test_gemma_stages_equal_their_layers_in_sequence():
    cfg = dataclasses.replace(get_smoke_config("gemma3-1b"), dtype="float32")
    params = TF.init_params(cfg, 0, "cpu")
    specs = TF.layer_specs(cfg)
    P = len(cfg.pattern)
    n_stages, n_micro = cfg.pattern_repeats, 3
    layers = params["layers"][:P * n_stages]
    # stage s: pattern repeat s's layers, stacked over the stages
    stacked = [pytree.tree_map(lambda *ts: torch.stack(ts),
                               *[layers[s * P + i] for s in range(n_stages)])
               for i in range(P)]

    def stage(p, h):
        for i in range(P):
            h, _a, _c = TF.apply_layer(h, p[i], cfg, specs[i],
                                       kernel_impl="pallas")
        return h

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((n_micro, 1, 24, cfg.d_model), generator=gen)
    mesh = one_device_mesh((n_stages,), ("stage",), "cpu")
    leaves = pytree.tree_leaves(stacked)
    for v in leaves:
        v.requires_grad_(True)
    outs = pipeline_forward(stage, stacked, x, mesh=mesh)
    want = []
    ref_layers = [pytree.tree_map(lambda v: v.detach().clone()
                                  .requires_grad_(True), lp)
                  for lp in layers]
    for m in range(n_micro):
        h = x[m]
        for j, lp in enumerate(ref_layers):
            h, _a, _c = TF.apply_layer(h, lp, cfg, specs[j % P],
                                       kernel_impl="pallas")
        want.append(h)
    want = torch.stack(want)
    assert torch.equal(outs, want)
    outs.square().mean().backward()
    want.square().mean().backward()
    for i in range(P):
        for s in range(n_stages):
            for g, r in zip(pytree.tree_leaves(stacked[i]),
                            pytree.tree_leaves(ref_layers[s * P + i])):
                np.testing.assert_allclose(g.grad[s].numpy(),
                                           r.grad.numpy(), atol=TOL)
