"""The port's train step against ``repro.train.make_train_step`` on
gemma3-1b's SMOKE config cut to one pattern repeat, in float32: one step
at 1 and 2 microbatches from the same weights, and a JAX run carried
across (2 JAX steps, then ``params_from_numpy`` and
``opt_state_from_numpy``) whose third step matches. Data parallelism
under 2 spawned gloo ranks (``launch.train`` on a ``data`` axis of 2,
its params DTensors) equals the one-process full-batch step, and ``compressed_psum_pod``
over a 2-rank ``pod`` group averages as the reference's test
(``tests/test_sharding.py``'s ``test_compressed_pod_psum_8dev``) holds
it.

Tolerances (float32): the loss and the grad norm within 1e-5 relative;
the optimizer state (m and v, linear and quadratic in the gradient)
within 1e-5 of each leaf's largest |value|; each param leaf's update
within 1e-3 of the reference's in L2 norm. The update is compared by
leaf, not by element: AdamW's lr x m/(sqrt(v) + eps) divides by |g| +
eps, so where |g| is near eps (1e-8) f32 rounding of g moves an element
by a sizeable part of lr, while a wrong or missing gradient moves a
leaf's update by its whole norm. The data-parallel step within 1e-5
absolute of the full-batch step.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.optim import OptConfig as JaxOptConfig  # noqa: E402
from repro.optim import init_opt_state as jax_init_opt  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import host_mesh  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    opt_state_from_numpy,
    params_from_numpy,
)
from repro_torch.optim import OptConfig, init_opt_state  # noqa: E402
from repro_torch.train import TrainConfig, make_train_step  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

ARCH = "gemma3-1b"
B, S = 4, 32
KW = dict(lr=1e-3)
RTOL = 1e-5
STATE_TOL = 1e-5  # of the leaf's largest |value|
UPDATE_RTOL = 1e-3  # of the update's L2 norm, by leaf
DP_ATOL = 1e-5


def _cfgs():
    kw = dict(dtype="float32", pattern_repeats=1)
    return (dataclasses.replace(jax_smoke(ARCH), **kw),
            dataclasses.replace(get_smoke_config(ARCH), **kw))


def _jax_tree(cfg, params):
    """The port's params (one pattern repeat) in the JAX layout."""
    def np_(t, lead=False):
        a = t.detach().numpy()
        return a[None] if lead else a

    P = len(cfg.pattern)
    tree = {k: pytree.tree_map(np_, v) for k, v in params.items()
            if k != "layers"}
    tree["groups"] = {f"l{i}": pytree.tree_map(lambda t: np_(t, True), layer)
                      for i, layer in enumerate(params["layers"][:P])}
    tree["tail"] = {f"l{i}": pytree.tree_map(np_, layer)
                    for i, layer in enumerate(params["layers"][P:])}
    return tree


def _batch(cfg, step):
    return TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    global_batch=B, seq_len=S,
                                    seed=7)).batch(step)


def _close_state(got, want):
    def close(g, w):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=STATE_TOL * np.abs(w).max())

    pytree.tree_map(close, got, want)


def _close_updates(new, want, old):
    """Each leaf's update new - old within UPDATE_RTOL of want - old."""
    def close(n, w, o):
        d_got = n.double() - o.double()
        d_want = torch.from_numpy(np.asarray(w, np.float64)) - o.double()
        assert float(torch.linalg.norm(d_got - d_want)) <= UPDATE_RTOL * max(
            float(torch.linalg.norm(d_want)), 1e-30)

    pytree.tree_map(close, new, want, old)


def _jax_step(jcfg, micro, chunk=0):
    tcfg = JaxTrainConfig(microbatches=micro, loss_chunk=chunk,
                          opt=JaxOptConfig(**KW))
    return jax.jit(jax_make_train_step(jcfg, tcfg)), tcfg


@pytest.mark.parametrize("micro", [1, 2])
def test_one_step_matches_jax(micro):
    jcfg, tcfg = _cfgs()
    params = TF.init_params(tcfg, 2, "cpu")
    jp = jax.tree.map(jnp.asarray, _jax_tree(tcfg, params))
    step, jtc = _jax_step(jcfg, micro)
    batch = _batch(tcfg, 0)
    jp2, js2, jm = step(jp, jax_init_opt(jtc.opt, jp),
                         jax.tree.map(jnp.asarray, batch))
    ocfg = OptConfig(**KW)
    port = make_train_step(tcfg, TrainConfig(microbatches=micro,
                                             loss_chunk=0, opt=ocfg),
                           kernel_impl="pallas")
    tp2, ts2, tm = port(params, init_opt_state(ocfg, params),
                        pytree.tree_map(torch.from_numpy, batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=RTOL)
    assert int(ts2["step"]) == 1
    _close_state(ts2["mu"], params_from_numpy(
        tcfg, jax.tree.map(np.asarray, js2["mu"]), "cpu"))
    _close_updates(tp2, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jp2), "cpu"), params)


def test_a_jax_run_resumes_in_the_port():
    """2 JAX steps (chunked loss, as the reference's default), carried
    across; the third step of both matches."""
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(jnp.asarray, _jax_tree(tcfg, TF.init_params(tcfg, 5,
                                                                   "cpu")))
    step, jtc = _jax_step(jcfg, 1, chunk=8)
    js = jax_init_opt(jtc.opt, jp)
    for s in range(2):
        jp, js, _ = step(jp, js, jax.tree.map(jnp.asarray, _batch(tcfg, s)))
    ocfg = OptConfig(**KW)
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    ts = opt_state_from_numpy(tcfg, ocfg, jax.tree.map(np.asarray, js), "cpu")
    assert int(ts["step"]) == 2 and ts["step"].dtype == torch.int32
    jp3, js3, jm = step(jp, js, jax.tree.map(jnp.asarray, _batch(tcfg, 2)))
    port = make_train_step(tcfg, TrainConfig(loss_chunk=8, opt=ocfg),
                           kernel_impl="jnp")
    tp3, ts3, tm = port(tp, ts, pytree.tree_map(torch.from_numpy,
                                                _batch(tcfg, 2)))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=RTOL)
    _close_state(ts3["mu"], params_from_numpy(
        tcfg, jax.tree.map(np.asarray, js3["mu"]), "cpu"))
    _close_updates(tp3, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jp3), "cpu"), tp)


def test_opt_state_from_numpy_refuses_another_optimizers_state():
    jcfg, tcfg = _cfgs()
    jp = _jax_tree(tcfg, TF.init_params(tcfg, 0, "cpu"))
    js = jax.tree.map(np.asarray, jax_init_opt(JaxOptConfig(), jp))
    with pytest.raises(ValueError, match="moment"):
        opt_state_from_numpy(tcfg, OptConfig(name="adafactor",
                                             min_dim_size_to_factor=16), js,
                             "cpu")


PROCESS = """
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, {src!r})

def work(rank, world, store, out, q):
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh_for, process_mesh
    from repro_torch.train.grad_compress import (compressed_psum_pod,
                                                 init_error_state)
    cfg = dataclasses.replace(get_smoke_config({arch!r}), dtype="float32",
                              pattern_repeats=1)
    mesh = make_mesh_for(None, data=world, model=1)
    _cfg, init, run_step, _dev = T.build_trainer(
        None, mesh, batch={batch}, seq={seq}, mcfg=cfg, kernel_impl="pallas")
    pipe = T.token_pipeline(cfg, mesh, {batch}, {seq}, seed=7)
    state, m = run_step(init(), pipe.batch(0))
    res = {{"loss": float(m["loss"]), "gnorm": float(m["grad_norm"]),
           "rows": pipe.local_batch}}
    # the params are DTensors: every rank joins each one's gather
    flat = [t.full_tensor()
            for t in torch.utils._pytree.tree_leaves(state["params"])]
    if rank == 0:
        np.savez(out, *[t.numpy() for t in flat])
    pod = process_mesh((world,), ("pod",))
    g = {{"w": torch.ones((16, 8)) * 0.5, "v": torch.full((5,), 1.0 + rank)}}
    red, err = compressed_psum_pod(g, init_error_state(g), pod)
    res["psum_w"] = red["w"].tolist()
    res["psum_v"] = red["v"].tolist()
    res["err_v"] = err["v"].tolist()
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
    res = dict(q.get(timeout=120) for _ in ps)
    for p in ps:
        p.join(30)
    print("PROC " + json.dumps(res))
"""


def test_data_parallel_step_and_pod_psum_under_gloo(tmp_path):
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    script = tmp_path / "proc.py"
    script.write_text(textwrap.dedent(PROCESS.format(src=src, arch=ARCH,
                                                     batch=B, seq=S)))
    out = tmp_path / "params.npz"
    r = subprocess.run([sys.executable, str(script), "2",
                        str(tmp_path / "store"), str(out)],
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("PROC ")][-1]
    res = json.loads(line[5:])
    _jcfg, tcfg = _cfgs()
    _cfg, init, run_step, _dev = launch_train.build_trainer(
        None, host_mesh(), batch=B, seq=S, mcfg=tcfg, device="cpu",
        kernel_impl="pallas")
    pipe = launch_train.token_pipeline(tcfg, host_mesh(), B, S, seed=7)
    state, m = run_step(init(), pipe.batch(0))
    for rank in ("0", "1"):
        assert res[rank]["rows"] == B // 2
        np.testing.assert_allclose(res[rank]["loss"], float(m["loss"]),
                                   rtol=0, atol=DP_ATOL)
        np.testing.assert_allclose(res[rank]["gnorm"],
                                   float(m["grad_norm"]), rtol=RTOL)
        # the reference's check: 0.5 on both ranks comes back as 0.5
        np.testing.assert_allclose(res[rank]["psum_w"], 0.5, atol=0.02)
        # 1 and 2 average to 1.5 within a quantization step of each
        np.testing.assert_allclose(res[rank]["psum_v"], 1.5, atol=2 / 127)
    got = np.load(out)
    want = pytree.tree_leaves(state["params"])
    assert len(got.files) == len(want)
    for i, w in enumerate(want):
        np.testing.assert_allclose(got[f"arr_{i}"], w.numpy(), rtol=0,
                                   atol=DP_ATOL)
