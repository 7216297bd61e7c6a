"""The port's training substrate: the token pipeline against
``repro.data`` (equal batches), and the reference's checkpoint, data,
supervisor, straggler, watchdog and error-feedback tests
(``tests/test_substrate.py``) mirrored on trees of tensors; a bf16 round
trip, checkpoints written by either package restored by the other, and
``launch.train`` resumed from its own checkpoint to the same state, bit
for bit, as a run that was never interrupted.
"""

import os
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import TokenPipeline as JaxTokenPipeline  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    Checkpointer,
    committed_steps,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import host_mesh  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    DeadlineExceeded,
    FailureInjector,
    StragglerMonitor,
    TrainSupervisor,
    Watchdog,
)
from repro_torch.train.grad_compress import (  # noqa: E402
    _dequantize,
    compress_leaf,
)
from torch.utils import _pytree as pytree  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are small (and the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("hosts", [1, 2])
def test_batches_equal_the_reference(hosts):
    for host in range(hosts):
        kw = dict(vocab_size=1000, global_batch=4, seq_len=32, seed=9,
                  num_hosts=hosts, host_index=host)
        ours, ref = TokenPipeline(DataConfig(**kw)), JaxTokenPipeline(
            JaxDataConfig(**kw))
        for step in (0, 1, 17, 2**20 + 3):
            a, b = ours.batch(step), ref.batch(step)
            for k in ("tokens", "targets"):
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])
        assert ours.state(5) == ref.state(5)


def test_data_deterministic_and_resumable():
    cfg = DataConfig(vocab_size=1000, global_batch=4, seq_len=32, seed=9)
    p1, p2 = TokenPipeline(cfg), TokenPipeline(cfg)
    b1, b2 = p1.batch(17), p2.batch(17)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(p1.batch(18)["tokens"], b1["tokens"])
    assert (b1["tokens"] >= 0).all() and (b1["tokens"] < 1000).all()
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["targets"][:, :-1])


def test_data_host_sharding_disjoint():
    full = TokenPipeline(DataConfig(vocab_size=50, global_batch=8,
                                    seq_len=16)).batch(3)
    parts = [TokenPipeline(DataConfig(vocab_size=50, global_batch=8,
                                      seq_len=16, num_hosts=2,
                                      host_index=i)).batch(3)
             for i in range(2)]
    np.testing.assert_array_equal(
        np.concatenate([p["tokens"] for p in parts]), full["tokens"])


# ---------------------------------------------------------------- checkpoint
def _tree():
    """Keys in sorted order, as JAX flattens them."""
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": {"c": torch.tensor([1.0, -2.5, 3.140625, 1e-3, 7e4],
                                dtype=torch.bfloat16)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _equal(got, want):
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want),
                    strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_checkpoint_roundtrip_bf16_included(tmp_path):
    d = str(tmp_path)
    t = _tree()
    save_checkpoint(d, 3, t)
    assert latest_step(d) == 3
    _equal(restore_checkpoint(d, 3, t), t)


def test_checkpoint_corruption_detected(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree())
    victim = os.path.join(d, "step_1", "arr_0.npy")
    raw = bytearray(open(victim, "rb").read())
    raw[-1] ^= 0xFF
    open(victim, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="corruption"):
        restore_checkpoint(d, 1, _tree())


def test_checkpoint_retention_and_async(tmp_path):
    d = str(tmp_path)
    ck = Checkpointer(d, keep=2, interval=1)
    for s in range(5):
        ck.maybe_save(s, _tree())
    ck.wait()
    assert committed_steps(d) == [3, 4]


def test_checkpoint_restore_onto_a_device(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 0, _tree())
    r = restore_checkpoint(d, 0, _tree(), device="meta")
    assert all(t.device.type == "meta" for t in pytree.tree_leaves(r))
    step, r = Checkpointer(d).restore_latest(_tree(), device="cpu")
    assert step == 0
    _equal(r, _tree())


def _jax_tree():
    return {"a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
            "b": {"c": jnp.asarray([1.0, -2.5, 3.140625, 1e-3, 7e4],
                                   jnp.bfloat16)},
            "step": jnp.asarray(7, jnp.int32)}


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    d = str(tmp_path)
    jax_save(d, 4, _jax_tree())
    _equal(restore_checkpoint(d, 4, _tree()), _tree())


def test_port_checkpoint_restores_in_jax(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 2, _tree())
    got = jax_restore(d, 2, _jax_tree())
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(_jax_tree())):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


# ---------------------------------------------------------------- runtime
def test_supervisor_recovers_from_injected_failures(tmp_path):
    mesh = host_mesh()

    def build(mesh_):
        def step_fn(state, batch):
            return {"x": state["x"] + batch}, {}

        return step_fn, {"x": torch.zeros(())}

    sup = TrainSupervisor(
        build=build,
        reshard=lambda s, m: s,
        meshes=[mesh],
        ckpt=Checkpointer(str(tmp_path), interval=2),
        injector=FailureInjector(fail_steps=(5, 9)),
        max_restarts=5,
    )
    state = sup.run(12, batch_fn=lambda step: torch.tensor(1.0))
    assert sup.restarts == 2
    # exactly-once: every step 0..11 contributed exactly once
    assert float(state["x"]) == 12.0


def test_supervisor_falls_back_to_the_next_mesh_after_the_second_restart(
        tmp_path):
    meshes = [host_mesh(data=2), host_mesh()]
    built = []

    def build(mesh_):
        built.append(mesh_.size)
        return (lambda state, batch: ({"x": state["x"] + batch}, {}),
                {"x": torch.zeros(())})

    sup = TrainSupervisor(build=build, reshard=lambda s, m: s, meshes=meshes,
                          ckpt=Checkpointer(str(tmp_path), interval=1),
                          injector=FailureInjector(fail_steps=(2, 4)))
    state = sup.run(6, batch_fn=lambda step: torch.tensor(1.0))
    assert built == [2, 2, 1] and sup.restarts == 2
    assert float(state["x"]) == 6.0
    assert any("elastic rescale -> mesh 1 (1 devices)" in m for m in sup.log)


def test_straggler_monitor_fires_on_sustained_slowness():
    m = StragglerMonitor(factor=2.0, max_strikes=2)
    assert not m.observe(1.0)
    fired = [m.observe(10.0), m.observe(10.0), m.observe(10.0)]
    assert any(fired)


def test_watchdog_deadline():
    with pytest.raises(DeadlineExceeded):
        with Watchdog(0.1):
            time.sleep(0.5)


# ---------------------------------------------------------------- compression
def test_grad_compression_error_feedback():
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(64,)).astype(
        np.float32))
    q, scale, err2 = compress_leaf(g, torch.zeros_like(g))
    # dequantized + residual reconstructs the input exactly
    np.testing.assert_allclose((_dequantize(q, scale) + err2).numpy(),
                               g.numpy(), atol=1e-6)
    assert q.dtype == torch.int8


# ---------------------------------------------------------------- launcher
def test_launcher_resumes_to_the_uninterrupted_state(tmp_path, capsys):
    """6 steps with a crash after step 3 (a checkpoint every 2 steps,
    the last at step 2) resume from step 2 and end bit-equal to 6 steps
    in one go."""
    common = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "16",
              "--ckpt-interval", "2"]
    whole, parted = str(tmp_path / "whole"), str(tmp_path / "parted")
    assert launch_train.main(common + ["--steps", "6", "--ckpt-interval",
                                       "5", "--ckpt-dir", whole]) == 0
    assert launch_train.main(common + ["--steps", "4", "--ckpt-dir",
                                       parted]) == 0
    assert latest_step(parted) == 2
    assert launch_train.main(common + ["--steps", "6", "--ckpt-interval",
                                       "5", "--ckpt-dir", parted]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert latest_step(whole) == latest_step(parted) == 5
    cfg, init, _run, _dev = launch_train.build_trainer(
        "gemma3-1b", host_mesh(), device="cpu")
    _equal(restore_checkpoint(parted, 5, init()),
           restore_checkpoint(whole, 5, init()))
    losses = [ln.split()[3] for ln in out.splitlines()
              if ln.startswith("step")]
    # the whole run's steps 3-5 and the resumed run's print the same loss
    assert losses[3:6] == losses[-3:]
