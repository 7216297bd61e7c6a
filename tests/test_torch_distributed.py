"""Distributed ORTHRUS in the port (``repro_torch.core.distributed``)
against the JAX reference (``repro.core.distributed.make_engine``).

The reference runs once, in a fresh interpreter with 8 host devices
(``--xla_force_host_platform_device_count=8``, as tests/test_sharding.py
runs it), over meshes of 1, 2, 4 and 8 devices; every cell's per-shard
commits must equal the port's exactly (int32, tolerance 0):

  * the one-device form (the ``cc`` axis a leading tensor dimension, the
    all-to-all a transpose), under both ``kernel_impl`` settings;
  * the process form (one rank a shard, ``all_to_all_single`` under
    gloo) at 2 and 4 spawned ranks, against the one-device form;
  * the fixed-size compaction against ``jnp.nonzero(size=,
    fill_value=-1)``.

Cells: tests/test_sharding.py's ``test_distributed_orthrus_8dev`` cell at
rounds 1, 5, 50 and 200 and its shape over 1, 2 and 4 shards; a hot
YCSB cell (the port's ``make_workload``, 64 hot keys, all owned by shard
0); an overflow cell (``msg_cap`` < ``lanes_per_shard``); a read-only
cell; and the reference's two stuck lanes: a txn naming one key twice,
and two lanes that ask for one key in the same round.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core.workloads import WorkloadConfig, make_workload  # noqa: E402
from repro_torch.launch.mesh import one_device_mesh  # noqa: E402

BASE = dict(lanes_per_shard=8, keys_per_txn=3, keys_per_shard=512,
            msg_cap=32)


def _random_txns(n_cc, cfg, seed=0):
    """tests/test_sharding.py's draw: sorted keys over the whole key
    space, modes 0/1."""
    rng = np.random.default_rng(seed)
    n = n_cc * cfg.lanes_per_shard
    keys = np.sort(rng.integers(0, n_cc * cfg.keys_per_shard,
                                (n, cfg.keys_per_txn)), axis=1)
    modes = rng.integers(0, 2, keys.shape)
    return keys.astype(np.int32), modes.astype(np.int32)


def _ycsb_txns(n_cc, cfg, num_hot, seed=1):
    """The port's YCSB txns, each row's keys sorted with their modes."""
    wl = make_workload(WorkloadConfig(
        kind="ycsb", num_txns=n_cc * cfg.lanes_per_shard,
        num_records=n_cc * cfg.keys_per_shard, num_hot=num_hot,
        ops_per_txn=cfg.keys_per_txn, seed=seed))
    order = np.argsort(wl.keys, axis=1, kind="stable")
    return (np.take_along_axis(wl.keys, order, 1).astype(np.int32),
            np.take_along_axis(wl.modes, order, 1).astype(np.int32))


def _cells():
    cells = {}
    for rounds in (1, 5, 50, 200):
        cfg = D.DistConfig(rounds=rounds, **BASE)
        cells[f"base8_r{rounds}"] = (8, cfg, *_random_txns(8, cfg))
    for n_cc in (1, 2, 4):
        cfg = D.DistConfig(rounds=200, **BASE)
        cells[f"base{n_cc}_r200"] = (n_cc, cfg, *_random_txns(n_cc, cfg))
    for n_cc in (2, 8):
        cfg = D.DistConfig(lanes_per_shard=8, keys_per_txn=4, rounds=120,
                           keys_per_shard=1024, msg_cap=8)
        cells[f"hot{n_cc}"] = (n_cc, cfg, *_ycsb_txns(n_cc, cfg, 64))
    for n_cc in (2, 8):
        cfg = D.DistConfig(lanes_per_shard=16, keys_per_txn=2, rounds=100,
                           keys_per_shard=64, msg_cap=4)
        cells[f"overflow{n_cc}"] = (n_cc, cfg, *_random_txns(n_cc, cfg, 2))
    cfg = D.DistConfig(lanes_per_shard=8, keys_per_txn=3, rounds=100,
                       keys_per_shard=128, msg_cap=8)
    keys, modes = _random_txns(4, cfg, 3)
    cells["read_only4"] = (4, cfg, keys, np.zeros_like(modes))
    dup = D.DistConfig(lanes_per_shard=2, keys_per_txn=2, rounds=50,
                       keys_per_shard=16, msg_cap=2)
    keys = np.array([[3, 3], [5, 9]], np.int32)
    cells["dup_key_write"] = (1, dup, keys,
                              np.array([[1, 1], [1, 1]], np.int32))
    cells["dup_key_read"] = (1, dup, keys,
                             np.array([[0, 0], [1, 1]], np.int32))
    pair = dataclasses.replace(dup, rounds=60)
    ones = np.ones((2, 2), np.int32)
    cells["pair_contended"] = (1, pair, np.array([[5, 7], [5, 9]], np.int32),
                               ones)
    cells["pair_disjoint"] = (1, pair, np.array([[4, 7], [5, 9]], np.int32),
                              ones)
    return cells


CELLS = _cells()

REFERENCE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core.distributed import DistConfig, make_engine
assert len(jax.devices()) == 8
cells = json.load(open(sys.argv[1]))
out = {}
for name, c in cells.items():
    mesh = Mesh(np.array(jax.devices()[:c["n_cc"]]), ("cc",))
    fn = jax.jit(make_engine(mesh, DistConfig(**c["cfg"])))
    commits = fn(jnp.asarray(np.array(c["keys"], np.int32)),
                 jnp.asarray(np.array(c["modes"], np.int32)))
    out[name] = np.asarray(commits).tolist()
print("REF " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Per-shard commits of every cell from the JAX reference."""
    path = tmp_path_factory.mktemp("dist") / "cells.json"
    path.write_text(json.dumps({
        name: {"n_cc": n_cc, "cfg": vars(cfg), "keys": keys.tolist(),
               "modes": modes.tolist()}
        for name, (n_cc, cfg, keys, modes) in CELLS.items()}))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path)],
                       capture_output=True, text=True, env=env, timeout=240)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("REF ")][-1]
    return json.loads(line[4:])


def _one_device(name, kernel_impl="auto"):
    n_cc, cfg, keys, modes = CELLS[name]
    mesh = one_device_mesh((n_cc,), ("cc",), "cpu")
    return D.make_engine(mesh, cfg, kernel_impl=kernel_impl)(keys, modes)


@pytest.mark.parametrize("kernel_impl", ["jnp", "pallas"])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_one_device_form_matches_reference(reference, name, kernel_impl):
    got = _one_device(name, kernel_impl)
    assert got.dtype == torch.int32
    assert got.tolist() == reference[name]


def test_reference_cell_commits(reference):
    """tests/test_sharding.py's cell, its per-shard commits pinned."""
    assert reference["base8_r200"] == [200, 200, 175, 200, 200, 175, 200,
                                       200]
    assert _one_device("base8_r200").tolist() == reference["base8_r200"]
    assert D.run_distributed(one_device_mesh((8,), ("cc",), "cpu"),
                             CELLS["base8_r200"][1], *CELLS["base8_r200"][2:],
                             kernel_impl="jnp") == 1550


def test_overflow_and_hot_cells_exercise_their_paths(reference):
    """The overflow cell's cap binds (its commits differ from the same
    cell with room for every lane), and every txn of the hot cell sends
    to shard 0, the owner of the 64 hot keys."""
    n_cc, cfg, keys, modes = CELLS["overflow8"]
    wide = D.make_engine(one_device_mesh((n_cc,), ("cc",), "cpu"),
                         D.DistConfig(**dict(vars(cfg), msg_cap=16)))
    assert reference["overflow8"] != wide(keys, modes).tolist()
    _n, cfg, keys, _modes = CELLS["hot8"]
    assert (keys.min(1) // cfg.keys_per_shard == 0).all()
    assert (keys < 64).any(1).all()


def test_duplicate_key_txn_is_stuck_as_in_the_reference(reference):
    """A txn naming one key twice, the second time as a write, waits on
    its own hold forever (ROADMAP Queue 3): lane 0 never commits, lane 1
    alone does (8 in 50 rounds). Two reads of one key do not stick."""
    assert reference["dup_key_write"] == [8]
    assert reference["dup_key_read"] == [16]
    n_cc, cfg, keys, modes = CELLS["dup_key_write"]
    k = torch.from_numpy(keys).reshape(1, 2, 2)
    m = torch.from_numpy(modes).reshape(1, 2, 2)
    state = D.initial_state(cfg, 1, "cpu")
    round_ = D.make_round(cfg, n_cc, torch.zeros(1, dtype=torch.int32), k,
                          m, kernel=False)
    for _ in range(cfg.rounds):
        round_(state)
    assert state["commits"].tolist() == reference["dup_key_write"]
    assert state["phase"][0, 0] == D.D_ACQ and state["kptr"][0, 0] == 1
    assert bool(state["pending"][0, 0])
    assert state["wh"][0, 3] == 0  # lane 0 holds its own first write


def test_a_denied_request_is_never_retried_as_in_the_reference(reference):
    """The CC drops a request it does not grant, and the lane stays
    pending for good (ROADMAP Queue 3): of two lanes that write key 5 in
    the same round, one never commits; with disjoint keys both do."""
    assert reference["pair_contended"] == [10]
    assert reference["pair_disjoint"] == [20]
    n_cc, cfg, keys, modes = CELLS["pair_contended"]
    state = D.initial_state(cfg, 1, "cpu")
    round_ = D.make_round(cfg, n_cc, torch.zeros(1, dtype=torch.int32),
                          torch.from_numpy(keys).reshape(1, 2, 2),
                          torch.from_numpy(modes).reshape(1, 2, 2),
                          kernel=False)
    for _ in range(cfg.rounds):
        round_(state)
    assert state["commits"].tolist() == [10]
    assert state["pending"][0].tolist() == [False, True]
    assert state["kptr"][0, 1] == 0


@pytest.mark.parametrize("seed", range(6))
def test_compaction_is_nonzero_with_fill(seed):
    jnp = pytest.importorskip("jax.numpy")
    rng = np.random.default_rng(seed)
    rows, n = int(rng.integers(1, 5)), int(rng.integers(1, 300))
    mask = rng.random((rows, n)) < rng.choice([0.0, 0.1, 0.5, 1.0])
    for size in (n, max(1, n // 3)):
        got = D.compact_indices(torch.from_numpy(mask), size)
        for r in range(rows):
            want = jnp.nonzero(jnp.asarray(mask[r]), size=size,
                               fill_value=-1)[0]
            assert got[r].tolist() == np.asarray(want).tolist()
        assert got.dtype == torch.int32


PROCESS = """
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, {src!r})

def work(rank, world, store, cells, q):
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import process_mesh
    mesh = process_mesh((world,), ("cc",))
    out = {{}}
    for name, c in cells.items():
        fn = D.make_engine(mesh, D.DistConfig(**c["cfg"]))
        out[name] = fn(np.array(c["keys"]), np.array(c["modes"])).tolist()
    q.put((rank, out))
    dist.destroy_process_group()

if __name__ == "__main__":
    world, store, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    cells = json.load(open(path))
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    ps = [ctx.Process(target=work, args=(r, world, store, cells, q))
          for r in range(world)]
    for p in ps:
        p.start()
    res = dict(q.get(timeout=120) for _ in ps)
    for p in ps:
        p.join(30)
    print("PROC " + json.dumps(res))
"""


@pytest.mark.parametrize("world", [2, 4])
def test_process_form_under_gloo_matches_one_device_form(tmp_path, world):
    names = [n for n, c in CELLS.items() if c[0] == world]
    path = tmp_path / "cells.json"
    path.write_text(json.dumps({
        n: {"cfg": vars(CELLS[n][1]), "keys": CELLS[n][2].tolist(),
            "modes": CELLS[n][3].tolist()} for n in names}))
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    script = tmp_path / "proc.py"
    script.write_text(textwrap.dedent(PROCESS.format(src=src)))
    r = subprocess.run([sys.executable, str(script), str(world),
                        str(tmp_path / "store"), str(path)],
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("PROC ")][-1]
    res = json.loads(line[5:])
    assert sorted(res) == [str(i) for i in range(world)]
    for name in names:
        want = _one_device(name).tolist()
        for rank in range(world):
            assert res[str(rank)][name] == want, (name, rank)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["base8_r5", "base8_r200", "hot8",
                                  "overflow8"])
def test_one_device_form_on_card_equals_cpu(name):
    """On a card the rounds replay as CUDA graphs of ROUNDS_PER_REPLAY
    rounds and one of the remainder (5 = 0 x 8 + 5, 100 = 12 x 8 + 4),
    B1's sorted form once a round on the kernel path; both paths give the
    CPU's commits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.lock_grant import ops

    n_cc, cfg, keys, modes = CELLS[name]
    want = _one_device(name).tolist()
    mesh = one_device_mesh((n_cc,), ("cc",), "cuda")
    for impl, launches in (("auto", cfg.rounds), ("jnp", 0)):
        ops.launches = 0
        got = D.make_engine(mesh, cfg, kernel_impl=impl)(keys, modes)
        assert got.device.type == "cuda"
        assert got.tolist() == want, impl
        assert ops.launches == launches, impl
