"""The port's sharding rules, specs, meshes and context
(``repro_torch.sharding``, ``repro_torch.launch.mesh``) against the JAX
reference (``repro.sharding``), which resolves them on an
``AbstractMesh`` without devices.

  * tests/test_sharding.py's rule tests, on the port;
  * ``rules_for`` equal for all 10 archs x train/prefill/decode x meshes
    (16, 16), (2, 16, 16), (4, 2), (1, 1) x batch 1, 8, 128, 256;
  * ``spec_for`` equal to ``tuple(reference.spec)`` on random axes,
    shapes, rules and meshes;
  * ``params_sharding`` and ``cache_sharding`` equal leaf for leaf on
    every arch's full config, the reference's stacked leaves with their
    leading "layers" entry dropped (the port keeps one dict a layer);
  * DTensor placements, and ``ctx.constrain``: a no-op without a
    context, a redistribution of a DTensor under a gloo ``DeviceMesh``.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from hypothesis_compat import given, settings, st  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.sharding import policies as RP  # noqa: E402

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import param_axes  # noqa: E402
from repro_torch.sharding import ctx  # noqa: E402
from repro_torch.sharding import policies as P  # noqa: E402

ARCHS = list_archs()
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")),
          ((1, 1), ("data", "model"))]


def _ref_mesh(shape, axes):
    return jax.sharding.AbstractMesh(shape, axes)


def _meshes(shape, axes):
    return TM.Mesh(axes, shape), _ref_mesh(shape, axes)


# -- tests/test_sharding.py's rule tests, on the port ---------------------
def test_spec_for_divisibility_fallback():
    mesh = TM.make_production_mesh()
    s = P.spec_for(("vocab", "embed"), (160, 64), mesh,
                   {"vocab": "model", "embed": "data"})
    assert s.spec == ("model", "data")
    # non-dividing dim replicates instead of failing
    s = P.spec_for(("kv_heads",), (3,), mesh, {"kv_heads": "model"})
    assert s.spec == (None,)


def test_spec_for_no_double_axis_use():
    mesh = TM.make_production_mesh()
    s = P.spec_for(("batch", "seq"), (64, 32), mesh,
                   {"batch": ("data",), "seq": "data"})
    assert s.spec[0] == "data" and s.spec[1] is None


def test_rules_for_decode_seq_sharding():
    mesh = TM.make_production_mesh()
    cfg = get_config("llama4-maverick-400b-a17b")  # kv=8 < model axis 16
    assert P.rules_for(cfg, "decode", 128, mesh)["cache_seq"] == "model"
    cfg2 = get_config("rwkv6-1.6b")
    assert P.rules_for(cfg2, "decode", 1, mesh)["batch"] is None


def test_moe_rules_expert_divisibility():
    mesh = TM.make_production_mesh()
    r = P.rules_for(get_config("llama4-maverick-400b-a17b"), "train", 256,
                    mesh)
    assert r["experts"] == "model"
    r = P.rules_for(get_config("mixtral-8x22b"), "train", 256, mesh)
    assert r["experts"] is None and r["expert_mlp"] == "model"


def test_cell_sharding_leading_axis_specs():
    mesh = P.cell_mesh(1)
    assert mesh.axis_names == ("cells",)
    tree = {"a": np.zeros((4, 3, 2)), "b": np.zeros((4,)),
            "c": np.zeros(())}
    sh = P.cell_sharding(mesh, tree)
    assert sh["a"].spec == ("cells", None, None)
    assert sh["b"].spec == ("cells",)
    assert sh["c"].spec == ()


# -- against the reference -----------------------------------------------
@pytest.mark.parametrize("shape,axes", MESHES, ids=lambda v: str(v))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_for_equals_reference(arch, shape, axes):
    mesh, ref_mesh = _meshes(shape, axes)
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for kind in ("train", "prefill", "decode"):
        for batch in (1, 8, 128, 256):
            assert P.rules_for(cfg, kind, batch, mesh) == RP.rules_for(
                ref_cfg, kind, batch, ref_mesh), (kind, batch)


NAMES = sorted(P.DEFAULT_RULES) + ["unknown"]
MESH_AXES = ("pod", "data", "model")


@st.composite
def _spec_case(draw):
    axes_names = draw(st.sampled_from([("data", "model"), MESH_AXES,
                                       ("cells",)]))
    sizes = tuple(draw(st.sampled_from([1, 2, 3, 4, 8, 16]))
                  for _ in axes_names)
    rank = draw(st.integers(0, 4))
    names = tuple(draw(st.sampled_from(NAMES)) for _ in range(rank))
    shape = tuple(draw(st.sampled_from([1, 2, 3, 6, 8, 12, 16, 48, 64,
                                        256]))
                  for _ in range(rank))
    targets = st.one_of(
        st.none(), st.sampled_from(MESH_AXES + ("cells", "x")),
        st.lists(st.sampled_from(MESH_AXES + ("x",)), min_size=1,
                 max_size=3, unique=True).map(tuple))
    rules = draw(st.dictionaries(st.sampled_from(NAMES), targets,
                                 max_size=6))
    return axes_names, sizes, names, shape, rules


@settings(max_examples=300, deadline=None)
@given(_spec_case())
def test_spec_for_equals_reference(case):
    axes_names, sizes, names, shape, rules = case
    mesh, ref_mesh = _meshes(sizes, axes_names)
    got = P.spec_for(names, shape, mesh, rules)
    want = RP.spec_for(names, shape, ref_mesh, rules)
    assert got.spec == tuple(want.spec)
    assert got.mesh is mesh


def _ref_layer(tree, cfg, i):
    """The reference's leaves of the port's layer i, and whether they are
    stacked over the pattern's repeats."""
    n_pat = len(cfg.pattern) * cfg.pattern_repeats
    if i < n_pat:
        return tree["groups"][f"l{i % len(cfg.pattern)}"], True
    return tree["tail"][f"l{i - n_pat}"], False


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _same_leaves(got, want, stacked, where):
    got_l, want_l = dict(_flat(got)), dict(_flat(want))
    assert got_l.keys() == want_l.keys(), where
    for path, sh in got_l.items():
        spec = tuple(want_l[path].spec)
        assert sh.spec == (spec[1:] if stacked else spec), (where, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_sharding_equals_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    abstract = M.abstract_params(cfg)
    assert all(t.device.type == "meta" for _, t in _flat(
        {k: v for k, v in abstract.items() if not isinstance(v, list)}))
    ref_abs = jax.eval_shape(lambda: RM.init_params(ref_cfg,
                                                    jax.random.PRNGKey(0)))
    for shape, axes in MESHES[:2]:
        mesh, ref_mesh = _meshes(shape, axes)
        rules = P.rules_for(cfg, "train", 256, mesh)
        got = P.params_sharding(cfg, mesh, rules, abstract)
        assert got == P.params_sharding(cfg, mesh, rules)  # meta by default
        want = RP.params_sharding(ref_cfg, ref_mesh, rules, ref_abs)
        top = {k: v for k, v in got.items() if k not in ("layers",
                                                         "encoder")}
        _same_leaves(top, {k: want[k] for k in top}, False, "top")
        for i, layer in enumerate(got["layers"]):
            ref, stacked = _ref_layer(want, cfg, i)
            _same_leaves(layer, ref, stacked, f"layer {i}")
        for i, layer in enumerate(got.get("encoder", [])):
            _same_leaves(layer, want["encoder"][f"l{i}"], False, f"enc {i}")
    # the axes tree covers every leaf of the params tree
    for i, (ax, p) in enumerate(zip(param_axes(cfg)["layers"],
                                    abstract["layers"])):
        assert dict(_flat(ax)).keys() == dict(_flat(p)).keys(), i
        for path, a in _flat(ax):
            assert len(a) == dict(_flat(p))[path].dim(), (i, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_sharding_equals_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for shape, axes in MESHES[:2]:
        mesh, ref_mesh = _meshes(shape, axes)
        for batch, clen in ((128, 4096), (1, 8192)):
            rules = P.rules_for(cfg, "decode", batch, mesh)
            got = P.cache_sharding(cfg, mesh, rules,
                                   M.cache_spec(cfg, batch, clen))
            spec = RM.cache_spec(ref_cfg, batch, clen)
            stacked = RP.cache_sharding(
                ref_cfg, ref_mesh, rules,
                {"groups": spec.get("groups", {})}, stacked=True)
            flat = RP.cache_sharding(ref_cfg, ref_mesh, rules,
                                     {"pos": spec["pos"],
                                      "tail": spec["tail"]}, stacked=False)
            assert got["pos"].spec == tuple(flat["pos"].spec)
            want = dict(stacked, tail=flat["tail"])
            for i, layer in enumerate(got["layers"]):
                ref, is_stacked = _ref_layer(want, cfg, i)
                _same_leaves(layer, ref, is_stacked, (batch, i))


def test_batch_sharding_equals_reference():
    mesh, ref_mesh = _meshes((2, 16, 16), MESH_AXES)
    rules = dict(P.DEFAULT_RULES)
    batch = {"tokens": torch.empty((256, 4096), device="meta"),
             "extras": {"frames": torch.empty((256, 1500, 384),
                                              device="meta")}}
    ref_batch = {"tokens": jax.ShapeDtypeStruct((256, 4096), np.int32),
                 "extras": {"frames": jax.ShapeDtypeStruct(
                     (256, 1500, 384), np.float32)}}
    got = P.batch_sharding(mesh, rules, batch)
    want = RP.batch_sharding(ref_mesh, rules, ref_batch)
    _same_leaves(got, want, False, "batch")


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = TM.make_production_mesh(multi_pod=True)
    sh = P.spec_for(("batch", "embed_act", "vocab"), (256, 64, 1024), mesh,
                    P.DEFAULT_RULES)
    assert sh.spec == (("pod", "data"), None, "model")
    assert sh.placements() == (Shard(0), Shard(0), Shard(2))
    rep = P.spec_for(("seq",), (7,), mesh, P.DEFAULT_RULES)
    assert rep.placements() == (Replicate(),) * 3


def test_meshes_are_shapes_until_backed():
    prod = TM.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16} and prod.form == "abstract"
    multi = TM.make_production_mesh(multi_pod=True)
    assert multi.axis_names == MESH_AXES and multi.size == 512
    host = TM.host_mesh(2, 2)
    assert host.form == "one_device" and host.device == torch.device("cpu")
    assert host.shape == {"data": 2, "model": 2}
    pod = TM.make_mesh_for("cpu", data=2, model=1, pod=2)
    assert pod.axis_names == MESH_AXES and pod.axis_sizes == (2, 2, 1)
    with pytest.raises(ValueError):
        prod.device


def test_constrain_is_a_no_op_without_a_context():
    x = torch.arange(12.0).reshape(3, 4)
    assert ctx.active() is None
    assert ctx.constrain(x, ("batch", "embed")) is x
    with ctx.use(TM.host_mesh(), P.DEFAULT_RULES):
        assert ctx.active()[1] is P.DEFAULT_RULES
        assert ctx.constrain(x, ("batch", "embed")) is x  # no DeviceMesh
    assert ctx.active() is None


GLOO_CTX = """
import sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, {src!r})

def work(rank, store, q):
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=2)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import process_mesh
    from repro_torch.sharding import ctx
    from repro_torch.sharding.policies import DEFAULT_RULES
    mesh = process_mesh((2, 1), ("data", "model"))
    x = torch.arange(32.0).reshape(8, 4)
    d = distribute_tensor(x, mesh.device_mesh, [Replicate(), Replicate()])
    with ctx.use(mesh, DEFAULT_RULES):
        y = ctx.constrain(d, ("batch", "embed_act"))
        plain = ctx.constrain(x, ("batch", "embed_act"))
    ok = (tuple(y.placements) == (Shard(0), Replicate())
          and y.to_local().shape == (4, 4)
          and torch.equal(y.full_tensor(), x) and plain is x)
    q.put((rank, ok))
    dist.destroy_process_group()

if __name__ == "__main__":
    ctx_ = mp.get_context("spawn")
    q = ctx_.Queue()
    ps = [ctx_.Process(target=work, args=(r, sys.argv[1], q))
          for r in range(2)]
    for p in ps:
        p.start()
    res = dict(q.get(timeout=120) for _ in ps)
    for p in ps:
        p.join(30)
    print("CTX", res[0], res[1])
"""


def test_constrain_redistributes_a_dtensor_on_a_device_mesh(tmp_path):
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    script = tmp_path / "ctx.py"
    script.write_text(textwrap.dedent(GLOO_CTX.format(src=src)))
    r = subprocess.run([sys.executable, str(script), str(tmp_path / "st")],
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    assert "CTX True True" in r.stdout, r.stdout + r.stderr
