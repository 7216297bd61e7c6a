"""The port's optimizers against ``repro.optim``: AdamW and Adafactor
with f32 and bf16 state, 5 steps on the same numpy trees with gradient
clipping active; the reference's own quadratic and state-dtype tests
mirrored; Adafactor factoring the same leaves as the reference on all
10 archs' published configs (the port's built on the ``meta`` device,
whose per-layer leaves drop the JAX package's leading repeat axis).

Tolerances: with f32 state the params and the state within 2e-6 of
their largest |value| and the grad norm within 1e-6 relative (the two
frameworks sum the norm and Adafactor's means in other orders); with
bf16 state the same sums may round a moment to the neighbouring bf16
value, one unit in 2^-8, so the state is held within 2^-7 of its
largest |value| and the params within 1e-4 of theirs.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import OptConfig as JaxOptConfig  # noqa: E402
from repro.optim import init_opt_state as jax_init  # noqa: E402
from repro.optim import opt_update as jax_update  # noqa: E402
from repro.optim.optimizers import _factored as jax_factored  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    OptConfig,
    init_opt_state,
    opt_state_axes,
    opt_update,
)
from repro_torch.optim.optimizers import _factored  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are small (and the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEPS = 5
SHAPES = {"emb": (200, 160), "w": (3, 130, 128), "bias": (96,),
          "gate": (), "narrow": (256, 64)}
KW = dict(lr=0.01, grad_clip=1.0, min_dim_size_to_factor=128)


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in sorted(SHAPES.items())}


def _t(tree):
    def f(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.astype(np.float32)).bfloat16()
        return torch.from_numpy(np.array(a))
    return pytree.tree_map(f, tree)


def _np(t):
    return t.float().numpy()


def _close(got, want, frac):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=frac * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_five_steps_match_jax(name, state_dtype):
    cfg = OptConfig(name=name, state_dtype=state_dtype, **KW)
    jcfg = JaxOptConfig(name=name, state_dtype=state_dtype, **KW)
    jp = jax.tree.map(jnp.asarray, _np_tree(0))
    js = jax_init(jcfg, jp)
    tp = _t(_np_tree(0))
    ts = init_opt_state(cfg, tp)
    for step in range(STEPS):
        g = _np_tree(100 + step, scale=3.0)  # a norm of about 900: clipped
        jp, js, jm = jax_update(jcfg, jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tm = opt_update(cfg, _t(g), ts, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert float(tm["grad_norm"]) > 10 * KW["grad_clip"]
    assert int(ts["step"]) == int(js["step"]) == STEPS
    assert ts["step"].dtype == torch.int32
    p_frac, s_frac = (2e-6, 2e-6) if state_dtype == "float32" else (1e-4,
                                                                    2**-7)
    for k in SHAPES:
        _close(tp[k], jp[k], p_frac)
        want = jax.tree.map(np.asarray, js["mu"][k])
        assert sorted(ts["mu"][k]) == sorted(want)
        for m, v in want.items():
            assert ts["mu"][k][m].dtype == getattr(torch, state_dtype)
            assert tuple(ts["mu"][k][m].shape) == v.shape
            _close(ts["mu"][k][m], v.astype(np.float32), s_frac)
    factored = {k for k in SHAPES if "vr" in ts["mu"][k]}
    assert factored == ({"emb", "w"} if name == "adafactor" else set())


def test_bf16_params_keep_their_dtype_and_match_jax():
    cfg, jcfg = OptConfig(**KW), JaxOptConfig(**KW)
    p = {k: v.astype(ml_dtypes.bfloat16) for k, v in _np_tree(1).items()}
    g = {k: v.astype(ml_dtypes.bfloat16)
         for k, v in _np_tree(2, scale=0.01).items()}
    jp, _js, _ = jax_update(jcfg, jax.tree.map(jnp.asarray, g),
                            jax_init(jcfg, jax.tree.map(jnp.asarray, p)),
                            jax.tree.map(jnp.asarray, p))
    tp = _t(p)
    tp, _ts, _ = opt_update(cfg, _t(g), init_opt_state(cfg, tp), tp)
    for k in SHAPES:
        assert tp[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(tp[k]),
                                      np.asarray(jp[k], np.float32))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_decreases_quadratic(name):
    ocfg = OptConfig(name=name, lr=0.1, weight_decay=0.0,
                     min_dim_size_to_factor=4)
    params = {"w": torch.ones((8, 8)) * 3.0}
    st = init_opt_state(ocfg, params)

    def loss(p):
        return torch.sum(p["w"] ** 2)

    l0 = float(loss(params))
    for _ in range(20):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss({"w": w}), [w])
        params, st, _ = opt_update(ocfg, {"w": g}, st, params)
    assert float(loss(params)) < l0 * 0.5
    if name == "adafactor":
        assert "vr" in st["mu"]["w"]  # factored second moment


def test_optimizer_bf16_state_dtype():
    ocfg = OptConfig(state_dtype="bfloat16")
    st = init_opt_state(ocfg, {"w": torch.ones((4, 4))})
    assert st["mu"]["w"]["m"].dtype == torch.bfloat16


def _port_layer_shapes(cfg):
    """{JAX leaf path: the port's shapes of that leaf, one a layer}."""
    params = M.abstract_params(cfg)
    P = len(cfg.pattern)
    out = {}
    for r in range(cfg.pattern_repeats):
        for i in range(P):
            for path, t in pytree.tree_flatten_with_path(
                    params["layers"][r * P + i])[0]:
                out.setdefault(("groups", f"l{i}") + tuple(
                    k.key for k in path), []).append(tuple(t.shape))
    for i in range(len(cfg.tail)):
        for path, t in pytree.tree_flatten_with_path(
                params["layers"][cfg.pattern_repeats * P + i])[0]:
            out[("tail", f"l{i}") + tuple(k.key for k in path)] = [
                tuple(t.shape)]
    for path, t in pytree.tree_flatten_with_path(
            {k: v for k, v in params.items() if k != "layers"})[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        if key[0] == "encoder":
            key = ("encoder", f"l{key[1]}") + key[2:]
        out[key] = [tuple(t.shape)]
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_adafactor_factors_the_same_leaves_as_jax(arch):
    ocfg = OptConfig(name="adafactor")
    jcfg = JaxOptConfig(name="adafactor")
    abstract = jax.eval_shape(lambda: JM.init_params(jax_config(arch),
                                                     jax.random.PRNGKey(0)))
    ours = _port_layer_shapes(get_config(arch))
    jleaves = jax.tree_util.tree_flatten_with_path(abstract)[0]
    assert len(jleaves) == len(ours)
    n_factored = 0
    for path, leaf in jleaves:
        key = tuple(getattr(k, "key", None) for k in path)
        want = jax_factored(leaf.shape, jcfg)
        for shape in ours[key]:
            assert _factored(shape, ocfg) == want, (key, leaf.shape, shape)
        n_factored += want
    assert n_factored > 0
    axes = opt_state_axes(ocfg, M.param_axes(get_config(arch)),
                          M.abstract_params(get_config(arch)))
    assert pytree.tree_structure(axes["mu"], is_leaf=lambda v: isinstance(
        v, tuple)) == pytree.tree_structure(init_opt_state(
            ocfg, M.abstract_params(get_config(arch)))["mu"])
