"""The port's training loss and its gradients against the JAX package's
``repro.models.transformer.loss_fn`` and ``jax.value_and_grad``, in
float32 at SMOKE configs cut to one pattern repeat, on the same weights
(the port's random ones, laid out as the JAX package stacks them) and
tokens; the JAX grads map onto the port's layout through
``params_from_numpy``. The JAX reference runs once per config, jitted
(faster than op by op at these sizes).

Covered: gemma3-1b (a sliding-window and a global layer, the whole and
the chunked loss), rwkv6-1.6b, mixtral-8x22b's planned MoE (one plan
and per-shard plans over 2 shards) and llama4-maverick's early fusion,
each through the kernels' wrappers (``kernel_impl="pallas"``: on the CPU
a wrapper runs its plain version, under ``kernels.autograd.kernel_call``
as on the card) and through the plain formulations ("jnp"); with the
wrappers' outputs detached, as the CUDA wrappers' are, the gradient is
the plain path's. Per-layer
remat changes no bit of the loss or the grads under any policy. The
other six archs give a finite gradient with a non-zero entry on every
leaf.

Tolerances (float32): the loss within 1e-5 relative; each grad leaf
within 1e-4 of the reference leaf's largest |value| (the two frameworks
sum in other orders, and the kernels' plain versions take attention's
and the scan's sums in another order than the models' formulations).
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import get_smoke_config, list_archs  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    TrainConfig,
    loss_and_grads,
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


LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of the reference leaf's largest |value|
B, S = 2, 32
CROSS_GATE = 0.5  # tanh(0) = 0 would give the cross layers no gradient

DIFF_CASES = [
    ("gemma3-1b", "pallas", 0, {}),
    ("gemma3-1b", "jnp", 0, {}),
    ("gemma3-1b", "pallas", 8, {}),
    ("rwkv6-1.6b", "pallas", 0, {}),
    ("rwkv6-1.6b", "jnp", 0, {}),
    ("mixtral-8x22b", "pallas", 0, {}),
    ("mixtral-8x22b", "jnp", 0, {}),
    ("mixtral-8x22b", "pallas", 0, {"moe_dispatch_shards": 2}),
    ("llama4-maverick-400b-a17b", "pallas", 16, {}),
]
OTHER_ARCHS = [a for a in list_archs()
               if a not in {c[0] for c in DIFF_CASES}]


def _cfgs(arch, **kw):
    kw = dict(dtype="float32", pattern_repeats=1, **kw)
    return (dataclasses.replace(jax_smoke(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    extras = {}
    for name, n in (("vision_embeds",
                     cfg.early_fusion_tokens or cfg.vision_tokens),
                    ("audio_frames", cfg.audio_frames)):
        if n:
            extras[name] = rng.standard_normal((B, n, cfg.d_model)).astype(
                np.float32)
    if extras:
        batch["extras"] = extras
    return batch


def _torch_batch(batch):
    return pytree.tree_map(torch.from_numpy, batch)


def _params(cfg, seed):
    """The port's random weights, every ``cross_gate`` at CROSS_GATE."""
    params = TF.init_params(cfg, seed, "cpu")
    for layer in params["layers"]:
        if "cross_gate" in layer:
            layer["cross_gate"].fill_(CROSS_GATE)
    return params


def _jax_tree(cfg, params):
    """The port's params (one pattern repeat) in the JAX package's layout:
    ``groups/l{i}`` the pattern's layers with a leading repeat axis of 1,
    ``tail/l{i}`` the rest; numpy leaves."""
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


@functools.lru_cache(maxsize=None)
def _reference(arch, chunk, kw):
    """The JAX loss, aux and grads (the port's layout) on ``_params(.., 3)``
    and ``_batch(.., 4)``, computed once per (arch, chunk, config)."""
    jcfg, tcfg = _cfgs(arch, **dict(kw))
    jp = _jax_tree(tcfg, _params(tcfg, 3))
    jbatch = jax.tree.map(jax.numpy.asarray, _batch(tcfg, 4))
    (loss, aux), g = jax.jit(jax.value_and_grad(
        lambda p: JTF.loss_fn(p, jcfg, jbatch, remat=False,
                              loss_chunk=chunk), has_aux=True))(jp)
    return (float(loss), float(aux["aux"]),
            params_from_numpy(tcfg, jax.tree.map(np.asarray, g), "cpu"))


@pytest.mark.parametrize("arch,impl,chunk,kw", DIFF_CASES)
def test_loss_and_grads_match_jax(arch, impl, chunk, kw):
    _jcfg, tcfg = _cfgs(arch, **kw)
    jloss, jaux, want = _reference(arch, chunk, tuple(kw.items()))
    loss, grads = loss_and_grads(
        tcfg, TrainConfig(loss_chunk=chunk), _params(tcfg, 3),
        _torch_batch(_batch(tcfg, 4)), kernel_impl=impl)
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    # the same leaves (the reference's dicts have sorted keys), each close
    assert sorted(pytree.keystr(k) for k, _ in
                  pytree.tree_flatten_with_path(grads)[0]) == sorted(
        pytree.keystr(k) for k, _ in pytree.tree_flatten_with_path(want)[0])

    def close(g, w):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=0,
            atol=GRAD_TOL * max(float(w.abs().max()), 1e-30))

    pytree.tree_map(close, grads, want)
    if tcfg.num_experts:
        assert jaux > 0


def _detached(fn):
    """``fn`` as a CUDA wrapper returns: its outputs with no ``grad_fn``."""
    def call(*args, **kw):
        with torch.no_grad():
            out = fn(*args, **kw)
        return pytree.tree_map(lambda t: t.detach(), out)
    return call


@pytest.mark.parametrize("arch", ["gemma3-1b", "rwkv6-1.6b",
                                  "mixtral-8x22b"])
def test_kernels_without_grad_fn_get_their_plain_versions_gradient(
        arch, monkeypatch):
    """With B3, B4 and B5's wrappers replaced by versions whose outputs
    have no ``grad_fn`` (as the CUDA wrappers' have not), every leaf
    still gets the plain path's gradient: ``kernel_call`` recomputes the
    plain version in the backward."""
    from repro_torch.models import layers, moe, ssm

    for mod, name in ((layers, "flash_attention"), (ssm, "rwkv6_scan"),
                      (moe, "moe_dispatch_plan")):
        monkeypatch.setattr(mod, name, _detached(getattr(mod, name)))
    _jcfg, tcfg = _cfgs(arch)
    params, batch = _params(tcfg, 3), _torch_batch(_batch(tcfg, 4))
    _, want = loss_and_grads(tcfg, TrainConfig(loss_chunk=0), params, batch,
                             kernel_impl="jnp")
    _, got = loss_and_grads(tcfg, TrainConfig(loss_chunk=0), params, batch,
                            kernel_impl="pallas")

    def close(g, w):
        assert g.abs().max() > 0
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_TOL * float(w.abs().max()))

    pytree.tree_map(close, got, want)


@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_no_batch"])
@pytest.mark.parametrize("arch", ["gemma3-1b", "rwkv6-1.6b",
                                  "mixtral-8x22b"])
def test_remat_changes_no_bit(arch, policy):
    _jcfg, tcfg = _cfgs(arch)
    params = TF.init_params(tcfg, 1, "cpu")
    batch = _torch_batch(_batch(tcfg, 2))
    flat, spec = pytree.tree_flatten(params)

    def run(remat):
        leaves = [p.clone().requires_grad_(True) for p in flat]
        loss, _ = TF.loss_fn(pytree.tree_unflatten(leaves, spec), tcfg,
                             batch, remat=remat, remat_policy=policy,
                             kernel_impl="pallas")
        return loss, torch.autograd.grad(loss, leaves)

    (l0, g0), (l1, g1) = run(False), run(True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_other_archs_grads_are_finite_and_reach_every_leaf(arch):
    _jcfg, tcfg = _cfgs(arch)
    loss, grads = loss_and_grads(tcfg, TrainConfig(loss_chunk=0),
                                 _params(tcfg, 0),
                                 _torch_batch(_batch(tcfg, 1)),
                                 kernel_impl="pallas")
    assert np.isfinite(float(loss))
    for path, g in pytree.tree_flatten_with_path(grads)[0]:
        assert torch.isfinite(g).all(), pytree.keystr(path)
        assert g.abs().max() > 0, pytree.keystr(path)


def test_state_out_under_autograd_raises():
    """B5 would write ``state_out`` behind autograd's back."""
    from repro_torch.models import ssm

    _jcfg, tcfg = _cfgs("rwkv6-1.6b")
    p = _params(tcfg, 0)["layers"][0]["tm"]
    x = torch.randn((1, 4, tcfg.d_model), requires_grad=True)
    z = torch.zeros((1, tcfg.d_model))
    st = torch.zeros((1, tcfg.ssm_heads, tcfg.head_dim, tcfg.head_dim))
    with pytest.raises(ValueError, match="state_out"):
        ssm.rwkv_timemix(x, z, st, p, kernel_impl="pallas", state_out=st)
    with torch.no_grad():
        ssm.rwkv_timemix(x, z, st, p, kernel_impl="pallas", state_out=st)


@pytest.mark.parametrize("grad", [False, True])
def test_kernel_plan_is_one_call_of_the_wrapper(grad, monkeypatch):
    """A MoE layer's plan is one call of B3's wrapper (one launch on the
    card), with autograd or without."""
    from repro_torch.models import moe

    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    orig = moe.moe_dispatch_plan
    monkeypatch.setattr(moe, "moe_dispatch_plan", counted)
    _jcfg, tcfg = _cfgs("mixtral-8x22b")
    p = _params(tcfg, 0)["layers"][0]["moe"]
    x = torch.randn((2, 8, tcfg.d_model), requires_grad=grad)
    with torch.set_grad_enabled(grad):
        out, _aux = moe.apply_moe(x, p, top_k=2, capacity_factor=1.25,
                                  kernel_impl="pallas")
    assert len(calls) == 1 and out.requires_grad == grad
