"""The port's flash_attention (kernel B4) against the JAX package: its
plain version against the Pallas kernel in interpret mode and the JAX
oracle, the model's blocked formulation against the plain version, the
wrapper's CPU path, and (on a card) the CUDA kernel against its plain
version. The JAX package is imported by the tests that compare with it,
so the card's test runs where JAX is not installed.

Tolerances are those of tests/test_kernels.py: 3e-5 in float32, 2e-2 in
bfloat16 (the port's plain version takes the scores in f32, as the
kernels do; the JAX oracle rounds them to bf16 first).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

ATOL = {"float32": 3e-5, "bfloat16": 2e-2}
KINDS = [("full", 0), ("swa", 64), ("chunked", 64)]
# tests/test_kernels.py's shapes, plus gemma3-1b's GQA 4:1 at head_dim 256
SHAPES = [(128, 4, 2, 32), (256, 2, 2, 64), (128, 4, 1, 256)]


def _inputs(S, T, H, KV, D, dtype, seed, B=2):
    """q [B,S,H,D], k/v [B,T,KV,D] as torch tensors of ``dtype`` (and
    the same values as numpy f32 arrays)."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D)):
        t = torch.from_numpy(
            (rng.standard_normal(shape) * 0.2).astype(np.float32)
        ).to(getattr(torch, dtype))
        out.append((t, t.float().numpy()))
    return out


@pytest.fixture(scope="module")
def jax_fa():
    """(jnp, the JAX wrapper, the JAX oracle)."""
    jax = pytest.importorskip("jax")
    ops_j = pytest.importorskip("repro.kernels.flash_attention.ops")
    ref_j = pytest.importorskip("repro.kernels.flash_attention.ref")
    return (jax.numpy, ops_j.flash_attention,
            jax.jit(ref_j.flash_attention_ref,
                    static_argnames=("kind", "window")))


def _oracle(jax_fa, q, k, v, kind, window):
    """The JAX oracle in the model's layout (KV heads broadcast)."""
    jnp, _, jax_flash_ref = jax_fa
    G = q.shape[2] // k.shape[2]
    kb = jnp.repeat(k, G, 2).transpose(0, 2, 1, 3)
    vb = jnp.repeat(v, G, 2).transpose(0, 2, 1, 3)
    return jax_flash_ref(q.transpose(0, 2, 1, 3), kb, vb, kind=kind,
                         window=window).transpose(0, 2, 1, 3)


def _close(got, want, dtype):
    np.testing.assert_allclose(
        np.asarray(got.float().numpy() if isinstance(got, torch.Tensor)
                   else np.asarray(got, np.float32), np.float32),
        np.asarray(want, np.float32), atol=ATOL[dtype])


@pytest.mark.parametrize("kind,window", KINDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,KV,D", SHAPES)
def test_plain_version_matches_pallas_interpret_and_oracle(
        jax_fa, kind, window, dtype, S, H, KV, D):
    jnp, jax_flash, _ = jax_fa
    (qt, q), (kt, k), (vt, v) = _inputs(S, S, H, KV, D, dtype, seed=S + H + D)
    q, k, v = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    got = flash_attention_ref(qt, kt, vt, kind=kind, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    pallas = jax_flash(q, k, v, kind=kind, window=window, q_block=64,
                       kv_block=64, interpret=True)
    _close(got, pallas, dtype)
    _close(got, _oracle(jax_fa, q, k, v, kind, window), dtype)


@pytest.mark.parametrize("kind,window", KINDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,T", [(100, 100), (77, 130)])
def test_plain_version_ragged_matches_oracle(jax_fa, kind, window, dtype, S,
                                            T):
    """Prompt lengths are no multiple of a block (the Pallas wrapper
    cannot take them): the plain version against the oracle only."""
    jnp = jax_fa[0]
    (qt, q), (kt, k), (vt, v) = _inputs(S, T, 4, 1, 64, dtype, seed=S + T)
    q, k, v = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    got = flash_attention_ref(qt, kt, vt, kind=kind, window=window)
    _close(got, _oracle(jax_fa, q, k, v, kind, window), dtype)


@pytest.mark.parametrize("kind,window", [("full", 0), ("swa", 16),
                                         ("chunked", 16), ("swa", 40)])
@pytest.mark.parametrize("S,q_block", [(100, 32), (64, 64), (37, 512)])
def test_attend_blocked_matches_plain_version(kind, window, S, q_block):
    """The model's plain formulation (ragged last block) and B4's plain
    version are one function (f32)."""
    (qt, _), (kt, _), (vt, _) = _inputs(S, S, 4, 2, 32, "float32", seed=S)
    spec = L.AttnSpec(num_heads=4, num_kv_heads=2, head_dim=32, kind=kind,
                      window=window, q_block=q_block)
    got = L._attend_blocked(qt, kt, vt, spec)
    want = flash_attention_ref(qt, kt, vt, kind=kind, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5)


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    (qt, _), (kt, _), (vt, _) = _inputs(40, 40, 4, 1, 32, "float32", seed=1)
    before = ops.launches
    got = ops.flash_attention(qt, kt, vt, kind="swa", window=8)
    assert ops.launches == before
    assert torch.equal(got, flash_attention_ref(qt, kt, vt, kind="swa",
                                                window=8))


def test_kernel_launch_rejects_cpu_tensors():
    (qt, _), (kt, _), (vt, _) = _inputs(8, 8, 2, 1, 32, "float32", seed=2)
    with pytest.raises(ValueError):
        ops.flash_attention_cuda(qt, kt, vt)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A CUDA tensor either gets the kernel or an error: with no nvcc the
    first launch's build raises (no cached library to fall back on)."""
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(ops, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops._library()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,window", [("full", 0), ("swa", 512),
                                         ("chunked", 512), ("swa", 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,H,KV,D", [
    (1, 7, 7, 4, 1, 256), (1, 513, 513, 4, 1, 256), (1, 1000, 1000, 4, 1, 256),
    (2, 128, 128, 4, 2, 32), (2, 256, 256, 2, 2, 64), (1, 100, 160, 8, 2, 128),
])
def test_flash_attention_kernel_matches_plain_on_card(kind, window, dtype, B,
                                                      S, T, H, KV, D):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    (qt, _), (kt, _), (vt, _) = _inputs(S, T, H, KV, D, dtype, seed=S, B=B)
    qt, kt, vt = (t.cuda() for t in (qt, kt, vt))
    got = ops.flash_attention_cuda(qt, kt, vt, kind=kind, window=window)
    torch.cuda.synchronize()
    want = flash_attention_ref(qt, kt, vt, kind=kind, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=ATOL[dtype])


# -- the wrapper's choice of kernel and its refusals (CPU, stub library) --


@pytest.fixture
def stub_entries(monkeypatch):
    """Fake CUDA tensors (``FakeTensorMode``) and stub libraries: yields
    the list of C entry points called, in order."""
    import warnings

    from torch._subclasses.fake_tensor import FakeTensorMode

    calls = []

    class Stub:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(ops, "_library", lambda: Stub())
    monkeypatch.setattr(ops, "_simt_library", lambda: Stub())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # fake data_ptr() is 0
        with FakeTensorMode():
            yield calls


def _fake(S, T, H, KV, D, dtype, B=1):
    return (torch.zeros(B, S, H, D, dtype=dtype, device="cuda"),
            torch.zeros(B, T, KV, D, dtype=dtype, device="cuda"),
            torch.zeros(B, T, KV, D, dtype=dtype, device="cuda"))


@pytest.mark.parametrize("dtype,entry", [
    (torch.bfloat16, "flash_attention_tc_launch"),
    (torch.float32, "flash_attention_launch"),
])
@pytest.mark.parametrize("H,KV", [(48, 8), (4, 1), (3, 1), (2, 2)])
def test_wrapper_sends_each_dtype_to_its_kernel(stub_entries, dtype, entry,
                                                H, KV):
    """bf16 goes to the tensor-core entry (which chooses its own head
    packing: heads_per_block 0), f32 to the CUDA-core entry."""
    before = ops.launches
    o = ops.flash_attention_cuda(*_fake(100, 130, H, KV, 128, dtype),
                                 kind="swa", window=64)
    assert o.shape == (1, 100, H, 128) and o.dtype == dtype
    assert [name for name, _ in stub_entries] == [entry]
    args = stub_entries[0][1]
    assert args[4:10] == (1, 100, 130, H, KV, 128)
    if dtype == torch.bfloat16:
        assert args[10:13] == (ops.KINDS["swa"], 64, 0)
    else:
        assert args[10:13] == (ops.DTYPES[dtype], ops.KINDS["swa"], 64)
    assert ops.launches == before + 1


def test_private_entries_do_not_count(stub_entries):
    args = _fake(64, 64, 4, 1, 256, torch.bfloat16)
    before = ops.launches
    ops._flash_attention_simt(*args)
    ops._flash_attention_tc(*args, heads_per_block=1)
    ops._flash_attention_tc(*args, heads_per_block=2)
    assert [name for name, _ in stub_entries] == [
        "flash_attention_launch", "flash_attention_tc_launch",
        "flash_attention_tc_launch"]
    assert stub_entries[0][1][10] == ops.DTYPES[torch.bfloat16]
    assert [c[1][12] for c in stub_entries[1:]] == [1, 2]
    assert ops.launches == before


def _transposed(S, T, H, KV, D, dtype):
    """q strided as a [B, H, S, d] tensor seen as [B, S, H, d]."""
    _q, k, v = _fake(S, T, H, KV, D, dtype)
    q = torch.empty_strided((1, S, H, D), (S * H * D, D, S * D, 1),
                            dtype=dtype, device="cuda")
    return q, k, v


@pytest.mark.parametrize("make,exc", [
    (lambda: _fake(64, 64, 4, 1, 8, torch.bfloat16), ValueError),
    (lambda: _fake(64, 64, 4, 1, 48, torch.bfloat16), ValueError),
    (lambda: _fake(64, 64, 4, 1, 512, torch.bfloat16), ValueError),
    (lambda: _fake(64, 64, 4, 1, 96, torch.float32), ValueError),
    (lambda: _fake(64, 64, 4, 1, 128, torch.float16), TypeError),
    (lambda: _fake(64, 64, 4, 1, 128, torch.float64), TypeError),
    (lambda: _transposed(64, 64, 4, 1, 128, torch.bfloat16), ValueError),
    (lambda: tuple(torch.zeros(64, h, 128, dtype=torch.bfloat16,
                               device="cuda") for h in (4, 1, 1)),
     ValueError),
    (lambda: _fake(64, 64, 4, 3, 128, torch.bfloat16), ValueError),
    (lambda: _fake(65, 64, 4, 1, 128, torch.bfloat16), ValueError),
    (lambda: (_fake(64, 64, 4, 1, 128, torch.bfloat16)[0],
              *_fake(64, 64, 4, 1, 64, torch.bfloat16)[1:]), ValueError),
    (lambda: (_fake(64, 64, 4, 1, 128, torch.bfloat16)[0],
              *_fake(64, 64, 4, 1, 128, torch.float32)[1:]), TypeError),
])
def test_unsupported_inputs_raise_before_any_launch(stub_entries, make, exc):
    """Head dims outside HEAD_DIMS, dtypes other than f32 and bf16, and
    layouts the kernels do not read raise, and nothing is launched."""
    before = ops.launches
    with pytest.raises(exc):
        ops.flash_attention_cuda(*make())
    assert stub_entries == [] and ops.launches == before


@pytest.mark.parametrize("kind,window", [("bogus", 0), ("swa", -1)])
def test_unsupported_mask_raises_before_any_launch(stub_entries, kind,
                                                   window):
    with pytest.raises(ValueError):
        ops.flash_attention_cuda(*_fake(64, 64, 4, 1, 128, torch.bfloat16),
                                 kind=kind, window=window)
    assert stub_entries == []


# -- on the card: the tensor-core kernel at the main path's layouts -------


def _hold_on_card(B, S, T, H, KV, D, dtype, kind, window, seed, scale=0.2):
    """The kernel against its plain version on the card: f32 within 3e-5,
    bf16 within 2e-2 or one bf16 unit of the output, whichever is
    larger."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).to(getattr(torch, dtype)).cuda()
        for shape in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D)))
    got = ops.flash_attention_cuda(q, k, v, kind=kind, window=window)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, kind=kind, window=window).float()
    diff = (got.float() - want).abs()
    if dtype == "bfloat16":
        mag = want.abs()
        ulp = torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(mag))
                                              - 7), torch.zeros_like(mag))
        tol = torch.clamp(ulp, min=ATOL["bfloat16"])
    else:
        tol = torch.full_like(want, ATOL["float32"])
    assert bool(torch.isfinite(got).all())
    assert bool((diff <= tol).all()), float(diff.max())


@pytest.mark.cuda
@pytest.mark.parametrize("S,T", [(3000, 3000), (2900, 3000)])
def test_mixtral_layout_on_card(S, T):
    """mixtral-8x22b's layer: 48 query heads over 8 KV heads of 128 (six
    a KV head), swa 4,096, at the real prefill length and ragged."""
    _hold_on_card(1, S, T, 48, 8, 128, "bfloat16", "swa", 4096, seed=S,
                  scale=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,window", KINDS)
@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("S,T,H,KV", [(100, 163, 4, 1), (77, 77, 6, 2),
                                      (130, 200, 3, 3)])
def test_ragged_rows_each_head_dim_on_card(kind, window, D, S, T, H, KV):
    """S no multiple of the 64-row tile, at every head dim, with paired
    and single heads per block."""
    _hold_on_card(1, S, T, H, KV, D, "bfloat16", kind, window, seed=S + D)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,window", KINDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 7])
@pytest.mark.parametrize("H,KV,D", [(4, 1, 256), (48, 8, 128)])
def test_short_prompts_on_card(kind, window, dtype, S, H, KV, D):
    _hold_on_card(1, S, S, H, KV, D, dtype, kind, window, seed=S)
