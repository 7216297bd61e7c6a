"""The port's rwkv6_scan (kernel B5) against the JAX package: its plain
version against the JAX oracle and the Pallas kernel in interpret mode,
the wrapper's CPU path and its argument checks (also of the private
entry points to the earlier design and to the kernel's sweep tiles), and
(on a card) the CUDA kernel and its earlier design against the plain
version, at the new kernel's chunk edges. The JAX package is imported
by the tests that compare with it, so the card's tests run where JAX is
not installed.

Tolerance: tests/test_kernels.py's absolute 2e-4 at its input scales
(r, k, v and the state about 0.1-0.2, decays 0.4-0.9, u 0.1). Both
sides run the recurrence in float32 and differ only in the order of
the sums; the kernel's bonus term is reassociated (r . (u k) v).
"""

import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref  # noqa: E402

ATOL = 2e-4


def _inputs(B, H, S, D, seed):
    """r, k, v, w [B,H,S,D], u [H,D], state0 [B,H,D,D] as numpy f32, at
    tests/test_kernels.py's scales."""
    rng = np.random.default_rng(seed)

    def n(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    r, k, v = (n((B, H, S, D), 0.2) for _ in range(3))
    w = (0.5 / (1 + np.exp(-n((B, H, S, D), 1.0))) + 0.4).astype(np.float32)
    return r, k, v, w, n((H, D), 0.1), n((B, H, D, D), 0.1)


def _t(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.fixture(scope="module")
def jax_scan():
    """(the JAX wrapper, the JAX oracle)."""
    jax = pytest.importorskip("jax")
    ops_j = pytest.importorskip("repro.kernels.rwkv6_scan.ops")
    ref_j = pytest.importorskip("repro.kernels.rwkv6_scan.ref")
    return ops_j.rwkv6_scan, jax.jit(ref_j.rwkv6_scan_ref)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("S,chunk", [(64, 16), (128, 128), (96, 32)])
def test_plain_version_matches_pallas_interpret_and_oracle(jax_scan, S, chunk,
                                                           D):
    jax_wrapper, jax_ref = jax_scan
    args = _inputs(2, 3, S, D, seed=S + D)
    o, st = rwkv6_scan_ref(*_t(args))
    assert o.shape == (2, 3, S, D) and st.shape == (2, 3, D, D)
    assert o.dtype == st.dtype == torch.float32
    o_ref, st_ref = jax_ref(*args)
    _close(o, o_ref)
    _close(st, st_ref)
    o_pl, st_pl = jax_wrapper(*args, chunk=chunk, interpret=True)
    _close(o, o_pl)
    _close(st, st_pl)


@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("S", [1, 7, 100])
def test_plain_version_ragged_matches_oracle(jax_scan, S, D):
    """Ragged prompt lengths, down to a decode step's S = 1, against the
    oracle."""
    args = _inputs(1, 4, S, D, seed=3 * S + D)
    o, st = rwkv6_scan_ref(*_t(args))
    o_ref, st_ref = jax_scan[1](*args)
    _close(o, o_ref)
    _close(st, st_ref)


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    r, k, v, w, u, s0 = _t(_inputs(2, 3, 9, 16, seed=1))
    before = ops.launches
    o, st = ops.rwkv6_scan(r, k, v, w, u, s0)
    assert ops.launches == before
    want_o, want_st = rwkv6_scan_ref(r, k, v, w, u, s0)
    assert torch.equal(o, want_o) and torch.equal(st, want_st)


def test_state_out_may_be_the_initial_state():
    """The decode cache's call: the final state written over state0."""
    r, k, v, w, u, s0 = _t(_inputs(2, 3, 5, 16, seed=2))
    want_o, want_st = rwkv6_scan_ref(r, k, v, w, u, s0.clone())
    o, st = ops.rwkv6_scan(r, k, v, w, u, s0, state_out=s0)
    assert st is s0
    assert torch.equal(o, want_o) and torch.equal(s0, want_st)


def test_strided_views_are_taken():
    """The model's call: [B,H,S,hd] views of [B,S,H,hd] tensors."""
    args = _t(_inputs(2, 3, 6, 16, seed=4))
    views = [a.transpose(1, 2).contiguous().transpose(1, 2)
             for a in args[:4]]
    o, st = ops.rwkv6_scan(*views, *args[4:])
    want_o, want_st = rwkv6_scan_ref(*args)
    assert torch.equal(o, want_o) and torch.equal(st, want_st)


def _bad(case):
    r, k, v, w, u, s0 = _t(_inputs(2, 3, 8, 16, seed=5))
    kw = {}
    if case == "bf16":
        r = r.bfloat16()
    elif case == "k shape":
        k = k[:, :, :4]
    elif case == "u shape":
        u = u[:2]
    elif case == "state shape":
        s0 = s0[:1]
    elif case == "state_out dtype":
        kw["state_out"] = s0.double()
    elif case == "head_dim":
        r, k, v, w = (a[..., :12] for a in (r, k, v, w))
        u, s0 = u[:, :12], s0[:, :, :12, :12]
    elif case == "empty":
        r, k, v, w = (a[:, :, :0] for a in (r, k, v, w))
    elif case == "last dim strided":
        r = r.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "unaligned":
        r = torch.zeros(2 * 3 * 8 * 16 + 1)[1:].reshape(2, 3, 8, 16)
    elif case == "state not contiguous":
        s0 = s0.transpose(2, 3)
    return (r, k, v, w, u, s0), kw


@pytest.mark.parametrize("case", [
    "bf16", "k shape", "u shape", "state shape", "state_out dtype",
    "head_dim", "empty", "last dim strided", "unaligned",
    "state not contiguous"])
def test_bad_arguments_raise(case):
    args, kw = _bad(case)
    with pytest.raises((TypeError, ValueError)):
        ops.rwkv6_scan(*args, **kw)


def test_kernel_launch_rejects_cpu_tensors():
    args = _t(_inputs(1, 2, 4, 16, seed=6))
    with pytest.raises(ValueError, match="CUDA"):
        ops.rwkv6_scan_cuda(*args)


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
@pytest.mark.parametrize("D", ops.HEAD_DIMS)
@pytest.mark.parametrize("B,H,S", [(1, 1, 1), (2, 3, 7), (1, 32, 65),
                                   (8, 32, 1), (2, 3, 96), (1, 4, 1000)])
def test_rwkv6_scan_kernel_matches_plain_on_card(B, H, S, D):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = _t(_inputs(B, H, S, D, seed=B + H + S + D), "cuda")
    # the model's layout: [B,H,S,hd] views of [B,S,H,hd] tensors
    views = [a.transpose(1, 2).contiguous().transpose(1, 2)
             for a in args[:4]]
    o, st = ops.rwkv6_scan_cuda(*views, *args[4:])
    torch.cuda.synchronize()
    want_o, want_st = rwkv6_scan_ref(*args)
    torch.testing.assert_close(o, want_o, rtol=0, atol=ATOL)
    torch.testing.assert_close(st, want_st, rtol=0, atol=ATOL)
    s0 = args[5].clone()
    o2, st2 = ops.rwkv6_scan_cuda(*args[:5], s0, state_out=s0)
    torch.cuda.synchronize()
    assert st2 is s0
    torch.testing.assert_close(o2, want_o, rtol=0, atol=ATOL)
    torch.testing.assert_close(s0, want_st, rtol=0, atol=ATOL)


# the private entry points: the earlier design (timed beside the kernel)
# and the kernel at a chosen built instance (the tile sweep)
PRIVATE = {
    "earlier design": ops._rwkv6_scan_chain,
    "sweep tile": lambda *a, **kw: ops._rwkv6_scan_tile(
        *a, tile=(8, 1, 16), chunk=ops.CHUNK, **kw),
}


@pytest.mark.parametrize("case", [
    "bf16", "k shape", "u shape", "state shape", "state_out dtype",
    "head_dim", "empty", "last dim strided", "unaligned",
    "state not contiguous"])
@pytest.mark.parametrize("entry", sorted(PRIVATE))
def test_private_entry_points_raise_like_the_kernel(entry, case):
    """The same ``_check`` as ``rwkv6_scan_cuda``: the same error types on
    the same bad arguments, before anything is built or launched."""
    args, kw = _bad(case)
    with pytest.raises((TypeError, ValueError)) as got:
        PRIVATE[entry](*args, **kw)
    with pytest.raises((TypeError, ValueError)) as want:
        ops.rwkv6_scan_cuda(*args, **kw)
    assert got.type is want.type


@pytest.mark.parametrize("entry", sorted(PRIVATE))
def test_private_entry_points_reject_cpu_tensors_and_do_not_count(entry):
    args = _t(_inputs(1, 2, 4, 16, seed=6))
    before = ops.launches
    with pytest.raises(ValueError, match="CUDA"):
        PRIVATE[entry](*args)
    assert ops.launches == before


def test_the_wrapper_names_only_instances_the_kernel_builds():
    """Every (hd, tile, chunk) the wrapper and the sweep ask for is one of
    the instances rwkv6_scan.cu builds (RWKV6_TILES), so a launch on the
    card finds its instance."""
    src = ops.SOURCES[0].read_text()
    block = re.search(r"#define RWKV6_TILES\(X\)(.*?)\n\n", src, re.S)
    built = {tuple(map(int, m)) for m in
             re.findall(r"X\((\d+), (\d+), (\d+), (\d+), (\d+)\)",
                        block.group(1))}
    want = {(D, *ops.TILE, ops.CHUNK) for D in ops.HEAD_DIMS}
    want |= {(D, *(ops.DECODE_TILE if D >= 32 else ops.TILE),
              ops.DECODE_CHUNK) for D in ops.HEAD_DIMS}
    want |= {(64, *tile, chunk) for tile in ops.SWEEP_TILES
             for chunk in (ops.DECODE_CHUNK, ops.CHUNK)}
    want |= {(64, *ops.TILE, chunk) for chunk in ops.SWEEP_CHUNKS}
    assert want <= built, sorted(want - built)


# S at the new kernel's chunk edges: a decode chunk (1, T - 1, T of its
# 4 steps) and a prefill one (T + 1 of the decode chunk, T - 1, T, T + 1
# and 2T + 1 of the 32-step chunk)
EDGES = (1, 3, 4, 5, 31, 32, 33, 65)


@pytest.mark.cuda
@pytest.mark.parametrize("S", EDGES)
@pytest.mark.parametrize("B,H", [(1, 1), (8, 32)])
@pytest.mark.parametrize("D", ops.HEAD_DIMS)
@pytest.mark.parametrize("design", ["kernel", "earlier design"])
def test_both_designs_match_plain_at_chunk_edges_on_card(design, D, B, H, S):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fn = {"kernel": ops.rwkv6_scan_cuda,
          "earlier design": ops._rwkv6_scan_chain}[design]
    args = _t(_inputs(B, H, S, D, seed=B * H + S + D), "cuda")
    want_o, want_st = rwkv6_scan_ref(*args)
    # the model's layout: [B,H,S,hd] views of [B,S,H,hd] tensors
    views = [a.transpose(1, 2).contiguous().transpose(1, 2)
             for a in args[:4]]
    before = ops.launches
    o, st = fn(*views, *args[4:])
    s0 = args[5].clone()
    o2, st2 = fn(*args[:5], s0, state_out=s0)
    torch.cuda.synchronize()
    assert ops.launches == before + (2 if design == "kernel" else 0)
    assert st2 is s0
    for got, want in ((o, want_o), (st, want_st), (o2, want_o),
                      (s0, want_st)):
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
