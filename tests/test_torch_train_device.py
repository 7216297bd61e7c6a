"""B3, B4 and B5 under autograd on the card (``kernels.autograd``): the
forward is the kernel, bit for bit as its wrapper gives it, and counts
one launch; the backward equals autograd through the plain version on
the same inputs and output gradients (the backward recomputes that very
version, so the two run the same kernels). At small shapes; the real
layers' shapes are held in ``chip_smoke.py``'s phase 17. These tests
need a card and skip elsewhere; this file imports no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.autograd import kernel_call  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.moe_dispatch import ops as md_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as rw_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _grads(fn, inputs, outs_grad):
    xs = [x.detach().requires_grad_(True) for x in inputs]
    outs = fn(*xs)
    outs = (outs,) if isinstance(outs, torch.Tensor) else outs
    pairs = [(o, g) for o, g in zip(outs, outs_grad) if g is not None]
    return outs, torch.autograd.grad([o for o, _ in pairs], xs,
                                     [g for _, g in pairs],
                                     allow_unused=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,window", [("full", 0), ("swa", 64),
                                         ("chunked", 96)])
def test_flash_attention_backward_is_the_plain_vjp(kind, window):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    B, S, HQ, HKV, D = 2, 256, 4, 2, 64
    q = torch.randn((B, S, HQ, D), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((B, S, HKV, D), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    go = torch.randn((B, S, HQ, D), generator=gen, device=dev).bfloat16()
    spec = L.AttnSpec(num_heads=HQ, num_kv_heads=HKV, head_dim=D, kind=kind,
                      window=window)

    def kern(q_, k_, v_):
        return fa_ops.flash_attention(q_, k_, v_, kind=kind, window=window)

    def plain(q_, k_, v_):
        return L._attend_blocked(q_, k_, v_, spec)

    fa_ops.launches = 0
    (out,), got = _grads(
        lambda *x: kernel_call(kern, plain, *x, name="flash_attention"),
        (q, k, v), (go,))
    assert fa_ops.launches == 1
    assert torch.equal(out, kern(q, k, v))
    _, want = _grads(plain, (q, k, v), (go,))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w)


@pytest.mark.cuda
def test_rwkv6_scan_backward_is_the_plain_vjp():
    dev = _card()
    rng = np.random.default_rng(2)
    B, H, S, D = 2, 4, 64, 64

    def n(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev)

    # r, k, v, w as the model hands them: [B,H,S,hd] views of [B,S,H,hd]
    r, k, v = (n((B, S, H, D), 0.2).transpose(1, 2) for _ in range(3))
    w = (0.5 * torch.sigmoid(n((B, S, H, D), 1.0)) + 0.4).transpose(1, 2)
    u, s0 = n((H, D), 0.1), n((B, H, D, D), 0.1)
    go, gs = n((B, H, S, D), 1.0), n((B, H, D, D), 1.0)
    rw_ops.launches = 0
    outs, got = _grads(lambda *x: kernel_call(rw_ops.rwkv6_scan,
                                              rwkv6_scan_ref, *x,
                                              name="rwkv6_scan"),
                       (r, k, v, w, u, s0), (go, gs))
    assert rw_ops.launches == 1
    for a, b in zip(outs, rw_ops.rwkv6_scan(r, k, v, w, u, s0)):
        assert torch.equal(a, b)
    _, want = _grads(rwkv6_scan_ref, (r, k, v, w, u, s0), (go, gs))
    for g, wt in zip(got, want):
        torch.testing.assert_close(g, wt)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [0, 2])
def test_moe_dispatch_slot_weight_backward_is_the_plain_vjp(groups):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(3)
    n, E, top_k, cap = 512, 8, 2, 128
    shape = (groups, n, E) if groups else (n, E)
    probs = torch.softmax(torch.randn(shape, generator=gen, device=dev), -1)
    gw = torch.randn(shape[:-2] + (E * cap,), generator=gen, device=dev)
    md_ops.launches = 0
    xs = probs.detach().requires_grad_(True)
    plan = MOE._kernel_plan(xs, top_k, cap)
    assert md_ops.launches == 1
    kern = md_ops.moe_dispatch_plan(probs, top_k=top_k, capacity=cap)
    for f, t in kern.items():
        assert torch.equal(plan[f], t), f
    (got,) = torch.autograd.grad(plan["slot_weight"], xs, gw)
    ys = probs.detach().requires_grad_(True)
    (want,) = torch.autograd.grad(
        MOE.plan_dispatch(ys, top_k, cap)["slot_weight"], ys, gw)
    torch.testing.assert_close(got, want)
    assert got.abs().max() > 0
