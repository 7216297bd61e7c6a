"""Every kernel wrapper of the port launches under its tensors' device.

The C entry points launch on the calling thread's current CUDA device
(and B4 sets its dynamic shared-memory limit per device), so each
wrapper makes its tensors' device current around the launch
(``repro_torch.kernels.device_guard``), and switches nothing where that
device already is current.

On the CPU: the tensors are fake CUDA tensors (``FakeTensorMode``), each
wrapper's library is a stub that records the current device at the
moment of each launch, and ``torch.cuda``'s device calls are stand-ins
that keep a current-device variable. On a card with two devices (marked
``cuda``): each kernel launched on device 1 while device 0 is current,
against its plain version. It skips with fewer than two devices.
"""

import warnings

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.kernels.dep_wavefront import ops as dw_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.lock_grant import ops as lg_ops  # noqa: E402
from repro_torch.kernels.moe_dispatch import ops as md_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as rw_ops  # noqa: E402


class StubLibrary:
    """A kernel library whose every entry point records (entry, the
    current device) and returns 0, as a launch that succeeded."""

    def __init__(self, state):
        self.state = state

    def __getattr__(self, name):
        def entry(*args):
            self.state["calls"].append((name, self.state["current"]))
            return 0
        return entry


class FakeCuda:
    """Stand-ins for torch.cuda's device calls around a current-device
    variable; ``switches`` counts entries into ``torch.cuda.device``."""

    def __init__(self, state):
        self.state = state

    def current_device(self):
        return self.state["current"]

    def device(self, dev):
        state = self.state

        class Switch:
            def __enter__(self):
                state["switches"] += 1
                self.prev = state["current"]
                state["current"] = torch.device(dev).index

            def __exit__(self, *exc):
                state["current"] = self.prev
                return False

        return Switch()

    def current_stream(self, dev=None):
        class Stream:
            cuda_stream = 0
        return Stream()


@pytest.fixture
def fake_cuda(monkeypatch):
    """(state, FakeTensorMode): stub libraries in all five wrappers,
    torch.cuda's device calls on ``state["current"]`` (device 0)."""
    state = {"current": 0, "calls": [], "switches": 0}
    fake = FakeCuda(state)
    for name in ("current_device", "device", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, getattr(fake, name))
    stub = StubLibrary(state)
    for mod in (lg_ops, dw_ops, md_ops, rw_ops, fa_ops):
        monkeypatch.setattr(mod, "_library", lambda: stub)
    monkeypatch.setattr(fa_ops, "_simt_library", lambda: stub)
    with warnings.catch_warnings():
        # a fake tensor's data_ptr() is 0, with a warning; the stub never
        # reads it
        warnings.simplefilter("ignore", UserWarning)
        with FakeTensorMode() as mode:
            yield state, mode


def _launch_lock_grant(dev):
    i32 = dict(dtype=torch.int32, device=dev)
    lg_ops.lock_grant_cuda(torch.zeros(8, **i32), torch.zeros(8, **i32),
                           torch.zeros(8, dtype=torch.bool, device=dev),
                           torch.zeros(8, **i32))


def _launch_lock_grant_step(dev):
    i32 = dict(dtype=torch.int32, device=dev)
    mask = dict(dtype=torch.bool, device=dev)
    lg_ops.lock_grant_step_cuda(
        torch.zeros(4, 3, **i32), torch.zeros(4, 3, **i32),
        torch.zeros(4, 3, **mask), torch.zeros(4, 3, **mask),
        torch.zeros(4, 3, **i32), torch.zeros(9, **i32),
        torch.zeros(9, **i32), 8)


def _launch_dep_wavefront(dev):
    dw_ops.dep_wavefront_cuda(torch.zeros(8, dtype=torch.int32, device=dev),
                              torch.zeros(8, dtype=torch.bool, device=dev))


def _launch_dep_wavefront_rows(dev):
    dw_ops.dep_wavefront_rows_cuda(
        torch.zeros(8, dtype=torch.int32, device=dev),
        torch.zeros(8, 2, dtype=torch.int32, device=dev),
        torch.zeros(5, dtype=torch.bool, device=dev))


def _launch_moe_dispatch(dev):
    md_ops.dispatch_positions_cuda(
        torch.zeros(8, dtype=torch.int32, device=dev), 4, 2)


def _launch_moe_dispatch_plan(dev):
    md_ops.moe_dispatch_plan_cuda(
        torch.zeros(8, 4, dtype=torch.float32, device=dev), top_k=2,
        capacity=4)


def _launch_rwkv6_scan(dev):
    f32 = dict(dtype=torch.float32, device=dev)
    r, k, v, w = (torch.zeros(1, 2, 3, 16, **f32) for _ in range(4))
    rw_ops.rwkv6_scan_cuda(r, k, v, w, torch.zeros(2, 16, **f32),
                           torch.zeros(1, 2, 16, 16, **f32))


def _launch_flash_attention(dtype):
    def launch(dev):
        q = torch.zeros(1, 8, 2, 32, dtype=dtype, device=dev)
        k = torch.zeros(1, 8, 1, 32, dtype=dtype, device=dev)
        fa_ops.flash_attention_cuda(q, k, torch.zeros_like(k), kind="swa",
                                    window=4)
    return launch


# (wrapper module, launch on a device, the C entry it must reach)
WRAPPERS = {
    "lock_grant": (lg_ops, _launch_lock_grant, "lock_grant_launch"),
    "lock_grant_step": (lg_ops, _launch_lock_grant_step,
                        "lock_grant_step_launch"),
    "dep_wavefront": (dw_ops, _launch_dep_wavefront, "dep_wavefront_launch"),
    "dep_wavefront_rows": (dw_ops, _launch_dep_wavefront_rows,
                           "dep_wavefront_rows_launch"),
    "moe_dispatch": (md_ops, _launch_moe_dispatch, "moe_dispatch_launch"),
    "moe_dispatch_plan": (md_ops, _launch_moe_dispatch_plan,
                          "moe_dispatch_plan_launch"),
    "rwkv6_scan": (rw_ops, _launch_rwkv6_scan, "rwkv6_scan_launch"),
    "flash_attention_bf16": (fa_ops, _launch_flash_attention(torch.bfloat16),
                             "flash_attention_tc_launch"),
    "flash_attention_f32": (fa_ops, _launch_flash_attention(torch.float32),
                            "flash_attention_launch"),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_launch_runs_under_the_tensors_device(fake_cuda, name):
    """Tensors on cuda:1, cuda:0 current: the launch sees device 1, and
    device 0 is current again after it."""
    state, _mode = fake_cuda
    mod, launch, entry = WRAPPERS[name]
    before = mod.launches
    launch(torch.device("cuda", 1))
    assert state["calls"] == [(entry, 1)]
    assert state["switches"] == 1
    assert state["current"] == 0
    assert mod.launches == before + 1


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_launch_on_the_current_device_switches_nothing(fake_cuda, name):
    state, _mode = fake_cuda
    mod, launch, entry = WRAPPERS[name]
    launch(torch.device("cuda", 0))
    assert state["calls"] == [(entry, 0)]
    assert state["switches"] == 0


def _card_cases(dev):
    """(name, kernel call, plain call) of each kernel on ``dev``."""
    from repro_torch.kernels.dep_wavefront.ref import (
        dep_wavefront_ref,
        dep_wavefront_rows_ref,
    )
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.lock_grant.ref import (
        lock_grant_ref,
        lock_grant_step_ref,
    )
    from repro_torch.kernels.moe_dispatch.ref import (
        dispatch_slots_ref,
        moe_dispatch_plan_ref,
    )
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

    g = torch.Generator().manual_seed(0)
    keys = torch.sort(torch.randint(0, 50, (300,), generator=g))[0].to(
        torch.int32).to(dev)
    kind = torch.randint(0, 3, (300,), generator=g).to(torch.int32).to(dev)
    wh_free = (torch.rand(300, generator=g) < 0.7).to(dev)
    rc = torch.randint(0, 3, (300,), generator=g).to(torch.int32).to(dev)
    ok = (torch.rand(300, generator=g) < 0.5).to(dev)
    experts = torch.sort(torch.randint(-1, 8, (300,), generator=g))[0].to(
        torch.int32).to(dev)
    probs = torch.softmax(torch.randn(300, 8, generator=g), -1).to(dev)
    rwkv = [(torch.randn(1, 2, 9, 16, generator=g) * 0.2).to(dev)
            for _ in range(3)]
    w = torch.rand(1, 2, 9, 16, generator=g).to(dev) * 0.5 + 0.4
    u = (torch.randn(2, 16, generator=g) * 0.2).to(dev)
    s0 = torch.zeros(1, 2, 16, 16, device=dev)
    qkv = [(torch.randn(1, 100, h, 64, generator=g) * 0.5).to(
        torch.bfloat16).to(dev) for h in (4, 2, 2)]
    step = [torch.randint(0, 12, (30, 10), generator=g).to(torch.int32),
            torch.randint(0, 2, (30, 10), generator=g).to(torch.int32),
            torch.rand(30, 10, generator=g) < 0.5,
            torch.rand(30, 10, generator=g) < 0.1,
            torch.randint(-3, 40, (30, 10), generator=g).to(torch.int32),
            torch.randint(-1, 30, (11,), generator=g).to(torch.int32),
            torch.randint(0, 2, (11,), generator=g).to(torch.int32)]
    step = [t.to(dev) for t in step]
    preds = torch.randint(-1, 20, (60, 3), generator=g).to(torch.int32).to(
        dev)
    units = torch.randint(0, 20, (60,), generator=g).to(torch.int32).to(dev)
    return [
        ("lock_grant", lambda: lg_ops.lock_grant_cuda(keys, kind, wh_free, rc),
         lambda: lock_grant_ref(keys, kind, wh_free, rc)),
        ("lock_grant_step", lambda: lg_ops.lock_grant_step_cuda(*step, 10),
         lambda: lock_grant_step_ref(*step, 10)),
        ("dep_wavefront", lambda: dw_ops.dep_wavefront_cuda(keys, ok),
         lambda: dep_wavefront_ref(keys, ok)),
        ("dep_wavefront_rows", lambda: dw_ops.dep_wavefront_rows_cuda(
            units, preds, ok[:21]),
         lambda: dep_wavefront_rows_ref(units, preds, ok[:21])),
        ("moe_dispatch", lambda: md_ops.dispatch_positions_cuda(experts, 16, 8),
         lambda: dispatch_slots_ref(experts, 16, 8)),
        ("moe_dispatch_plan", lambda: tuple(md_ops.moe_dispatch_plan_cuda(
            probs, top_k=2, capacity=64).values()),
         lambda: tuple(moe_dispatch_plan_ref(probs, 2, 64).values())),
        ("rwkv6_scan", lambda: rw_ops.rwkv6_scan_cuda(*rwkv, w, u, s0),
         lambda: rwkv6_scan_ref(*rwkv, w, u, s0)),
        ("flash_attention", lambda: fa_ops.flash_attention_cuda(
            *qkv, kind="swa", window=32),
         lambda: flash_attention_ref(*qkv, kind="swa", window=32)),
    ]


@pytest.mark.cuda
def test_kernels_launch_on_a_device_that_is_not_current():
    """Each kernel on cuda:1 while cuda:0 is current, against its plain
    version (integers exactly, floats within the kernels' tolerances)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 1)
    for name, kernel, plain in _card_cases(dev):
        got, want = kernel(), plain()
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == 0, name
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.device == dev, name
            if g.is_floating_point():
                tol = 2e-2 if g.dtype == torch.bfloat16 else 2e-4
                torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                           atol=tol)
            else:
                assert torch.equal(g, w), name
