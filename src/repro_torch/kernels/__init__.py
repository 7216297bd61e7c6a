"""Hand-written CUDA kernels for Hopper, one directory each.

Each kernel directory has:
  csrc/*.cu — the CUDA C++ source, built at first use by ``_build``
  ops.py    — the wrapper: checks, allocation, launch, torch-side glue
  ref.py    — the plain PyTorch version, used for CPU tensors and held
              against the kernel on the card

  lock_grant    — segmented FIFO lock grant (ORTHRUS's grant pass)
  dep_wavefront — segmented dependency-miss counts (the batch engine's
                  readiness scan: dgcc, quecc, scheduled)
  flash_attention — online-softmax attention forward, causal / sliding
                  window / chunked (the models' prefill attention; bf16
                  on the tensor cores, f32 on the CUDA cores)
  rwkv6_scan    — the RWKV6 WKV recurrence over time (rwkv6's time mix,
                  in prefill and in every decode step)
  moe_dispatch  — the planned MoE dispatch's whole plan: top-k, each
                  routed entry's position within its expert, the
                  dispatch table and the load (mixtral's layers, in
                  prefill and in every decode step)

A wrapper launches its kernel for a CUDA tensor and raises if it cannot;
it runs the plain version only for a tensor that lies on the CPU. It
launches under its tensors' device (``device_guard``), so tensors on a
card that is not the current one work too. It refuses a DTensor
(``reject_dtensors``): a DTensor reaches a kernel through
``sharding.ctx.local_call``, as its local shard.
"""

from __future__ import annotations

import contextlib

import torch

KERNEL_IMPLS = ("auto", "jnp", "pallas")

_SAME_DEVICE = contextlib.nullcontext()


def device_guard(dev: torch.device):
    """The context a wrapper launches its kernel in: ``dev`` is the
    current CUDA device inside it (the C entry points launch on the
    current device, and B4 sets its shared-memory limit per device). No
    switch where ``dev`` already is current: B1 and B2 launch once per
    simulator step."""
    if dev.index == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(dev)


def reject_dtensors(op: str, **tensors) -> None:
    """Raise a TypeError where one of ``tensors`` is a DTensor. Its
    ``data_ptr`` is its local shard's, so a kernel launched on one reads
    the wrong extents (an illegal address on the card), and its plain
    version computes on the whole tensor what the card's kernel would
    not."""
    from torch.distributed.tensor import DTensor

    for name, t in tensors.items():
        if isinstance(t, DTensor):
            raise TypeError(f"{op}: {name} is a DTensor; a kernel takes "
                            f"plain tensors (call it on the local shards "
                            f"through sharding.ctx.local_call)")


def use_kernel(kernel_impl: str, device: torch.device | str) -> bool:
    """Whether the engine or the model goes through a kernel's wrapper
    for tensors on ``device`` (``EngineConfig.kernel_impl``; the
    ``kernel_impl`` of ``prefill``, ``decode_step`` and ``ServingEngine``).

    "jnp" never does: the caller runs its plain PyTorch formulation.
    "pallas" always does: the wrapper launches the CUDA kernel for a
    CUDA tensor and runs its plain version for a CPU tensor. "auto"
    does where the tensors are on a CUDA device. There is no
    environment override, and no fallback when a build or launch fails.
    """
    if kernel_impl not in KERNEL_IMPLS:
        raise ValueError(f"kernel_impl {kernel_impl!r} not in {KERNEL_IMPLS}")
    if kernel_impl == "auto":
        return torch.device(device).type == "cuda"
    return kernel_impl == "pallas"
