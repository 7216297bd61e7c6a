"""Roofline analysis of a dry-run cell, priced at the H100's peaks (the
port of ``repro.launch.roofline``; no hardware is touched).

The JAX package parses the compiled HLO. The port has no HLO: it counts
what one rank of the cell executes, under a dispatch mode
(``DeviceCounter``) that sees each DTensor op's local computation on the
rank's shards (it returns ``NotImplemented`` for DTensor ops, so DTensor
runs and its local ops and collectives come back through the mode):

  * FLOPs per device with ``torch.utils.flop_counter.FlopCounterMode``'s
    formulas (matmuls, attention, convolutions), the remat recompute
    included, since it executes;
  * collective wire bytes per device, over the c10d functional
    collectives DTensor issues, by the reference's ring formulas per op
    kind (``collective_wire_bytes``);
  * HBM traffic from the per-device bytes of the params, optimizer state
    and batch (arguments) and of the outputs, by the reference's
    formulas: train 3 x params (forward, backward, update) + 2 x the rest
    of the arguments (read and write) + outputs; serve arguments +
    outputs. XLA's temporaries have no counterpart here: the traffic has
    no temp term.

Roofline terms (seconds, per step):
  compute    = flops_per_device / PEAK_FLOPS
  memory     = mem_traffic_per_device / HBM_BW
  collective = sum over collectives of wire bytes / the link's rate
               (NVLink within a group of at most 8 ranks, one node; the
               inter-node link beyond)
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

# H100 SXM5 dense BF16 tensor-core peak (NVIDIA H100 datasheet, 1,979
# TFLOP/s with sparsity); the rate PERF.md's kernel bounds use
PEAK_FLOPS = 989e12
# H100 SXM5 HBM3 bandwidth (NVIDIA H100 datasheet)
HBM_BW = 3.35e12
# fourth-generation NVLink: 900 GB/s a GPU in both directions together
# (NVIDIA H100 datasheet), 450e9 each way; within one 8-GPU node
NVLINK_BW = 450e9
# one 400 Gb/s NDR InfiniBand adapter a GPU (the DGX H100's eight
# ConnectX-7 ports, NVIDIA DGX H100 user guide): 50e9 each way, between
# nodes
INTERNODE_BW = 50e9
NODE_RANKS = 8

def _group_size(group_name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group_name).size()


def _functional_collectives():
    """{c10d functional op: (kind, how to read its group's size)}."""
    c = torch.ops._c10d_functional
    return {
        c.all_gather_into_tensor.default: ("all-gather", 1),
        c.reduce_scatter_tensor.default: ("reduce-scatter", 2),
        c.all_reduce.default: ("all-reduce", None),
        c.all_to_all_single.default: ("all-to-all", None),
    }


def collective_wire_bytes(kind: str, size: int, g: int) -> int:
    """Per-participating-device wire bytes (ring algorithms); ``size`` is
    the op's output bytes on this device, as the reference reads it from
    the HLO result shape."""
    if g <= 1:
        return 0
    if kind == "all-gather":
        return int(size * (g - 1) / g)
    if kind == "all-reduce":
        return int(2 * size * (g - 1) / g)
    if kind == "reduce-scatter":
        return int(size * (g - 1))  # size = per-device output
    if kind == "all-to-all":
        return int(size * (g - 1) / g)
    if kind == "collective-permute":
        return size
    return 0


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class DeviceCounter(TorchDispatchMode):
    """Counts one rank's FLOPs and collective bytes (the module's
    docstring). ``flops``, ``collective_bytes``, ``collective_seconds``,
    ``collective_detail`` (bytes by kind), ``collective_instructions``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode

        self.counter = FlopCounterMode(display=False)
        self.collectives = _functional_collectives()
        self.collective_bytes = 0.0
        self.collective_seconds = 0.0
        self.collective_detail: dict[str, float] = {}
        self.collective_instructions = 0

    @property
    def flops(self) -> int:
        return self.counter.get_total_flops()

    def counts(self) -> dict:
        """The numbers so far: flops, collective bytes, seconds,
        instructions, and bytes by kind."""
        return {"flops": float(self.flops),
                "collective_bytes": self.collective_bytes,
                "collective_seconds": self.collective_seconds,
                "collective_instructions": self.collective_instructions,
                **{f"detail:{k}": v
                   for k, v in self.collective_detail.items()}}

    def add(self, delta: dict, times: float = 1.0) -> None:
        """Add ``times`` x ``delta`` (a ``counts`` difference)."""
        self.counter.flop_counts["Global"][torch.ops.aten.mm] += int(
            times * delta.get("flops", 0.0))
        self.collective_bytes += times * delta.get("collective_bytes", 0.0)
        self.collective_seconds += times * delta.get("collective_seconds",
                                                     0.0)
        self.collective_instructions += int(
            times * delta.get("collective_instructions", 0))
        for k, v in delta.items():
            if k.startswith("detail:"):
                kind = k[len("detail:"):]
                self.collective_detail[kind] = (
                    self.collective_detail.get(kind, 0.0) + times * v)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor run: its local ops return
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out  # DTensor's shape propagation, not the rank's work
        packet = getattr(func, "_overloadpacket", None)
        if packet in self.counter.flop_registry:
            self.counter._count_flops(packet, out, args, kwargs)
        elif func in self.collectives:
            kind, at = self.collectives[func]
            g = int(args[at]) if at is not None else _group_size(args[-1])
            b = collective_wire_bytes(kind, _nbytes(out), g)
            self.collective_bytes += b
            self.collective_seconds += b / (NVLINK_BW if g <= NODE_RANKS
                                            else INTERNODE_BW)
            self.collective_detail[kind] = (
                self.collective_detail.get(kind, 0.0) + b)
            self.collective_instructions += 1
        return out


def over_repeats(trace, repeats: int) -> dict:
    """One cell's counts (``DeviceCounter.counts`` and byte totals, a
    dict of numbers) for a model of ``repeats`` pattern repeats, from
    ``trace(r)``, the counts of the same model cut to r repeats. Every
    repeat does the same work on the same shapes, so a deep model is
    traced at 1 and 2 repeats and counted as the first plus ``repeats``
    - 1 times the difference, as the JAX package's HLO parser multiplies
    a scan body by its trip count."""
    if repeats <= 2:
        return trace(repeats)
    one, two = trace(1), trace(2)
    return {k: one.get(k, 0) + (repeats - 1) * (two[k] - one.get(k, 0))
            for k in two}


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree``."""
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree as pytree

    total = 0
    for t in pytree.tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += _nbytes(t)
    return total


def analyze_counts(counter: DeviceCounter, meta: dict, *, chips: int,
                   param_bytes: int, arg_bytes: int, out_bytes: int) -> dict:
    """The reference's ``analyze_compiled`` keys from one rank's counts
    and byte totals."""
    flops_dev = float(counter.flops)
    if meta["kind"] == "train":
        mem_traffic = (3 * param_bytes + 2 * max(arg_bytes - param_bytes, 0)
                       + out_bytes)
    else:
        mem_traffic = arg_bytes + out_bytes
    # analytic model flops (global): 6ND train / 2ND forward-only
    tokens = meta["global_batch"] * (
        meta["seq_len"] if meta["kind"] != "decode" else 1)
    model_flops = (6 if meta["kind"] == "train" else 2) * \
        meta["active_params"] * tokens
    compute_t = flops_dev / PEAK_FLOPS
    memory_t = mem_traffic / HBM_BW
    coll_t = counter.collective_seconds
    bound = max(compute_t, memory_t, coll_t)
    bottleneck = max(("compute", compute_t), ("memory", memory_t),
                     ("collective", coll_t), key=lambda kv: kv[1])[0]
    return dict(
        **meta,
        chips=chips,
        hbm_bytes_per_device=arg_bytes + out_bytes,
        arg_bytes=arg_bytes,
        param_bytes=param_bytes,
        out_bytes=out_bytes,
        total_flops=flops_dev * chips,
        flops_per_device=flops_dev,
        model_flops=model_flops,
        useful_flops_ratio=(model_flops / (flops_dev * chips)
                            if flops_dev else 0.0),
        mem_traffic_per_device=mem_traffic,
        collective_bytes=counter.collective_bytes * chips,
        collective_bytes_per_device=counter.collective_bytes,
        collective_detail=counter.collective_detail,
        collective_instructions=counter.collective_instructions,
        compute_seconds=compute_t,
        memory_seconds=memory_t,
        collective_seconds=coll_t,
        bottleneck=bottleneck,
        step_seconds_lower_bound=bound,
        roofline_fraction=((model_flops / chips / PEAK_FLOPS) / bound
                           if bound > 0 else 0.0),
    )


def roofline_report(analyses: list[dict]) -> str:
    hdr = (
        f"{'arch':26s} {'shape':12s} {'mesh':5s} {'GiB/dev':>8s} "
        f"{'compute_s':>10s} {'memory_s':>10s} {'coll_s':>10s} "
        f"{'bound':>10s} {'MFU-frac':>9s} {'useful':>7s}"
    )
    lines = [hdr, "-" * len(hdr)]
    for a in analyses:
        lines.append(
            f"{a['arch']:26s} {a['shape']:12s} {a.get('mesh', '?'):5s} "
            f"{a['hbm_bytes_per_device'] / 2**30:8.2f} "
            f"{a['compute_seconds']:10.4f} {a['memory_seconds']:10.4f} "
            f"{a['collective_seconds']:10.4f} {a['bottleneck']:>10s} "
            f"{a['roofline_fraction']:9.3f} {a['useful_flops_ratio']:7.2f}"
        )
    return "\n".join(lines)
