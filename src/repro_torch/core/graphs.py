"""Counted CUDA graphs: the one capture rule of the port's graphed
runners (``core.sweep``'s chunk and group runners, ``core.distributed``'s
rounds).

A kernel's wrapper counts its launches on the host (its ops module's
``launches``), so the kernels a graph replay launches pass no wrapper.
:class:`CountedGraph` records what the capture counted and adds it on
each replay; the warm-up before the capture and the capture itself
count nothing.
"""

from __future__ import annotations

import torch


def counted_ops() -> list:
    """The ops modules of the kernels a graphed step may launch."""
    from repro_torch.kernels.dep_wavefront import ops as dw_ops
    from repro_torch.kernels.lock_grant import ops as lg_ops

    return [lg_ops, dw_ops]


class CountedGraph:
    """``body()`` captured as one CUDA graph on ``device``, after
    ``warm()`` has run once on a side stream (a kernel's first launch,
    such as its ``cudaFuncSetAttribute``, may not happen under capture;
    ``warm`` works on scratch copies of what ``body`` updates)."""

    def __init__(self, warm, body, device):
        ops = counted_ops()
        before = [m.launches for m in ops]
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm()
        cur.wait_stream(side)
        warmed = [m.launches for m in ops]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            body()
        self.per_replay = [(m, m.launches - w) for m, w in zip(ops, warmed)]
        for m, b in zip(ops, before):
            m.launches = b

    def replay(self) -> None:
        self.graph.replay()
        for m, n in self.per_replay:
            m.launches += n

    def reset(self) -> None:
        """Free the graph and its memory pool."""
        self.graph.reset()
