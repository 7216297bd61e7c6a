"""The traced window: ``torch.profiler`` over whole calls of the cell, and
what the per-layer readers take from its trace.

Device activities (kernels, copies, memsets; CUPTI reports each kernel
node of a CUDA-graph replay as its own kernel) are read from the
profiler's raw events, which does not build the event tree. The window
is the harness's own annotation around the calls, in the trace's clock.
"""

from __future__ import annotations

import dataclasses

WINDOW = "simbench.window"


@dataclasses.dataclass
class Trace:
    window_ns: tuple[int, int]
    device: list[tuple[str, int, int]]  # (name, start ns, end ns)
    host: list[tuple[str, int, int]]
    _busy: list | None = dataclasses.field(default=None, repr=False)

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def in_window(self) -> list[tuple[str, int, int]]:
        """The device activities that started inside the window."""
        lo, hi = self.window_ns
        return [e for e in self.device if lo <= e[1] < hi]

    def kernels(self) -> list[tuple[str, int, int]]:
        return [e for e in self.in_window() if not is_copy(e[0])]

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device activities, clipped to the window
        (computed once: a lock-table cell's call has millions)."""
        if self._busy is not None:
            return self._busy
        lo, hi = self.window_ns
        spans = sorted((max(s, lo), min(e, hi)) for _n, s, e in self.device
                       if e > lo and s < hi)
        out: list[list[int]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        self._busy = [(s, e) for s, e in out]
        return self._busy

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time, summed by name."""
        tot: dict[str, int] = {}
        for n, s, e in self.in_window():
            tot[n] = tot.get(n, 0) + (e - s)
        rows = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[n, ns / 1e9] for n, ns in rows]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The longest stretches of the window with no device activity,
        each named by the innermost host event (a harness span, an
        operator or a runtime call) running at its middle."""
        lo, hi = self.window_ns
        edges = [lo]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(hi)
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:top]:
            mid = (s + e) // 2
            inner = [h for h in self.host if h[1] <= mid < h[2]]
            name = min(inner, key=lambda h: h[2] - h[1])[0] if inner else (
                "host, outside any traced event")
            out.append([name, (e - s) / 1e9])
        return out


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def read(raw) -> Trace:
    """The trace in the raw result of a profiler session (what
    ``torch.autograd._disable_profiler`` returns) whose calls ran under
    ``record_function(WINDOW)``."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for e in raw.events():
        s = e.start_ns()
        row = (e.name(), s, s + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append(row)
        elif e.name() == WINDOW:
            window = row[1:]
        else:
            host.append(row)
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW!r} span")
    return Trace(window, device, host)
