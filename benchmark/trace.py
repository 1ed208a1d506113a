"""What a traced run keeps of ``torch.profiler``'s events: the device's
kernels, the port's op calls with their input shapes, the busy time, and
the breakdown that goes into the result line.

Everything is read once the window has closed; the profiler's own
objects are dropped before the reference runs.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from benchmark.yardstick import gaps, is_device_work, union_seconds

# idle gaps labelled with what the host was doing, longest first
LABELLED_GAPS = 4000


@dataclass
class TraceData:
    window_s: float
    busy_s: float
    # (name, start_us, duration_us) of every device event, in start order
    kernels: list = field(default_factory=list)
    # (name, input_shapes, start_us) of every call of a port's op
    # (``atorch::*``), in start order
    ops: list = field(default_factory=list)
    # (start_us, end_us, name) of the host's events, in start order
    host: list = field(default_factory=list)

    @staticmethod
    def of(prof, window_s: float) -> "TraceData":
        kernels, ops, host = [], [], []
        for e in prof.events():
            start, end = e.time_range.start, e.time_range.end
            if is_device_work(e):
                kernels.append((e.name, start, end - start))
            elif e.device_type.name == "CPU":
                host.append((start, end, e.name))
                if e.name.startswith("atorch::"):
                    ops.append((e.name, e.input_shapes, start))
        kernels.sort(key=lambda k: k[1])
        ops.sort(key=lambda o: o[2])
        host.sort()
        busy = union_seconds((s, s + d) for _, s, d in kernels)
        return TraceData(window_s=window_s, busy_s=busy, kernels=kernels,
                         ops=ops, host=host)

    def kernel_seconds(self, match) -> list:
        """``(name, seconds)`` of the device events whose name ``match``
        accepts, in start order."""
        return [(n, d / 1e6) for n, _, d in self.kernels if match(n)]

    def op_calls(self, name: str) -> list:
        return [shapes for n, shapes, _ in self.ops if n == name]

    def _doing(self, t: float) -> str:
        """The innermost host event running at time ``t``."""
        i = bisect.bisect_right(self.host, (t, float("inf"), ""))
        for start, end, name in reversed(self.host[max(0, i - 400):i]):
            if start <= t <= end:
                return name
        return "host outside any recorded op"

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing, ten of each, in seconds."""
        by_name = {}
        for n, _, d in self.kernels:
            by_name[n] = by_name.get(n, 0.0) + d / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        spans = [(s, s + d) for _, s, d in self.kernels]
        lo = min([h[0] for h in self.host[:1]] + [s for s, _ in spans[:1]],
                 default=0.0)
        hi = max([h[1] for h in self.host] + [e for _, e in spans],
                 default=0.0)
        idle = sorted(gaps(spans, lo, hi), key=lambda g: g[0] - g[1])
        by_doing = {}
        for a, b in idle[:LABELLED_GAPS]:
            what = self._doing(0.5 * (a + b))
            by_doing[what] = by_doing.get(what, 0.0) + (b - a) / 1e6
        top_idle = sorted(by_doing.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in top_idle]}
