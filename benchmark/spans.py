"""The device's idle time by the program layer the host was in.

The port marks its layers' host work with spans
(``armadillocudalinearinterpolation_torch/utils/profiling.py``): host
events whose names start with the layer and a dot (``cli.step``,
``solvers.iteration``, ``map.eval``, ``parallel.all_reduce``).  Every idle
gap between the traced window's device events is put down to the
innermost such span that encloses the gap's middle, or to no span.  Only
the program's spans are searched, in one sweep over the gaps in time
order, so a span that opened many host events before its gap is found as
readily as one that opened just before it.
"""

from __future__ import annotations

from benchmark.yardstick import gaps

LAYERS = ("cli", "solvers", "map", "parallel")


def layer_of(name: str):
    """The layer of a program span's name, or None for any other host
    event (an op, ``aten::*``, the profiler's own)."""
    layer = name.split(".", 1)[0]
    return layer if layer in LAYERS and "." in name else None


def idle_by_layer(trace) -> dict:
    """Seconds of device idle in the traced window by the layer of the
    innermost program span around each gap's middle (None: inside no
    span); ``{}`` where the trace holds no program span.  The gaps are
    those of :meth:`benchmark.trace.TraceData.breakdown`: between the
    device events, from the first host or device event to the last."""
    spans = sorted(((s, e, layer_of(n)) for s, e, n in trace.host
                    if layer_of(n)), key=lambda x: (x[0], -x[1]))
    out = {}
    if spans:
        busy = [(s, s + d) for _, s, d in trace.kernels]
        lo = min([h[0] for h in trace.host[:1]] + [s for s, _ in busy[:1]])
        hi = max([h[1] for h in trace.host] + [e for _, e in busy])
        idle = sorted(((a + b) / 2, b - a) for a, b in gaps(busy, lo, hi))
        out = {layer: 0.0 for layer in LAYERS + (None,)}
        stack, j = [], 0
        for mid, length in idle:
            while j < len(spans) and spans[j][0] <= mid:
                # spans that closed before this one opened are done
                while stack and stack[-1][1] < spans[j][0]:
                    stack.pop()
                stack.append(spans[j])
                j += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            out[stack[-1][2] if stack else None] += length / 1e6
    return out


def idle_share(ctx, *layers):
    """The device's idle time inside the innermost program spans of
    ``layers`` (None: inside no program span), in % of the traced
    window; None on an untraced run, or where the program records no
    span."""
    if ctx.trace is None:
        return None
    by_layer = idle_by_layer(ctx.trace)
    if not by_layer:
        return None
    return 100.0 * sum(by_layer[layer] for layer in layers) / ctx.window_s
