"""The benchmark's yardstick: seeds, the card's peaks, the operation counts
of the port's kernels, the roofline arithmetic, and the timing
and profiling helpers.

Later changes to the program do not change these: they are the ruler the
program is measured with.  ``is_device_work``, ``nvidia_smi`` and ``PEAK``
are copies of the helpers of the same names in the repository's
``chip_smoke.py``, and :func:`union_seconds` is the busy-time sum of its
``device_profile``.

Operation counts are per lane and per event, taken from the plain map's
arithmetic in :mod:`benchmark.reference.edmap` (each ``+ - * /``, ``exp``,
``pow``, comparison or select counts as one operation; row-wide scalars,
such as ``exp(-dt)``, are not counted per lane).  They count what every
lane of a row needs at each of its events, whatever kernel computes it:

* the advance of one lane by an event (``edmap.advance``): the voltage's
  closed form 10, the reset's select 1, the ring distance of the kick 4,
  the synapse's decay and kick 5: ``ADVANCE_OPS = 20``;
* the evolve's choice of the next event (``edmap.fire_decision`` and the
  argmin): the closed-form fire decision 13 and the comparison of the
  argmin 1.  The Newton steps of the lanes that fire are left out, so the
  count, and with it the least time, is a lower bound;
* the tangent of the advance along one direction (the exact Jacobian's
  tangent replay; no parameter direction): the voltage 14, the synapse
  5: ``TANGENT_OPS = 19``.  The event time's own tangent is one lane an
  event and is left out.
"""

from __future__ import annotations

import hashlib
import math
import subprocess
from typing import Optional

# Peaks of one H100 SXM (NVIDIA's data sheet; dense, no tensor cores for
# float32 and float64), in bytes/s and operations/s.  They assume the
# card's full 700 W; a share is stated with the card's power limit.
PEAK = {"bytes": 3.35e12, "float32": 67e12, "float64": 34e12}

ADVANCE_OPS = 20
DECISION_OPS = 13
ARGMIN_OPS = 1
TANGENT_OPS = 19
# K1, the evolve: choice of the event on every lane, then the advance
K1_OPS = DECISION_OPS + ARGMIN_OPS + ADVANCE_OPS
# K2, the replay of a known firing order: the advance
K2_OPS = ADVANCE_OPS


def k2t_ops(directions: int) -> int:
    """K2T, the tangent replay: the primal advance once, the tangent
    advance once a direction."""
    return ADVANCE_OPS + TANGENT_OPS * directions


def stream_seed(*parts) -> int:
    """A 63-bit seed for one stream of draws, from the run's ``--seed``
    and the stream's name and indices (any whole numbers or strings)."""
    h = hashlib.sha256(repr(tuple(parts)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def least_seconds(ops: float, n_bytes: float, dtype: str):
    """The least time the card could take for ``ops`` operations of
    ``dtype`` and ``n_bytes`` moved once: ``(seconds, what bounds it)``."""
    t_ops = ops / PEAK[dtype]
    t_bytes = n_bytes / PEAK["bytes"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def is_device_work(e) -> bool:
    """Whether a profiler event is device work (a kernel, copy or set), not
    an annotation the profiler draws on the device's timeline."""
    from torch.autograd import DeviceType
    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("ProfilerStep"))


def union_seconds(spans) -> float:
    """Length of the union of ``(start_us, end_us)`` intervals, in s."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def gaps(spans, lo: float, hi: float):
    """The idle intervals ``(start_us, end_us)`` between ``lo`` and ``hi``
    that the ``(start_us, end_us)`` spans leave uncovered."""
    out, cur = [], lo
    for a, b in sorted(spans):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def kernel_dtype(name: str) -> Optional[str]:
    """The dtype of a templated kernel from its name (``<float`` or
    ``<double``), or None."""
    if "<double" in name:
        return "float64"
    if "<float" in name:
        return "float32"
    return None


def _size(dtype: str) -> int:
    return 8 if dtype == "float64" else 4


def _rows(shapes, n_real: int, v0: int, beta: int) -> int:
    """Rows of one launch: ``P`` points of ``v0`` times ``R``, or one row
    of rates a row."""
    P, Rb = shapes[v0][0], shapes[beta][0]
    return P * n_real if Rb == n_real else Rb


def launch_work(op: str, shapes, n_real: int, n_spikes: int,
                events_per_row: float, dtype: str):
    """``(operations, bytes)`` that one call of the port's op ``op`` needs,
    from its recorded input shapes: rows x N lanes x events a row x
    operations a lane and event, and its inputs and outputs moved once
    (the firing-order log and the time log are left out of the bytes)."""
    sz = _size(dtype)
    if op == "atorch::evolve":
        rows, N = _rows(shapes, n_real, 1, 3), shapes[1][1]
        ops = rows * N * events_per_row * K1_OPS
        inputs = (2 * shapes[1][0] + shapes[3][0]) * N * sz
    elif op == "atorch::replay":
        rows, N = _rows(shapes, n_real, 3, 5), shapes[3][1]
        ops = rows * N * events_per_row * K2_OPS
        inputs = ((2 * shapes[3][0] + shapes[5][0]) * N * sz
                  + shapes[1][0] * shapes[1][1] * 4)
    elif op == "atorch::replay_tangent":
        rows, N = _rows(shapes, n_real, 3, 5), shapes[3][1]
        D = shapes[7][0]
        ops = rows * N * events_per_row * k2t_ops(D)
        inputs = ((2 * shapes[3][0] + shapes[5][0]) * N * sz
                  + 2 * D * shapes[3][0] * N * 8
                  + shapes[1][0] * shapes[1][1] * 4)
        inputs += 2 * D * rows * n_spikes * 8          # the tangents out
    else:
        raise ValueError(f"no operation count for {op!r}")
    outputs = rows * (n_spikes * 2 * (4 + sz) + 1 + 4)
    return ops, inputs + outputs


def roofline_share(trace, op: str, match, n_real: int, n_spikes: int,
                   events_per_row: float, default_dtype: str):
    """A kernel's share of its roofline over a traced window, in %: the
    least time of the work its launches needed (:func:`launch_work` of
    each op call, against the peak of the launch's dtype, or its bytes,
    whichever is larger) over the device time of those launches.  The
    op's calls and the kernel's launches are paired in order; None where
    the window has none, or the two counts differ."""
    calls = trace.op_calls(op)
    launches = trace.kernel_seconds(match)
    if not launches or len(calls) != len(launches):
        return None
    least = 0.0
    for shapes, (name, _) in zip(calls, launches):
        dtype = kernel_dtype(name) or default_dtype
        ops, n_bytes = launch_work(op, shapes, n_real, n_spikes,
                                   events_per_row, dtype)
        least += least_seconds(ops, n_bytes, dtype)[0]
    return 100.0 * least / sum(s for _, s in launches)
