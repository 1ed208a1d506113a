"""Profiling: the program's spans and K1's counters, and a
``torch.profiler`` trace of a block of work.

The reference has no profiling hooks (wall-clock was measured externally).

**Spans.** :func:`span` (and :func:`spanned`, for a whole function)
marks a stretch of the program's host work with a name.  While a
``torch.profiler`` records, it is a ``torch.profiler.record_function``:
a host event on the profiler's timeline, which is the clock of the
device's events, so every stretch in which the card waits can be put
down to what the program was doing.  Spans nest, and each has the span
it was opened in as its parent.  With no profiler recording a span is
one check of a flag and nothing else.  A name starts with its layer, the
part before the first dot:

* ``cli``: ``cli.setup``, ``cli.smoke``, ``cli.step``, ``cli.predict``,
  ``cli.stability``, ``cli.checkpoint`` (:mod:`..cli.driver`);
* ``solvers``: ``solvers.staged``, ``solvers.stage1``,
  ``solvers.stage2``, ``solvers.polish``, ``solvers.rescue``,
  ``solvers.newton``, ``solvers.iteration``, ``solvers.jacobian``,
  ``solvers.linear_solve`` (:mod:`..solvers`);
* ``map``: ``map.eval`` (one evaluation of the map, its exact Jacobian
  or its frozen smooth piece), ``map.discovery`` (the f32 pass that fixes
  a point's firing order), ``map.lift``, ``map.restrict``, ``map.mean``,
  ``map.jvp`` (:mod:`..model.emap`, :mod:`..model.lift`,
  :mod:`..model.restrict`);
* ``parallel``: ``parallel.all_reduce``, and a
  :class:`..parallel.sharding.RankPool`'s ``parallel.start``,
  ``parallel.dispatch`` and ``parallel.collect``
  (:mod:`..parallel.sharding`).

The ops (``atorch::*``) are recorded by PyTorch itself, inside these
spans; no span is opened inside an op's kernels.

**K1's counters.** While a profiler records, every launch of K1 (the
evolve kernel, ``atorch::evolve`` on the card) adds its rows and events
(the sum of its ``n_events``), and where the launch runs the certified
window (``evolve_window > 0``) its rows, events and fallback events (the
windowed events that fell back to every lane) into
:data:`K1_COUNTERS`.  The sums stay on the device until
:meth:`K1Counters.snapshot` reads them.  The launch counters ``LAUNCHES`` of the
kernel modules count every launch, traced or not, and so do
:mod:`..parallel.sharding`'s ``ALL_REDUCES`` and ``ALL_REDUCE_BYTES`` for
every all-reduce of this process and its bytes.

:func:`trace` records host and, where a CUDA card is present, device
activity, spans included, and writes a Chrome trace (``chrome://tracing``,
Perfetto); it is the counterpart of the JAX package's
``utils/profiling.py`` ``trace``.  Kernel times on the card are taken with
CUDA events by the scripts that measure them (``chip_smoke.py``,
``tools/``).
"""

from __future__ import annotations

import contextlib
import functools
import pathlib
from typing import Callable, Optional

import torch

TRACE_FILE = "trace.json"

# Whether a torch.profiler records on this thread: the spans' one check.
recording = torch._C._autograd._profiler_enabled

_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span("solvers.iteration"):`` a program span around the
    enclosed work: a ``torch.profiler.record_function(name)`` while a
    profiler records, else a context that does nothing."""
    if recording():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str) -> Callable:
    """``@spanned("map.eval")``: every call of the decorated function is a
    :func:`span` of that name."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not recording():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class K1Counters:
    """K1's work while a profiler records: the launches, rows and events,
    and of the windowed launches their rows, events and fallback events.
    The three event sums are int64 tensors on the launches' device, added
    to without a synchronise; :meth:`snapshot` reads them."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.launches = self.rows = self.windowed_rows = 0
        # per device: (events, windowed events, fallback events)
        self._sums = {}

    def count(self, n_events: torch.Tensor,
              fallbacks: Optional[torch.Tensor] = None) -> None:
        """Count one launch of ``n_events.numel()`` rows whose per-row
        event counts are ``n_events``; ``fallbacks``, the per-row
        fallback counts, where the launch ran the window."""
        sums = self._sums.get(n_events.device)
        if sums is None:
            sums = self._sums[n_events.device] = torch.zeros(
                3, dtype=torch.int64, device=n_events.device)
        events = n_events.sum(dtype=torch.int64)
        rows = n_events.numel()
        self.launches += 1
        self.rows += rows
        if fallbacks is None:
            sums[0] += events
        else:
            self.windowed_rows += rows
            sums += torch.stack((events, events,
                                 fallbacks.sum(dtype=torch.int64)))

    def snapshot(self) -> dict:
        """The counts so far as Python ints (reads the device's sums):
        ``launches``, ``rows``, ``events``, ``windowed_rows``,
        ``windowed_events`` and ``fallback_events``."""
        events = windowed = fallback = 0
        for sums in self._sums.values():
            e, w, f = sums.tolist()
            events, windowed, fallback = (events + e, windowed + w,
                                          fallback + f)
        return {"launches": self.launches, "rows": self.rows,
                "events": events, "windowed_rows": self.windowed_rows,
                "windowed_events": windowed, "fallback_events": fallback}


# every launch of K1 made while a profiler recorded
K1_COUNTERS = K1Counters()


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("/tmp/trace"):`` profile the enclosed work, the
    program's spans with the ops and kernels they enclose, and write
    ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / TRACE_FILE))
