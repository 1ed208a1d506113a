"""Profiling: a ``torch.profiler`` trace of a block of work.

The reference has no profiling hooks (wall-clock was measured externally).
:func:`trace` is the counterpart of the JAX package's ``utils/profiling.py``
``trace``; it records host and, where a CUDA card is present, device
activity, and writes a Chrome trace (``chrome://tracing``, Perfetto).
Kernel times on the card are taken with CUDA events by the scripts that
measure them (``chip_smoke.py``, ``tools/``).
"""

from __future__ import annotations

import contextlib
import pathlib

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("/tmp/trace"):`` profile the enclosed work and write
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
