"""Tracing: `trace(log_dir)` records a region with `torch.profiler`.

The port of `rusty_sr_tpu/utils/profiling.py::trace`: CPU activity, and
the card's kernels and copies where CUDA is available, written as a
Chrome trace (``trace.json`` in ``log_dir``; open it in Perfetto or
chrome://tracing).  The CLI's ``--trace DIR`` wraps a whole run in it.
`device_timer` is not ported yet (it comes with the port's benchmark).
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region; yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
