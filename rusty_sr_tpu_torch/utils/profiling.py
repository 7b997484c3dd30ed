"""Tracing and timing: the port of `rusty_sr_tpu/utils/profiling.py`.

`trace(log_dir)` records a region with `torch.profiler`: CPU activity,
and the card's kernels and copies where CUDA is available, written as a
Chrome trace (``trace.json`` in ``log_dir``; open it in Perfetto or
chrome://tracing).  The CLI's ``--trace DIR`` wraps a whole run in it.
`device_timer` times a function's steady state on the device: a chain of
calls between two CUDA events (on the CPU, the host clock), best of a
few rounds, the input changed every round.

`span(name)` marks a stage of the program's own work as a
`torch.profiler.record_function` range named ``rusty_sr.<name>``, on the
profiler's clock beside the card's kernels, whenever a torch profiler
records on the calling thread (``--trace DIR``, or any
`torch.profiler.profile`); otherwise it is one shared null context.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Callable, Optional

SPAN_PREFIX = "rusty_sr."
_NULL = contextlib.nullcontext()


def span(name: str):
    """``with span("chunk.gather"):`` records the range
    ``rusty_sr.chunk.gather`` while a torch profiler records; otherwise
    returns the module's one null context (no allocation, no profiler
    call).  Torch is not imported here: where it is not loaded, no
    profiler can record."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return _NULL
    return torch.profiler.record_function(SPAN_PREFIX + name)


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


def _perturb(x, r: int):
    """+``r`` on every numeric tensor (or numpy array) leaf of a pytree of
    dicts, lists and tuples: uint8 wraps, floats shift, bool and other
    leaves stay; the point is a different input value each round."""
    import numpy as np
    import torch
    from torch.utils._pytree import tree_map

    def bump(v):
        if isinstance(v, torch.Tensor) and v.dtype != torch.bool:
            return v + torch.tensor(r, dtype=v.dtype, device=v.device)
        if isinstance(v, np.ndarray) and np.issubdtype(v.dtype, np.number):
            return v + np.asarray(r, v.dtype)
        return v
    return tree_map(bump, x)


def device_timer(fn: Callable, x, *, iters: int = 20, rounds: int = 3,
                 fold: Optional[Callable] = None) -> float:
    """Best-of-``rounds`` seconds per single ``fn(x)`` pass.

    The chain ``c = fold(fn(c), x0)`` runs ``iters`` times from ``x0``,
    the round's input; ``fold`` maps a result back to an input of ``fn``
    and carries the dependency from one pass to the next (default: the
    result itself, which must then be a valid input).  Before each round
    the input is perturbed (`_perturb`: +r on every numeric leaf).  On
    CUDA the chain runs between two ``torch.cuda.Event``s on the current
    stream, after one warm-up chain, and the events are read after a
    synchronize; on the CPU the host clock times the chain."""
    import torch
    from torch.utils._pytree import tree_leaves

    fold = fold or (lambda y, x0: y)

    def chain(x0):
        c = x0
        for _ in range(iters):
            c = fold(fn(c), x0)
        return c

    cuda = any(isinstance(t, torch.Tensor) and t.is_cuda
               for t in tree_leaves(x))
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    chain(x)                                # warm-up
    sync()
    best = float("inf")
    for r in range(rounds):
        xr = _perturb(x, r + 1)
        sync()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            chain(xr)
            stop.record()
            torch.cuda.synchronize()
            secs = start.elapsed_time(stop) * 1e-3
        else:
            t0 = time.perf_counter()
            chain(xr)
            secs = time.perf_counter() - t0
        best = min(best, secs / iters)
    return best
