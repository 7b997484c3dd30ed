"""Spans around the harness's calls into the program, and the device
timeline of one traced slice of the window.

A span is a `torch.profiler.record_function` range named
``portbench.<name>``, so that it lands on the trace's own clock beside
the card's operations.  A slice records CPU ranges and CUDA activity
with `torch.profiler` between two synchronisations, and is read once
it stops: the card's kernels and copies, the harness's spans, and the
idle gaps between kernels, each labelled by the innermost span that was
open at the time.  Nothing is written to disk.
"""

from __future__ import annotations

import contextlib

PREFIX = "portbench."
_COPY = ("Memcpy", "Memset")


class Spans:
    """``with spans("decode"):`` marks a range in a traced run; a no-op
    otherwise."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(PREFIX + name)


def _ns(e, which: str) -> int:
    get = getattr(e, which + "_ns", None)
    if get is not None:
        return int(get())
    return int(getattr(e, which + "_us")() * 1000)


def _is_device(e) -> bool:
    return str(e.device_type()).split(".")[-1].upper() == "CUDA"


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' parentheses
    and argument list, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].strip()[:120]


def union(intervals) -> list:
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def covered(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


class Reading:
    """One slice, read: times in seconds from the slice's start.

    ``kernels`` and ``copies``: (name, start, end) of the card's kernels
    and of its copies and memsets; ``spans``: (name, start, end) of the
    harness's spans; ``counts``: the work the driver put through the
    slice; ``busy_s``: the union of every device operation."""

    def __init__(self, slice_s, kernels, copies, spans, counts):
        self.slice_s = slice_s
        self.kernels = kernels
        self.copies = copies
        self.spans = spans
        self.counts = counts
        self.busy_s = covered([(s, e) for _, s, e in kernels + copies])
        self.kernel_busy_s = covered([(s, e) for _, s, e in kernels])
        self.config = self.traffic = None
        self.power_limit_w = None

    def span_s(self, name: str) -> float:
        return sum(e - s for n, s, e in self.spans if n == name)

    def kernel_s(self, pattern) -> float:
        """Summed device time of the kernels whose name matches the
        compiled regular expression ``pattern``."""
        return sum(e - s for n, s, e in self.kernels if pattern.search(n))

    def breakdown(self, top: int = 10) -> dict:
        by_op: dict = {}
        for n, s, e in self.kernels + self.copies:
            key = short_name(n)
            by_op[key] = by_op.get(key, 0.0) + (e - s)
        gaps: dict = {}
        busy = union([(s, e) for _, s, e in self.kernels])
        edges = [0.0] + [x for iv in busy for x in iv] + [self.slice_s]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid, label, width = (a + b) / 2, "no harness span", float("inf")
            for n, s, e in self.spans:
                if s <= mid <= e and e - s < width:
                    label, width = n, e - s
            tot, cnt = gaps.get(label, (0.0, 0))
            gaps[label] = (tot + (b - a), cnt + 1)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1][0])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[f"idle in {k} ({c} gaps)", t]
                              for k, (t, c) in idle]}


class Slice:
    """The profiler over one steady slice of the window: `start` and
    `stop` synchronise the card first, so the slice holds whole units of
    work; `stop` returns a `Reading`.  Off the card (the harness's CPU
    tests) it records the CPU alone."""

    def __init__(self, cuda: bool = True):
        self.cuda = cuda
        self.prof = None
        self.mark = None

    def _sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.mark = torch.profiler.record_function(PREFIX + "slice")
        self.mark.__enter__()

    def stop(self, counts: dict) -> Reading:
        self._sync()
        self.mark.__exit__(None, None, None)
        self.prof.stop()
        events = self.prof.profiler.kineto_results.events()
        self.prof = None
        s0 = s1 = None
        for e in events:
            if not _is_device(e) and e.name() == PREFIX + "slice":
                s0, s1 = _ns(e, "start"), _ns(e, "end")
        if s0 is None:
            raise RuntimeError("the profiler recorded no slice marker")
        kernels, copies, spans = [], [], []
        for e in events:
            name = e.name()
            a, b = _ns(e, "start"), _ns(e, "end")
            if b < s0 or a > s1:
                continue
            iv = (max(a, s0) - s0) * 1e-9, (min(b, s1) - s0) * 1e-9
            if _is_device(e):
                if name.startswith(PREFIX) or getattr(
                        e, "is_user_annotation", lambda: False)():
                    continue
                (copies if name.startswith(_COPY) else kernels).append(
                    (name,) + iv)
            elif name.startswith(PREFIX) and name != PREFIX + "slice":
                spans.append((name[len(PREFIX):],) + iv)
        return Reading((s1 - s0) * 1e-9, kernels, copies, spans, counts)
