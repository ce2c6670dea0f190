"""The traced window: the card's operations from ``torch.profiler``, the
benchmark's own spans around calls into the port, and what they add up to.

A run with ``--trace 1`` profiles its measured window on the card only
(CUDA activity: kernels, copies, fills), so the host runs as in an
untraced window but for the tracer's record of each launch. The busy time
is the union of the operations' intervals, so operations that overlap (a
programmatic dependent launch, a copy beside a kernel, nccl beside
compute) count once. The benchmark's spans are host wall-clock intervals
on the profiler's clock (Unix time in ns); they label the card's idle
gaps by what the host was doing.
"""

from __future__ import annotations

import contextlib
import time

PREFIX = "portbench."
NOT_LAUNCHES = ("Memcpy", "Memset")


class Trace:
    """``with trace.window():`` profiles when enabled; ``trace.span(name)``
    marks a call into the port. Disabled, both cost nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.record = None
        self._spans = None

    @contextlib.contextmanager
    def span(self, name: str):
        if self._spans is None:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self._spans.append((name, t0, time.time_ns()))

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._spans = []
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start = time.time_ns()
            yield
            torch.cuda.synchronize()
            end = time.time_ns()
        spans, self._spans = self._spans, None
        self.record = {"kernels": read(prof), "spans": spans, "window_ns": (start, end)}


def read(prof) -> list:
    """[(name, start_ns, duration_ns)] of the card's operations in a finished
    profile, from its raw events."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0
            and e.name() != "Command Buffer Full" and not e.is_user_annotation()]


def merged(kernels, start: int, end: int) -> list:
    """The union of the operations' intervals, clipped to [start, end)."""
    spans = sorted((max(s, start), min(s + d, end)) for _, s, d in kernels)
    out = []
    for s, e in spans:
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy(record: dict) -> tuple:
    """(busy seconds, window seconds) of one traced window."""
    start, end = record["window_ns"]
    return (sum(e - s for s, e in merged(record["kernels"], start, end)) / 1e9,
            (end - start) / 1e9)


def launches(record: dict) -> int:
    return sum(1 for name, _, _ in record["kernels"] if not name.startswith(NOT_LAUNCHES))


def kernel_seconds(record: dict, *needles: str) -> float:
    return sum(d for name, _, d in record["kernels"] if any(n in name for n in needles)) / 1e9


def breakdown(record: dict, top: int = 10) -> dict:
    """The card's operations that took most time, and the longest idle gaps,
    each named by the innermost benchmark span open at its middle."""
    by_name = {}
    for name, _, d in record["kernels"]:
        by_name[name] = by_name.get(name, 0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    start, end = record["window_ns"]
    edges = [start] + [x for s, e in merged(record["kernels"], start, end) for x in (s, e)]
    edges.append(end)
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    idle = []
    for length, at in gaps:
        mid = at + length // 2
        open_ = [s for s in record["spans"] if s[1] <= mid <= s[2]]
        label = max(open_, key=lambda s: s[1])[0] if open_ else "outside the benchmark's spans"
        idle.append([label, length / 1e9])
    return {"device_ops": [[name[:200], d / 1e9] for name, d in ops], "idle_gaps": idle}
