"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over the
last ``trace_s`` seconds of the window, and its reduction.

The harness marks what the host is doing with ``record_function`` spans
(``eb:<name>``) around its calls into the program; they land in the same
trace as the kernels and copies.  From one traced stretch it reads: the
device's busy time (the union of kernel, copy and set intervals), the
stretch's length on the host clock, device seconds by kernel name, and
the idle gaps summed by the innermost host span they fall in.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch

LEAF = ("infer", "admit", "decode", "harvest")


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short(name: str) -> str:
    name = name.removeprefix("void ").split("(")[0].split("<")[0]
    return name.rsplit("::", 1)[-1][:64]


class Tracer:
    """``span(name)`` marks host work while the profiler is on; ``start``
    and ``stop`` bracket the traced stretch; ``summary()`` reduces it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.on = False
        self.prof = None
        self.window_s = 0.0

    def prime(self) -> None:
        """Start and stop the profiler once over a small device op, so its
        first start (CUPTI's load) falls in the set-up and not in the
        traced stretch."""
        self.start()
        torch.ones(1, device=self.device).add_(1)
        self.stop()
        self.prof = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function("eb:" + name)

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()
        self._win = torch.profiler.record_function("eb:window")
        self._win.__enter__()
        self.on = True

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._win.__exit__(None, None, None)
        self.window_s = time.perf_counter() - self._t0
        self.on = False
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        """busy_s, window_s, kernel_s (device seconds by short name),
        device_ops and idle_gaps (the ten largest of each, seconds)."""
        events = self.prof.events()
        dev_type = torch.autograd.DeviceType.CUDA
        # host spans (the harness's and the program's own scopes) are also
        # drawn on the device's timeline as annotations: not device work
        marks = {e.name for e in events if e.device_type != dev_type}
        device = [e for e in events if e.device_type == dev_type
                  and not getattr(e, "is_user_annotation", False)
                  and e.name not in marks and not e.name.startswith("eb:")]
        spans = defaultdict(list)
        window = None
        for e in events:
            if e.device_type != dev_type and e.name.startswith("eb:"):
                tr = (e.time_range.start, e.time_range.end)
                if e.name == "eb:window":
                    window = tr
                else:
                    spans[e.name[3:]].append(tr)
        return reduce(device and [(e.time_range.start, e.time_range.end,
                                   e.name) for e in device],
                      spans, window, self.window_s)


def reduce(device, spans: dict, window, window_s: float) -> dict:
    """The reduction of one traced stretch: ``device`` [(start µs, end µs,
    name)], ``spans`` {host span name: [(start, end)]}, ``window`` the
    traced stretch's (start, end) in the same clock."""
    kernel_s = defaultdict(float)
    for s, e, name in device or ():
        kernel_s[short(name)] += (e - s) * 1e-6
    busy = _union((s, e) for s, e, _ in device or ())
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps = defaultdict(float)
    if window is not None:
        leaf = sorted((s, e, n) for n in LEAF for s, e in spans.get(n, ()))
        starts = [s for s, _, _ in leaf]
        steps = sorted(spans.get("step", ()))
        step_starts = [s for s, _ in steps]
        edges = [window[0]] + [x for iv in busy for x in iv] + [window[1]]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            i = bisect.bisect_right(starts, mid) - 1
            j = bisect.bisect_right(step_starts, mid) - 1
            if i >= 0 and leaf[i][1] >= mid:
                label = leaf[i][2]
            elif j >= 0 and steps[j][1] >= mid:
                label = "scheduler"
            else:
                label = "harness"
            gaps[label] += (b - a) * 1e-6
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "window_s": window_s,
            "kernel_s": dict(kernel_s),
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in
                          sorted(gaps.items(), key=lambda kv: -kv[1])][:10]}
