"""The traced run: ``torch.profiler`` (CPU + CUDA activities) over the
whole window, reduced to what the per-layer readers and the result's
``breakdown`` need.

The window runs inside ``record_function(MARK)``; its CPU span bounds
the traced window.  Device operations are the profiler's CUDA events
(kernels, copies, fills), read straight from its raw results; the
profiler's own annotations on the device timeline (named after a
``record_function``) are left out.  Times are in microseconds on the
profiler's clock.
"""

from __future__ import annotations

import bisect
import collections
import re

import torch

MARK = "imbue_bench.window"
NAME_CHARS = 160


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


class Trace:
    def __init__(self, device_ops, host_ops, window):
        """``device_ops`` and ``host_ops``: ``(name, start_us, end_us)``;
        ``window``: ``(start_us, end_us)``."""
        self.window = window
        self.device_ops = sorted(device_ops, key=lambda e: e[1])
        self.host_ops = sorted(host_ops, key=lambda e: e[1])
        self._host_starts = [s for _, s, _ in self.host_ops]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy(self):
        """The merged intervals in which some device operation ran, cut
        to the window."""
        out = []
        w0, w1 = self.window
        for _, s, e in self.device_ops:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def kernels(self, pattern: str | None = None):
        rx = None if pattern is None else re.compile(pattern)
        return [op for op in self.device_ops if is_kernel(op[0])
                and (rx is None or rx.search(op[0]))]

    def device_s(self, ops=None) -> float:
        """Summed duration of ``ops`` (all device operations)."""
        ops = self.device_ops if ops is None else ops
        return sum(e - s for _, s, e in ops) / 1e6

    def gaps(self):
        """``(start, end)`` of each idle stretch of the device within the
        window."""
        out, t = [], self.window[0]
        for s, e in self.busy():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host operation in flight at ``t`` (the latest to
        start of those that cover it), or ``python``."""
        i = bisect.bisect_right(self._host_starts, t)
        for name, s, e in reversed(self.host_ops[max(0, i - 64):i]):
            if e >= t:
                return name
        return "python"

    def breakdown(self, top: int = 10) -> dict:
        by_op = collections.Counter()
        for name, s, e in self.device_ops:
            by_op[name[:NAME_CHARS]] += (e - s) / 1e6
        by_host = collections.Counter()
        for s, e in self.gaps():
            by_host[self.host_at(s)[:NAME_CHARS]] += (e - s) / 1e6
        return {"device_ops": [[n, v] for n, v in by_op.most_common(top)],
                "idle_gaps": [[n, v] for n, v in by_host.most_common(top)]}


def _span_us(event):
    if hasattr(event, "start_ns"):
        return event.start_ns() / 1e3, event.end_ns() / 1e3
    return event.start_us(), event.start_us() + event.duration_us()


def from_kineto(results) -> Trace:
    from torch.autograd import DeviceType
    device_ops, host_ops, window = [], [], None
    for ev in results.events():
        name = ev.name()
        s, e = _span_us(ev)
        if ev.device_type() == DeviceType.CPU:
            if name == MARK:
                window = (s, e)
            else:
                host_ops.append((name, s, e))
        elif name != MARK:
            device_ops.append((name, s, e))
    if window is None:
        raise RuntimeError(f"the profiler recorded no {MARK!r} span")
    return Trace(device_ops, host_ops, window)


def capture(fn):
    """``(fn(), Trace)`` with ``fn`` run under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(MARK):
            out = fn()
    return out, from_kineto(prof.profiler.kineto_results)
