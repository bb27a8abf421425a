"""Reading a ``torch.profiler`` trace of a stretch of the window.

The benchmark traces the last stretch of the measured window with
``torch.profiler`` (kernels, copies and memsets on the card, and the CPU
ranges the benchmark's own taps open with ``record_function``, all named
``portbench.<stage>``). From it come the device's busy time (the union of
the device intervals), the operations that took most device time, the
longest idle gaps with the stage the host was in, and the device time of
everything a named range launched.
"""

from __future__ import annotations

import contextlib
import math
import time

PREFIX = "portbench."


class Trace:
    """One traced stretch: ``window_s`` of host wall time, the device
    intervals (us) and the benchmark's CPU ranges."""

    def __init__(self, prof, window_s: float):
        from torch.autograd import DeviceType

        events = list(prof.events())
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        self.device_ops = [(e.name, e.time_range.start, e.time_range.end)
                           for e in device if not e.is_user_annotation]
        self.ranges = [(e.name[len(PREFIX):], e.time_range.start, e.time_range.end)
                       for e in events
                       if e.device_type == DeviceType.CPU and e.name.startswith(PREFIX)]
        # a range's device-side twin spans the kernels launched inside it
        self.device_ranges = [(e.name[len(PREFIX):], e.time_range.start, e.time_range.end)
                              for e in device
                              if e.is_user_annotation and e.name.startswith(PREFIX)]
        self.window_s = window_s

    def busy_s(self) -> float:
        busy, end = 0.0, -math.inf
        for _, start, stop in sorted(self.device_ops, key=lambda x: x[1]):
            if stop > end:
                busy += stop - max(start, end)
                end = stop
        return busy * 1e-6

    def top_ops(self, n: int = 10) -> list:
        totals: dict[str, float] = {}
        for name, start, stop in self.device_ops:
            totals[name] = totals.get(name, 0.0) + (stop - start) * 1e-6
        return sorted(([k[:64], v] for k, v in totals.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest gaps between device intervals, each named by the
        innermost benchmark range open on the host at its middle."""
        gaps, end = [], None
        for _, start, stop in sorted(self.device_ops, key=lambda x: x[1]):
            if end is not None and start > end:
                gaps.append((start - end, end, start))
            end = stop if end is None else max(end, stop)
        gaps.sort(key=lambda g: -g[0])
        out = []
        for length, lo, hi in gaps[:n]:
            mid = 0.5 * (lo + hi)
            inside = [r for r in self.ranges if r[1] <= mid <= r[2]]
            name = min(inside, key=lambda r: r[2] - r[1])[0] if inside else "other"
            out.append([name, length * 1e-6])
        return out

    def range_device_s(self) -> list:
        """``(name, device seconds)`` of each device-side range: the time of
        the device operations inside its span."""
        ops = sorted(self.device_ops, key=lambda x: x[1])
        out = []
        for name, lo, hi in self.device_ranges:
            busy = sum(min(stop, hi) - max(start, lo) for _, start, stop in ops
                       if start < hi and stop > lo)
            out.append((name, busy * 1e-6))
        return out


class Tracer:
    """Starts ``torch.profiler`` once armed, at the first point between two
    units of work that the caller polls, and stops it when the caller closes
    it after the measured window has ended, so that reading the trace costs
    the window nothing."""

    def __init__(self, enabled: bool, armed: bool = False):
        self.enabled, self.armed = enabled, armed
        self.prof = self.trace = None
        self.t0 = None
        self.start_s = None  # how long the profiler took to start in the window

    @staticmethod
    def _profile():
        import torch
        from torch.profiler import ProfilerActivity, profile

        try:  # the CPU ranges of every thread, a serving cell's handler threads too
            config = {"experimental_config": torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)}
        except TypeError:
            config = {}
        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **config)

    def warm(self):
        """In set-up: one short trace, so that the profiler's first start
        (seconds, on the card's host) does not fall into the window."""
        if not self.enabled:
            return
        import torch

        with self._profile():
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def poll(self):
        if not self.enabled or not self.armed or self.prof is not None or self.trace:
            return
        import torch

        t = time.perf_counter()
        torch.cuda.synchronize()
        self.prof = self._profile()
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.start_s = self.t0 - t

    def close(self):
        if self.prof is not None:
            import torch

            torch.cuda.synchronize()
            window_s = time.perf_counter() - self.t0
            self.prof.__exit__(None, None, None)
            self.trace = Trace(self.prof, window_s)
            self.prof = None


def labelled(fn, stage: str, enabled: bool):
    """``fn`` inside a ``record_function("portbench.<stage>")`` range when
    ``enabled`` (the traced run), else ``fn`` itself."""
    if not enabled:
        return fn
    import torch

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(PREFIX + stage):
            return fn(*args, **kwargs)

    return wrapped


@contextlib.contextmanager
def patched(patches):
    """Set each ``(object, attribute, value)`` for the block, then restore."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, value in patches:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)
