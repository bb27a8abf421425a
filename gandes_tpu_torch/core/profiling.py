"""Phase timing, spans, counters and device traces (port of
``gandes_tpu/core/profiling.py``, extended).

``StepTimer`` is a per-phase wall-clock aggregator; a phase given a CUDA
``device`` is timed by two CUDA events on that device's stream instead,
resolved without waiting for the card. ``device_trace`` is the counterpart
of the JAX package's ``jax.profiler`` context: a ``torch.profiler`` trace of
the host's ops and, where a card is present, its kernels, written as a
Chrome trace.

Spans: ``with span(name, **attrs) as s:`` records the name, the start and
end (``time.perf_counter_ns()``), the enclosing span of the same thread,
a trace id (inherited from that span unless given) and the attributes
(``s.set(**attrs)`` adds more). Each span also opens the profiler range
``gandes.<name>``, so it lies on the device trace's timeline. Spans are
recorded only while a ``torch.profiler`` is active (``device_trace``,
``--trace-dir`` or any profiler an operator opens); at all other times
``span()`` returns one shared no-op context. ``spans()`` reads the newest
``SPAN_BUFFER`` spans.

Counters: ``COUNTERS`` holds the process-wide totals of the host stage,
always on: sims run, timed out (past their watchdog), stopped at their
record limit (the thread-mode batch call), cut by their wall budget (a
``Sim.run`` that a wall clock stopped before its customer count) and failed
(raised), DES events (event-log lines the engine emitted), rolls decoded
and decodes skipped (the reference's zero-roll shortcut). The span that did the work carries its
own increments as attributes.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict, deque

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_BUFFER = 65536
RANGE_PREFIX = "gandes."
COUNTER_NAMES = ("sims_run", "sims_timed_out", "sims_capped", "sims_budget_cut", "sims_failed",
                 "des_events", "rolls_decoded", "decodes_skipped")


class Counters:
    """Named integer totals that several threads may add to."""

    def __init__(self, names=()):
        self._lock = threading.Lock()
        self._totals = dict.fromkeys(names, 0)
        self._names = tuple(names)

    def add(self, **increments: int) -> None:
        with self._lock:
            for name, n in increments.items():
                self._totals[name] = self._totals.get(name, 0) + int(n)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._totals)

    def since(self, before: dict) -> dict:
        """Each total's increase over an earlier ``snapshot()``."""
        return {k: v - before.get(k, 0) for k, v in self.snapshot().items()}

    def reset(self) -> None:
        with self._lock:
            self._totals = dict.fromkeys(self._names, 0)


COUNTERS = Counters(COUNTER_NAMES)


class Span:
    """One span: open it with ``with``; once closed it is a record in the
    buffer that ``spans()`` reads."""

    __slots__ = ("name", "start_ns", "end_ns", "span_id", "parent_id", "trace_id", "thread",
                 "attrs", "_range")

    def __init__(self, name: str, trace_id, attrs: dict):
        self.name, self.trace_id, self.attrs = name, trace_id, attrs
        self.start_ns = self.end_ns = self.parent_id = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _open_spans()
        parent = stack[-1] if stack else None
        self.parent_id = parent.span_id if parent is not None else None
        if self.trace_id is None and parent is not None:
            self.trace_id = parent.trace_id
        self.span_id = next(_span_ids)
        self.thread = threading.get_ident()
        self._range = torch.profiler.record_function(RANGE_PREFIX + self.name)
        self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end_ns = time.perf_counter_ns()
        _open_spans().pop()
        self._range.__exit__(exc_type, exc, tb)
        self._range = None
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        with _buffer_lock:
            _buffer.append(self)
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, {self.start_ns}, {self.end_ns}, id={self.span_id}, "
                f"parent={self.parent_id}, trace={self.trace_id}, {self.attrs})")


class _NoSpan:
    """The shared span of untraced runs: does nothing."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NO_SPAN = _NoSpan()
_buffer: deque = deque(maxlen=SPAN_BUFFER)
_buffer_lock = threading.Lock()
_span_ids = itertools.count(1)
_local = threading.local()


def _open_spans() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, trace_id=None, **attrs):
    """A span named ``name`` (see the module docstring): recorded while a
    torch profiler is active, else the shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return Span(name, trace_id, attrs)


def spans() -> list:
    """The recorded spans, oldest first (at most ``SPAN_BUFFER``)."""
    with _buffer_lock:
        return list(_buffer)


class StepTimer:
    """Accumulates time per named phase; ``summary()`` reports mean / p50 /
    p95 and fraction of total per phase. Each phase is also a span.

    ``samples[phase]`` is a list of seconds, one per phase run. A phase run
    with a CUDA ``device`` is the time between two events recorded on that
    device's current stream around it, without a synchronisation: the
    card's time from the phase's start to the end of the work queued
    inside, including any wait of the stream for the host to queue that
    work. Its sample is resolved once the card has passed the second event
    (checked, never waited for, as each later phase starts); reading
    ``samples``, ``summary()`` or ``report()`` waits for whatever is still
    pending."""

    def __init__(self):
        self._samples = defaultdict(list)
        self._pending = deque()  # (samples list, index, start event, end event)

    @property
    def samples(self):
        self._resolve(wait=True)
        return self._samples

    def _resolve(self, wait: bool) -> None:
        while self._pending:
            out, i, start, end = self._pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            out[i] = start.elapsed_time(end) * 1e-3
            self._pending.popleft()

    @contextlib.contextmanager
    def phase(self, name: str, device=None):
        self._resolve(wait=False)
        with span(name):
            if device is None:
                t0 = time.perf_counter()
                try:
                    yield
                finally:
                    self._samples[name].append(time.perf_counter() - t0)
            else:
                start = torch.cuda.Event(enable_timing=True)
                start.record(torch.cuda.current_stream(device))
                try:
                    yield
                finally:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record(torch.cuda.current_stream(device))
                    out = self._samples[name]
                    out.append(None)
                    self._pending.append((out, len(out) - 1, start, end))

    def summary(self) -> dict:
        samples = self.samples
        total = sum(sum(v) for v in samples.values()) or 1e-12
        out = {}
        for name, vals in samples.items():
            arr = np.asarray(vals)
            out[name] = {
                "count": len(arr),
                "mean_s": float(arr.mean()),
                "p50_s": float(np.percentile(arr, 50)),
                "p95_s": float(np.percentile(arr, 95)),
                "total_s": float(arr.sum()),
                "frac": float(arr.sum() / total),
            }
        return out

    def report(self) -> str:
        rows = ["phase                    count   mean(ms)   p95(ms)   total(s)   frac"]
        for name, s in sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"]):
            rows.append(
                f"{name:<24} {s['count']:>5} {s['mean_s'] * 1e3:>10.2f} "
                f"{s['p95_s'] * 1e3:>9.2f} {s['total_s']:>10.2f} {s['frac']:>6.1%}"
            )
        return "\n".join(rows)


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` trace context: the CPU ops and, when CUDA is
    available, the device kernels and memory copies. On exit a Chrome trace,
    ``{host}_{pid}.{time}.pt.trace.json``, lands in ``logdir`` (open it in
    Perfetto or ``chrome://tracing``, or with TensorBoard's profiler
    plugin). The program's spans are recorded inside it and appear as the
    ``gandes.<name>`` ranges."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
