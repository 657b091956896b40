"""Engine metrics: counters, timers and spans.

The reference has only vestigial tracing (commented-out TimeRecorder and
distance counters, SURVEY §5); here metrics are first-class: every search /
insert updates a process-global registry (`metrics.snapshot()`, served at
GET /api/metrics).

Spans (`span(name)`, and "vdb.gc" around every garbage collection) are
ranges on the torch.profiler (Kineto) clock, so they land in the same trace
as the device's kernels. They are recorded only while a profiler records;
otherwise a span is one shared no-op context and a collection costs one
flag check. Span names start with "vdb.".
"""
from __future__ import annotations

import contextlib
import gc
import threading
from typing import Any, Dict

import torch
import torch.autograd.profiler as _autograd_profiler


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._timers: Dict[str, Dict[str, float]] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            t = self._timers.setdefault(
                name, {"count": 0.0, "total_s": 0.0, "max_s": 0.0})
            t["count"] += 1
            t["total_s"] += seconds
            t["max_s"] = max(t["max_s"], seconds)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {"counters": dict(self._counters),
                                   "timers": {}}
            for name, t in self._timers.items():
                mean = t["total_s"] / t["count"] if t["count"] else 0.0
                out["timers"][name] = {
                    "count": int(t["count"]),
                    "total_s": round(t["total_s"], 6),
                    "mean_s": round(mean, 6),
                    "max_s": round(t["max_s"], 6),
                }
            return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timers.clear()


metrics = Metrics()


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A range `name` while a torch.profiler records (the profiler's own
    enabled flag, read once a span), else the shared no-op `_NO_SPAN`:
    record_function costs microseconds even with no profiler running."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


class _GcSpan:
    """gc.callbacks hook: a "vdb.gc" range from a collection's "start" to
    its "stop" while a profiler records. Collections do not nest and run
    on one thread from start to stop, so one slot holds the open range."""

    def __init__(self):
        self.open = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            if _autograd_profiler._is_profiler_enabled:
                self.open = torch.profiler.record_function("vdb.gc")
                self.open.__enter__()
        elif self.open is not None:
            rf, self.open = self.open, None
            rf.__exit__(None, None, None)


gc_span = _GcSpan()
gc.callbacks.append(gc_span)
