"""The traced part of a window: torch.profiler over its first TRACE_SECONDS,
and its reading.

The reading is the benchmark's own arithmetic, so later changes to the
program cannot move it: the device's busy time is the union of the
intervals in which a kernel, copy or set ran on it (not their sum: work
that overlaps on two streams counts once), clipped to the traced window,
the span "bench.window" that the benchmark opens at its start and closes
at its end. Idle gaps are the holes in that union, each named by what the
host was doing at its midpoint: the innermost profiler event of any thread
there (an aten op, a CUDA runtime call) under the benchmark's own span
(bench.call around each call into the program). (A frozen rewrite of chip_smoke.device_profile,
whose idle share was 1 - sum(kernel times) / wall.)
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Optional

import numpy as np

TRACE_SECONDS = 5.0
TOP = 10
WINDOW_SPAN = "bench.window"


class Tracer:
    """Traces the first TRACE_SECONDS of a window in a --trace 1 run; does
    nothing in a --trace 0 run. `span(name)` is a profiler span while the
    trace runs, else a no-op; `tick()` ends the trace once it is due."""

    def __init__(self, enabled: bool, seconds: float):
        self.enabled = enabled
        self.trace_s = min(float(seconds), TRACE_SECONDS)
        self.active = False
        self.prof = None
        self.t0 = self.t1 = None

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._window = torch.profiler.record_function(WINDOW_SPAN)
        self._window.__enter__()
        self.t0 = time.monotonic()
        self.active = True

    def tick(self, now: float) -> None:
        if self.active and now - self.t0 >= self.trace_s:
            self.stop()

    def stop(self) -> None:
        if not self.active:
            return
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.monotonic()
        self._window.__exit__(None, None, None)
        self.prof.stop()
        self.active = False


class Reading:
    """What the traced window holds: `window_s`, `busy_s` (union of device
    intervals), `device_time` and `device_count` by name, `kernels`,
    `copies`, and the TOP longest idle gaps as (name, seconds)."""

    def __init__(self, window_s: float, busy_s: float, device_time: dict,
                 device_count: dict, gaps: list):
        self.window_s = window_s
        self.busy_s = busy_s
        self.device_time = device_time
        self.device_count = device_count
        self.gaps = gaps
        self.copies = sum(c for k, c in device_count.items()
                          if k.startswith(("Memcpy", "Memset")))
        self.kernels = sum(device_count.values()) - self.copies

    def time_of(self, names) -> float:
        """Device seconds of every op whose name holds one of `names`."""
        return sum(t for k, t in self.device_time.items()
                   if any(n in k for n in names))

    def count_of(self, names) -> int:
        return sum(c for k, c in self.device_count.items()
                   if any(n in k for n in names))

    def breakdown(self) -> dict:
        ops = sorted(self.device_time.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k[:120], t] for k, t in ops],
                "idle_gaps": [[k[:120], t] for k, t in self.gaps]}


def read(prof) -> Optional[Reading]:
    """The Reading of a stopped profiler, or None when it holds no
    WINDOW_SPAN."""
    from torch.autograd import DeviceType

    window = None
    dev_s, dev_e, dev_n = [], [], []
    cpu_s, cpu_e, cpu_n = [], [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if ev.is_user_annotation() or name.startswith("Activity Buffer"):
                continue  # a host span mirrored on the device's timeline,
                # or the profiler's own bookkeeping: no work of the device
            dev_s.append(s)
            dev_e.append(e)
            dev_n.append(name)
        elif name == WINDOW_SPAN:
            window = (s, e)
        else:
            cpu_s.append(s)
            cpu_e.append(e)
            cpu_n.append(name)
    if window is None:
        return None
    w0, w1 = window
    s = np.clip(np.asarray(dev_s, np.int64), w0, w1)
    e = np.clip(np.asarray(dev_e, np.int64), w0, w1)
    inside = e > s
    device_time, device_count = defaultdict(float), defaultdict(int)
    for name, a, b in zip(np.asarray(dev_n, object)[inside], s[inside],
                          e[inside]):
        device_time[name] += (b - a) * 1e-9
        device_count[name] += 1
    busy_ns, holes = _union(s[inside], e[inside], w0, w1)
    holes.sort(key=lambda h: h[0] - h[1])
    host = (np.asarray(cpu_s, np.int64), np.asarray(cpu_e, np.int64), cpu_n)
    gaps = [(_host_at((a + b) // 2, *host), (b - a) * 1e-9)
            for a, b in holes[:TOP]]
    return Reading((w1 - w0) * 1e-9, busy_ns * 1e-9, dict(device_time),
                   dict(device_count), gaps)


def _union(s: np.ndarray, e: np.ndarray, w0: int, w1: int):
    """Length of the union of [s, e) intervals, and the holes in it within
    [w0, w1) as (start, end)."""
    if not len(s):
        return 0, [(w0, w1)]
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    starts = s[new]
    ends = reach[np.r_[np.nonzero(new)[0][1:] - 1, len(s) - 1]]
    busy = int((ends - starts).sum())
    edges = np.r_[w0, ends], np.r_[starts, w1]
    holes = [(int(a), int(b)) for a, b in zip(*edges) if b > a]
    return busy, holes


def _host_at(t: int, s: np.ndarray, e: np.ndarray, cpu_n: list) -> str:
    """The innermost host event at time t, under the innermost benchmark
    span there ("host" when nothing was recorded)."""
    live = np.nonzero((s <= t) & (e >= t))[0]
    if not len(live):
        return "host"
    names = [cpu_n[i] for i in live]
    width = (e - s)[live]
    inner = names[int(np.argmin(width))]
    spans = [(w, n) for w, n in zip(width, names) if n.startswith("bench.")]
    outer = min(spans)[1] if spans else ""
    return inner if inner == outer or not outer else f"{outer}/{inner}"
