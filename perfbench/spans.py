"""The program's own spans in a traced window: the "vdb.*" ranges that
vectordb_tpu_torch records on the profiler's clock while a profiler runs
(`metrics.span` on the query path, "vdb.gc" around each garbage
collection).

read(prof) walks the profiler's Kineto events once, memoised by profiler
since every metric file asks, and keeps the host ranges named "vdb.*" that
lie inside the benchmark's WINDOW_SPAN. A range's self time is its duration
less what its child "vdb.*" ranges on the same thread cover, so a
collection inside a re-rank counts as "vdb.gc", not as re-rank. Self times
are totalled by name over the outermost SEARCH ranges that begin and end
inside the window, each with every range nested in it; their count is the
number of queries. So the self times of one total add up to the SEARCH
ranges' summed duration. A program without spans records none, and read()
returns None: each metric that reads them then reports nothing.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from perfbench.trace import WINDOW_SPAN

PREFIX = "vdb."
SEARCH = "vdb.search"
GC = "vdb.gc"

_memo: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


@dataclass
class Spans:
    """`queries` (SEARCH ranges inside the window), `search_ns` (their
    summed duration), `self_ns` (self time by span name over those
    queries), `gc_ns` (union of GC ranges clipped to the window) and
    `window_ns`."""
    queries: int
    search_ns: int
    window_ns: int
    gc_ns: int
    self_ns: Dict[str, int] = field(default_factory=dict)

    def per_query_us(self, name: str) -> float:
        """Microseconds of `name`'s self time a query (0.0 where the
        queries hold no such range)."""
        return self.self_ns.get(name, 0) / self.queries / 1e3


def read(prof) -> Optional[Spans]:
    """The Spans of a stopped profiler, or None when it holds no
    WINDOW_SPAN or no SEARCH range inside it."""
    if prof is None:
        return None
    if prof not in _memo:
        _memo[prof] = _read(prof)
    return _memo[prof]


def per_query_us(prof, name: str) -> Optional[float]:
    s = read(prof)
    return None if s is None else s.per_query_us(name)


def _read(prof) -> Optional[Spans]:
    from torch.autograd import DeviceType

    window = None
    ranges: List[Tuple[int, int, int, str]] = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() != DeviceType.CPU:
            continue  # a device event, or a host span's mirror on the device
        if name.startswith(PREFIX):
            s = ev.start_ns()
            ranges.append((ev.start_thread_id(), s, s + ev.duration_ns(),
                           name))
        elif name == WINDOW_SPAN:
            s = ev.start_ns()
            window = (s, s + ev.duration_ns())
    if window is None:
        return None
    return summarise(ranges, *window)


def summarise(ranges: List[Tuple[int, int, int, str]], w0: int,
              w1: int) -> Optional[Spans]:
    """Spans of (thread, start_ns, end_ns, name) ranges in the window
    [w0, w1], or None when no SEARCH range lies inside it."""
    ranges = sorted(ranges, key=lambda r: (r[0], r[1], -r[2]))
    n = len(ranges)
    parent = [-1] * n
    covered = [0] * n  # by direct children
    stack: List[int] = []
    for i, (tid, s, e, _) in enumerate(ranges):
        while stack and (ranges[stack[-1]][0] != tid
                         or ranges[stack[-1]][2] <= s):
            stack.pop()
        if stack:
            p = stack[-1]
            parent[i] = p
            covered[p] += min(e, ranges[p][2]) - s
        stack.append(i)
    # Each range's outermost SEARCH ancestor (itself included), if any.
    query = [-1] * n
    for i, r in enumerate(ranges):
        p = parent[i]
        query[i] = query[p] if p >= 0 else -1
        if query[i] < 0 and r[3] == SEARCH:
            query[i] = i
    inside = [i for i in range(n) if query[i] == i
              and ranges[i][1] >= w0 and ranges[i][2] <= w1]
    if not inside:
        return None
    counted = set(inside)
    self_ns: Dict[str, int] = {}
    for i, (_, s, e, name) in enumerate(ranges):
        if query[i] in counted:
            self_ns[name] = self_ns.get(name, 0) + (e - s) - covered[i]
    gc = sorted((max(s, w0), min(e, w1)) for _, s, e, name in ranges
                if name == GC and min(e, w1) > max(s, w0))
    gc_ns, reach = 0, w0
    for s, e in gc:
        s = max(s, reach)
        if e > s:
            gc_ns += e - s
            reach = e
    return Spans(queries=len(inside),
                 search_ns=sum(ranges[i][2] - ranges[i][1] for i in inside),
                 window_ns=w1 - w0, gc_ns=gc_ns, self_ns=self_ns)
