"""Share of the traced window's queries whose dense graph walk was a replay
of a captured CUDA graph, in %: the program's "vdb.table.replay" ranges
(around ReplayCache's graph.replay() in vectordb_tpu_torch/ops/beam.py)
inside the outermost "vdb.search" ranges that begin and end inside the
window, over the number of those ranges, times 100. Reads the profiler's
events itself. Nothing from a program that has no such span (one without
the replay cache) or a trace with no query inside the window."""
from __future__ import annotations

from typing import List, Tuple

SEARCH = "vdb.search"
REPLAY = "vdb.table.replay"


def count(ranges: List[Tuple[int, int, int, str]], w0: int,
          w1: int) -> Tuple[int, int]:
    """(queries, replays) of (thread, start_ns, end_ns, name) host ranges:
    the outermost SEARCH ranges inside [w0, w1], and the REPLAY ranges
    nested in them on their thread."""
    queries = replays = 0
    outer = None  # (thread, end, inside the window) of the open SEARCH
    for tid, s, e, name in sorted(ranges, key=lambda r: (r[0], r[1], -r[2])):
        if outer is not None and (outer[0] != tid or s >= outer[1]):
            outer = None
        if name == SEARCH and outer is None:
            outer = (tid, e, w0 <= s and e <= w1)
            queries += outer[2]
        elif (name == REPLAY and outer is not None and outer[2]
              and e <= outer[1]):
            replays += 1
    return queries, replays


def read(ctx):
    from torch.autograd import DeviceType

    from perfbench.trace import WINDOW_SPAN
    from vectordb_tpu_torch.ops import beam

    prof = ctx.tracer.prof
    if prof is None or getattr(beam, "REPLAY_SPAN", None) != REPLAY:
        return None
    window, ranges = None, []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() != DeviceType.CPU:
            continue
        if name in (SEARCH, REPLAY):
            s = ev.start_ns()
            ranges.append((ev.start_thread_id(), s, s + ev.duration_ns(),
                           name))
        elif name == WINDOW_SPAN:
            s = ev.start_ns()
            window = (s, s + ev.duration_ns())
    if window is None:
        return None
    queries, replays = count(ranges, *window)
    return 100.0 * replays / queries if queries else None
