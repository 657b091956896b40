"""One closed-loop client of vdb.query in library mode (no executor loop,
so no batch window): request j of the window asks for pool query j (mod the
pool). Warm-up asks `warmup_requests` queries from the pool's end."""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from perfbench.loadgen import QueryMode  # noqa: E402

KEYS = {"warmup_requests"}


class Mode(QueryMode):
    def warmup(self) -> None:
        for j in range(self.mix["warmup_requests"]):
            self.call(self.pool - 1 - j)

    def run(self, seconds: float, tracer):
        records = []
        tracer.start()
        start = time.monotonic()
        end = start + seconds
        j = 0
        while True:
            now = time.monotonic()
            if now >= end:
                break
            tracer.tick(now)
            records.append(self.timed_call(j % self.pool, tracer))
            j += 1
        tracer.stop()
        return self.window(start, records)
