"""Share of the traced window spent in Python's garbage collector, in %:
the union of the program's "vdb.gc" spans (one a collection, on any thread)
over the window; 0.0 when the program recorded spans and no collection ran
(perfbench/spans.py)."""
from perfbench import spans


def read(ctx):
    s = spans.read(ctx.tracer.prof)
    return None if s is None else 100.0 * s.gc_ns / s.window_ns
