"""Host microseconds a query scaling a COSINE query to unit length: the
program's "vdb.table.normalize" span (Table.search, before the mask), over
the queries answered inside the traced window
(perfbench/spans.py: self time, the time of its child spans taken out).
Nothing from a program that records no such span."""
from perfbench import spans

SPAN = "vdb.table.normalize"


def read(ctx):
    s = spans.read(ctx.tracer.prof)
    return None if s is None or SPAN not in s.self_ns \
        else s.per_query_us(SPAN)
