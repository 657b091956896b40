"""Host microseconds a query blocked on the device: the program's
"vdb.table.fetch" span (the copy of the device's candidates to the host,
which waits for the work dispatched before it), over the queries answered
inside the traced window
(perfbench/spans.py: self time, the time of its child spans taken out)."""
from perfbench import spans


def read(ctx):
    return spans.per_query_us(ctx.tracer.prof, "vdb.table.fetch")
