"""Host microseconds a query in the mask stage: the program's
"vdb.table.mask" span (Table._search_ids: the host validity mask, the
filter's compile and host fold), over the queries answered inside the
traced window
(perfbench/spans.py: self time, the time of its child spans taken out)."""
from perfbench import spans


def read(ctx):
    return spans.per_query_us(ctx.tracer.prof, "vdb.table.mask")
