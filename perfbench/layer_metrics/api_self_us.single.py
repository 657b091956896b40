"""Host microseconds a query in the API layer: the self time of the program's
"vdb.search" span (DBServer.search: resolve, filter parse, the query's
conversion, Table.search's checks, the batcher's inline group of one), over
the queries answered inside the traced window
(perfbench/spans.py: self time, the time of its child spans taken out)."""
from perfbench import spans


def read(ctx):
    return spans.per_query_us(ctx.tracer.prof, "vdb.search")
