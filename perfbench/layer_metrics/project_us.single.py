"""Host microseconds a query building the result: the program's
"vdb.table.project" span (Table.search: result rows, facets), over the
queries answered inside the traced window
(perfbench/spans.py: self time, the time of its child spans taken out)."""
from perfbench import spans


def read(ctx):
    return spans.per_query_us(ctx.tracer.prof, "vdb.table.project")
