"""Host microseconds a query launching the device's work: the program's
"vdb.table.dispatch" span (Table.dispatch_dense_search; the top of
Table._sparse_scan through its torch.topk), over the queries answered
inside the traced window
(perfbench/spans.py: self time, the time of its child spans taken out)."""
from perfbench import spans


def read(ctx):
    return spans.per_query_us(ctx.tracer.prof, "vdb.table.dispatch")
