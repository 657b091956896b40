"""Host microseconds a query in the device filter's stage: the self time of
the program's "vdb.table.filter" spans (Table._search_ids: the lookup of the
compiled device filter; Table.dispatch_dense_search: the composed mask, its
match count and the selectivity gate's route), over the queries answered
inside the traced window (perfbench/spans.py: self time, the time of its
child spans taken out). Nothing from a program that records no such span,
or a window in which no query took a filter."""
from perfbench import spans

SPAN = "vdb.table.filter"


def read(ctx):
    s = spans.read(ctx.tracer.prof)
    return None if s is None or SPAN not in s.self_ns \
        else s.per_query_us(SPAN)
