"""Host microseconds a query in the host fold of a filter: the self time of
the program's "vdb.table.fold" spans (Table._search_ids: a filter that
does not compile to the device, such as a STRING comparison, evaluated on
the host over every row, AND-ed with the validity mask, its matches
counted and the selectivity gate's route picked), over the queries
answered inside the traced window (perfbench/spans.py: self time, the
time of its child spans taken out). Nothing from a program that records
no such span, or a window in which no query folded a filter."""
from perfbench import spans

SPAN = "vdb.table.fold"


def read(ctx):
    s = spans.read(ctx.tracer.prof)
    return None if s is None or SPAN not in s.self_ns \
        else s.per_query_us(SPAN)
