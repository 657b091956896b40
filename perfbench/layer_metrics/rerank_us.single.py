"""Host microseconds a query in the exact re-rank: the program's
"vdb.table.rerank" span (collect_dense_search's merges and
_rerank_candidates; the sparse merge-join distances and their sort), over
the queries answered inside the traced window
(perfbench/spans.py: self time, the time of its child spans taken out)."""
from perfbench import spans


def read(ctx):
    return spans.per_query_us(ctx.tracer.prof, "vdb.table.rerank")
