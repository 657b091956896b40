"""The filtered scan against its roofline, in %: the least time the card
needs for the work an exact answer under the filter must do, over the
device's busy time a query answered in the traced window (the union of its
device intervals, perfbench/trace.py, over those queries).

The work is read from the data by the frozen filtered_scan_bytes, whatever
implements the scan: each row that the filter keeps (COLUMN >= THRESHOLD in
ctx.data["attributes"], VectorDBBench's 99% filter) read once as bfloat16,
two bytes a column, and the query's float32 values once, at the H100's
3.35 TB/s (NVIDIA's data sheet, SXM part). A scan of every row reads about
the kept share of its own bound; one of the kept rows alone can come near
100%, never above. Nothing where the program recorded no "vdb.table.filter"
span (no query was filtered, or a program without the span), where the
data has no such column, or where the trace holds no device time."""
from perfbench import spans

COLUMN = "doc_id"
THRESHOLD = 990000
PEAK_BYTES_S = 3.35e12
SPAN = "vdb.table.filter"


def filtered_scan_bytes(kept: int, dim: int) -> int:
    return 2 * kept * dim + 4 * dim


def read(ctx):
    r = ctx.reading
    attributes = ctx.data["attributes"]
    if r is None or r.busy_s <= 0 or COLUMN not in attributes:
        return None
    queries = int(ctx.window.nq[ctx.traced].sum())
    s = spans.read(ctx.tracer.prof)
    if not queries or s is None or SPAN not in s.self_ns:
        return None
    kept = int((attributes[COLUMN] >= THRESHOLD).sum())
    least_s = filtered_scan_bytes(kept, ctx.data["stats"]["dim"]) \
        / PEAK_BYTES_S
    return 100.0 * least_s / (r.busy_s / queries)
