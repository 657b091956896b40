"""Device kernels, copies and sets launched a query in the traced window
(the profiler's device events / the queries answered inside it)."""


def read(ctx):
    r = ctx.reading
    queries = int(ctx.window.nq[ctx.traced].sum())
    if r is None or not queries or not (r.kernels + r.copies):
        return None
    return (r.kernels + r.copies) / queries
