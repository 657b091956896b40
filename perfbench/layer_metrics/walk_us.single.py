"""Device microseconds a query in the beam walk: the time of the kernels of
csrc/beam_iter.cu (a block a query, or a warp a query) in the traced
window, over the queries answered inside it. Nothing where no such kernel
ran."""

KERNELS = ("beam_block_kernel", "beam_warp_kernel")


def read(ctx):
    r = ctx.reading
    queries = int(ctx.window.nq[ctx.traced].sum())
    if r is None or not queries or not r.count_of(KERNELS):
        return None
    return 1e6 * r.time_of(KERNELS) / queries
