"""The sparse scorer's kernel (csrc/csr_ip.cu) against its roofline, in %:
the least time the card needs for the bytes a scoring must move, at the
H100's 3.35 TB/s (NVIDIA's data sheet, SXM part), over the kernel's time a
launch in the traced window. The bytes are fixed by the data: a frozen copy
of ops/sparse.csr_ip_cost (each counted once: the int32 index and f32 value
of every nnz, the int64 offsets, the query's f32 scatter up to its largest
term and a trailing zero, the f32 score of every row), averaged over the
queries answered in the trace."""

KERNELS = ("csr_ip_kernel",)
PEAK_BYTES_S = 3.35e12


def csr_ip_bytes(nnz: int, n_rows: int, len_q: int) -> int:
    return 8 * nnz + 8 * (n_rows + 1) + 4 * len_q + 4 * n_rows


def read(ctx):
    r = ctx.reading
    if r is None or "nnz" not in ctx.data["stats"] or not len(ctx.traced):
        return None
    t, launches = r.time_of(KERNELS), r.count_of(KERNELS)
    if t <= 0 or not launches:
        return None
    stats, queries = ctx.data["stats"], ctx.data["queries"]
    per = sum(csr_ip_bytes(stats["nnz"], stats["rows"],
                           max(queries[i]["indices"]) + 2)
              for i in ctx.window.pool[ctx.traced]) / len(ctx.traced)
    return 100.0 * per * launches / PEAK_BYTES_S / t
