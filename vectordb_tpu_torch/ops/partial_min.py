"""Fused distance + grouped partial-min scan (counterpart of
vectordb_tpu/ops/pallas_topk.py).

A [B, D] query block is scored against an [N, D] table one (query tile x
table tile) at a time and every table tile is folded, per query, to 128
groups that each keep their best AND second-best (score, global row): only
[B, 2N/fold] survivors leave the scan, never the [B, N] score matrix. A
cheap exact top-k over the survivors finishes the selection; a third top-k
hit co-located in one group is the only possible loss.

The survivor layout is the TPU kernel's, exactly: table tiles of
TC = pick_tile_c(D) rows, fold = TC/128 stripes per tile, row j of a tile in
group j mod 128, survivor column t*128 + lane for tile t, best plane first
and second plane after it, ties kept by the earlier stripe.

`partial_min_scan` launches the hand-written CUDA kernel
(csrc/partial_min.cu: bf16 on the tensor cores, f32 on the CUDA cores) for
CUDA tensors and runs `partial_min_scan_ref`, its plain PyTorch version, for
CPU tensors. Both score a row as the metric's base score plus
`column_term`, which folds |x|^2 (L2), n_valid and the mask into one [N]
vector. `scan_cost` gives the scan's FLOPs and bytes for its bound. One
divergence from the TPU kernel is deliberate: with exclude_self it masks
row q_base + i for query i of the whole batch, where the TPU kernel masks
q_base + (i mod 128) in every 128-query tile (correct only when B == 128).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..schema import MetricType

GROUP = 64       # columns folded into one survivor at D <= 256
TILE_Q = 128     # query rows per tile (the batch must be a multiple)
TILE_C = 8192    # table rows per tile at D <= 256

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W): the
# bound of a kernel is the larger of its FLOPs at the bf16 tensor-core rate
# and its bytes at the HBM rate.
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12

# Kernel launches since the last reset (CPU calls of the plain version are
# not counted): a run reads it to show the main path went through the kernel.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def pick_tile_c(d: int) -> int:
    """Table-tile rows. The TPU sized them to its vector memory; the port
    keeps the same tiles so the survivor layout (and the width gates that
    depend on it) stays identical."""
    if d <= 256:
        return 8192
    if d <= 512:
        return 4096
    return 2048


def supports(n_pad: int, dim_padded: int, b: int,
             tile_q: int = TILE_Q, tile_c: int = 0) -> bool:
    if tile_c <= 0:
        tile_c = pick_tile_c(dim_padded)
    return (n_pad % tile_c == 0 and b % tile_q == 0
            and dim_padded % 128 == 0)


def survivor_width(n_pad: int, dim_padded: int) -> int:
    """Columns of the scan's output: best + second-best per fold group."""
    return 2 * (n_pad // (pick_tile_c(dim_padded) // 128))


def column_term(norms: torch.Tensor, mask: Optional[torch.Tensor],
                n_valid: int, metric: int) -> torch.Tensor:
    """[N] f32 term added to every query's base score of a row: |x|^2 for
    L2 and 0 for cosine and dot, +inf where the row is excluded (row >=
    n_valid, or mask == 0). One add then applies the norm, n_valid and the
    mask, in the kernel as in the plain version."""
    n = norms.shape[0]
    dev = norms.device
    bad = torch.arange(n, device=dev) >= n_valid
    if mask is not None:
        bad |= mask.reshape(n).to(dev) == 0
    base = (norms.float() if metric == int(MetricType.EUCLIDEAN)
            else torch.zeros(n, dtype=torch.float32, device=dev))
    return base.masked_fill(bad, float("inf")).contiguous()


def scan_cost(b: int, n: int, d: int, tile_c: int = 0,
              itemsize: int = 2) -> Tuple[int, int]:
    """(FLOPs, bytes) of one scan of B queries against N rows of D dims:
    2*B*N*D for the product, and each byte counted once: queries and table
    (`itemsize` bytes an element), q_norms, norms and mask (f32), and the
    four [B, N/fold] survivor planes (f32 values, int32 ids). The TPU
    kernel's cost_estimate counts the table once per 128-query tile; a
    bound counts what the function must move."""
    if tile_c <= 0:
        tile_c = pick_tile_c(d)
    gcols = n // (tile_c // 128)
    flops = 2 * b * n * d
    nbytes = ((b + n) * d * itemsize + b * 4 + 2 * n * 4
              + 2 * b * gcols * (4 + 4))
    return flops, nbytes


def bound_ms(flops: float, nbytes: float) -> Tuple[float, str]:
    """Least time (ms) one H100 could take for `flops` bf16 tensor-core
    FLOPs and `nbytes` of HBM traffic, and which of the two bounds it."""
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_kernel_args(queries: torch.Tensor, table: torch.Tensor,
                      q_norms: torch.Tensor, norms: torch.Tensor) -> None:
    """Raises on what the kernel does not take: a table neither bf16 nor
    f32, queries in another dtype or width, D not a multiple of 64 (bf16:
    one TMA box) or 32 (f32), B not a multiple of 128 (bf16) or 64 (f32),
    q_norms not [B] or norms not [N]. Plain code: the CPU tests call it."""
    b, d = queries.shape
    n = table.shape[0]
    if table.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"partial_min kernel takes bf16 or f32 tables, "
                        f"got {table.dtype}")
    if queries.dtype != table.dtype:
        raise TypeError(f"queries ({queries.dtype}) must be in the table's "
                        f"dtype ({table.dtype})")
    dm, bm = (64, 128) if table.dtype == torch.bfloat16 else (32, 64)
    if table.shape[1] != d or d % dm != 0 or b % bm != 0:
        raise ValueError(f"partial_min kernel ({table.dtype}) needs D % {dm}"
                         f" == 0 and B % {bm} == 0, got D={d}, B={b}")
    if tuple(q_norms.shape) != (b,) or tuple(norms.shape) != (n,):
        raise ValueError("partial_min kernel: q_norms must be [B] and "
                         "norms [N]")


def partial_min_scan(queries: torch.Tensor, q_norms: torch.Tensor,
                     q_base: int, table: torch.Tensor, norms: torch.Tensor,
                     metric: int, group: int = GROUP, n_valid: int = 0,
                     exclude_self: bool = False, tile_q: int = TILE_Q,
                     tile_c: int = 0, mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, D] queries vs [N, D] table -> ([B, 2*N/fold] f32 survivor
    scores, int32 global rows). queries are in the table's dtype (bf16 or
    f32); q_norms [B] f32 squared query norms (from the f32 queries);
    norms [N] f32 squared row norms; mask optional [N] (0 = excluded row).
    B % tile_q == 0 and N % tile_c == 0 are required (callers pad). `group`
    is accepted for signature parity; the fold follows from tile_c."""
    b, d = queries.shape
    n = table.shape[0]
    if tile_c <= 0:
        tile_c = pick_tile_c(d)
    if b % tile_q != 0 or n % tile_c != 0 or tile_c % 128 != 0:
        raise ValueError(f"partial_min_scan: B={b} must be a multiple of "
                         f"{tile_q} and N={n} of tile_c={tile_c}")
    if mask is None:
        mask = torch.ones(n, dtype=torch.float32, device=table.device)
    if table.device.type == "cpu":
        return partial_min_scan_ref(queries, q_norms, q_base, table, norms,
                                    metric, n_valid, exclude_self, tile_c,
                                    mask)
    return _launch(queries, q_norms, int(q_base), table, norms, int(metric),
                   int(n_valid), bool(exclude_self), tile_c, mask)


def partial_min_scan_ref(queries: torch.Tensor, q_norms: torch.Tensor,
                         q_base: int, table: torch.Tensor,
                         norms: torch.Tensor, metric: int, n_valid: int = 0,
                         exclude_self: bool = False, tile_c: int = 0,
                         mask: Optional[torch.Tensor] = None,
                         chunk: int = 1024
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the scan, same output bit layout. Scores
    come from an f32 matmul of the upcast operands (bf16 products are exact
    in f32; TF32 stays off), so the kernel and this version differ only in
    summation order. A score is the metric's base score (|q|^2 - 2 q.x,
    1 - q.x or -q.x) plus column_term, in the kernel's order. Queries go in
    chunks so the [chunk, N] score block bounds memory."""
    b, d = queries.shape
    n = table.shape[0]
    dev = table.device
    if tile_c <= 0:
        tile_c = pick_tile_c(d)
    fold = tile_c // 128
    tiles = n // tile_c
    tab = table.float()
    term = column_term(norms, mask, n_valid, metric)
    stripe = torch.arange(fold, dtype=torch.int32, device=dev).view(
        1, 1, fold, 1)
    # Global row of (tile t, lane) in stripe 0; stripe s adds s*128.
    base = (torch.arange(tiles, device=dev).view(tiles, 1) * tile_c
            + torch.arange(128, device=dev).view(1, 128)).to(torch.int32)
    vals = torch.empty((b, 2 * tiles * 128), dtype=torch.float32, device=dev)
    ids = torch.empty((b, 2 * tiles * 128), dtype=torch.int32, device=dev)
    for s in range(0, b, chunk):
        e = min(s + chunk, b)
        q = queries[s:e].float()
        ip = q @ tab.T
        if metric == int(MetricType.EUCLIDEAN):
            sc = q_norms[s:e].float()[:, None] - 2.0 * ip
        elif metric == int(MetricType.COSINE):
            sc = 1.0 - ip
        else:
            sc = -ip
        sc += term[None, :]
        if exclude_self:
            rows = int(q_base) + torch.arange(s, e, device=dev)
            hit = (rows >= 0) & (rows < n)
            sc[torch.arange(e - s, device=dev)[hit], rows[hit]] = float("inf")
        v = sc.view(e - s, tiles, fold, 128)
        # Best: the minimum, kept by its first stripe (strict < in order).
        m1 = v.amin(dim=2, keepdim=True)
        k1 = torch.where(v == m1, stripe, fold).amin(dim=2, keepdim=True)
        # Second: the same over the other stripes. Where all of them are
        # +inf every stripe ties and stripe 0 wins, which is also the
        # sequential fold's initial second-best id.
        v2 = v.scatter(2, k1.long(), float("inf"))
        m2 = v2.amin(dim=2, keepdim=True)
        k2 = torch.where(v2 == m2, stripe, fold).amin(dim=2, keepdim=True)
        w = tiles * 128
        vals[s:e, :w] = m1.reshape(e - s, w)
        vals[s:e, w:] = m2.reshape(e - s, w)
        ids[s:e, :w] = (base + k1.view(e - s, tiles, 128) * 128).reshape(
            e - s, w)
        ids[s:e, w:] = (base + k2.view(e - s, tiles, 128) * 128).reshape(
            e - s, w)
    return vals, ids


def _launch(queries, q_norms, q_base, table, norms, metric, n_valid,
            exclude_self, tile_c, mask):
    global launches
    from .. import _cuda_build

    b, d = queries.shape
    n = table.shape[0]
    check_kernel_args(queries, table, q_norms, norms)
    dev = table.device
    q_norms = q_norms.to(device=dev, dtype=torch.float32).contiguous()
    norms = norms.to(device=dev, dtype=torch.float32).contiguous()
    mask = mask.to(device=dev, dtype=torch.float32).reshape(n).contiguous()
    term = column_term(norms, mask, n_valid, metric)
    queries = queries.contiguous()
    table = table.contiguous()
    for name, t in (("queries", queries), ("table", table)):
        if t.device != dev or t.data_ptr() % 16 != 0:
            raise ValueError(f"partial_min kernel: {name} must be a "
                             f"16-byte aligned tensor on {dev}")
    gcols = n // (tile_c // 128)
    vals = torch.empty((b, 2 * gcols), dtype=torch.float32, device=dev)
    ids = torch.empty((b, 2 * gcols), dtype=torch.int32, device=dev)
    lib = _cuda_build.load("partial_min")
    fn = lib.vdb_partial_min
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(queries.data_ptr(), q_norms.data_ptr(), table.data_ptr(),
                norms.data_ptr(), mask.data_ptr(), term.data_ptr(),
                vals.data_ptr(), ids.data_ptr(), b, n, d, tile_c, n_valid,
                metric, int(exclude_self), q_base,
                int(table.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"partial_min kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return vals, ids


def fused_topk(queries: torch.Tensor, q_norms: torch.Tensor, q_base: int,
               table: torch.Tensor, norms: torch.Tensor, metric: int,
               k: int, group: int = GROUP, n_valid: int = 0,
               exclude_self: bool = False,
               mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial-min scan + exact top-k over the survivors: (dists [B, k] f32
    ascending, ids [B, k] int32). Callers that need exact rankings re-rank
    the survivors in f32."""
    vals, ids = partial_min_scan(queries, q_norms, q_base, table, norms,
                                 metric, group, n_valid, exclude_self,
                                 mask=mask)
    k = min(k, vals.shape[1])
    d, sel = torch.topk(vals, k, dim=1, largest=False, sorted=True)
    return d, torch.gather(ids, 1, sel)
