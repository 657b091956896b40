"""The filtered scan by ids: distances of a query batch to the rows of a
device table named by an int32 id list (a device filter's kept rows,
expr/device.DeviceFilter.kept_ids), for ops/flat.id_topk.

`id_scan` launches the hand-written CUDA kernel (csrc/id_scan.cu) for CUDA
tensors and runs `id_scan_ref`, its plain PyTorch version, for CPU tensors;
a CUDA tensor the kernel does not take raises. Both give the full-table
scan's numbers (ops/flat._scores) for the rows they score: the queries
rounded to the table's dtype, products and sums in f32 (TF32 off), squared
L2 as (|q|^2 - 2 q.x) + |x|^2 with |q|^2 of the rounded query, cosine
1 - q.x, dot -q.x; the kernel differs only in the order of its sums.
`id_scan_cost` gives the bytes that bound it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..schema import MetricType

# Kernel launches since the last reset (CPU calls of the plain version are
# not counted): a run reads it to show the filtered scan went through the
# kernel.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def id_scan_cost(b: int, m: int, d: int, itemsize: int = 2,
                 l2: bool = False) -> int:
    """Bytes one scan of b queries over m rows of d columns moves, each
    once: the rows (`itemsize` bytes an element) and the f32 queries, the
    int32 ids, the f32 scores written and, for L2, the rows' f32 norms."""
    return m * d * itemsize + 4 * b * d + 4 * m + 4 * b * m + (4 * m if l2
                                                               else 0)


def id_scan(queries: torch.Tensor, table: torch.Tensor,
            norms: Optional[torch.Tensor], ids: torch.Tensor,
            metric: int) -> torch.Tensor:
    """[B, D] f32 queries against the rows `ids` ([m] int32) of an [N, D]
    bf16 or f32 table -> [B, m] f32 distances (column r: row ids[r]).
    norms: [N] f32 squared row norms, read for EUCLIDEAN only."""
    if table.device.type == "cpu":
        return id_scan_ref(queries, table, norms, ids, metric)
    return _launch(queries, table, norms, ids, int(metric))


def id_scan_ref(queries: torch.Tensor, table: torch.Tensor,
                norms: Optional[torch.Tensor], ids: torch.Tensor,
                metric: int) -> torch.Tensor:
    """Plain PyTorch version: the kept rows gathered and widened
    (`table[ids].float()`), scored against the rounded queries."""
    rows = ids.long()
    q = queries.to(table.dtype).float()
    ip = q @ table[rows].float().T
    if metric == int(MetricType.EUCLIDEAN):
        qn = (q * q).sum(dim=1, keepdim=True)
        return qn - 2.0 * ip + norms[rows].float()[None, :]
    if metric == int(MetricType.COSINE):
        return 1.0 - ip
    return -ip


def check_kernel_args(queries: torch.Tensor, table: torch.Tensor,
                      norms: Optional[torch.Tensor], ids: torch.Tensor,
                      metric: int) -> None:
    """Raises on what the kernel does not take: a table neither bf16 nor
    f32, queries not f32, ids not int32, a shape other than [B, D] / [N, D]
    / [m] (/ [N] norms for EUCLIDEAN), D not a multiple of one 16-byte load
    (8 bf16 or 4 f32), a tensor that is not contiguous and on the table's
    CUDA device, or a table or queries not 16-byte aligned (the kernel's
    loads). Plain code: the CPU tests call it."""
    if table.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"id_scan kernel takes bf16 or f32 tables, got "
                        f"{table.dtype}")
    if queries.dtype != torch.float32:
        raise TypeError(f"id_scan kernel takes f32 queries, got "
                        f"{queries.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"id_scan kernel takes int32 ids, got {ids.dtype}")
    if table.dim() != 2 or queries.dim() != 2 or ids.dim() != 1:
        raise ValueError("id_scan kernel: queries must be [B, D], table "
                         "[N, D] and ids [m]")
    d = table.shape[1]
    step = 8 if table.dtype == torch.bfloat16 else 4
    if queries.shape[1] != d or d % step != 0:
        raise ValueError(f"id_scan kernel ({table.dtype}) needs queries of "
                         f"the table's width D, D % {step} == 0; got "
                         f"{tuple(queries.shape)} against D={d}")
    tensors = {"queries": queries, "table": table, "ids": ids}
    if metric == int(MetricType.EUCLIDEAN):
        if (norms is None or norms.dtype != torch.float32
                or tuple(norms.shape) != (table.shape[0],)):
            raise ValueError("id_scan kernel: EUCLIDEAN needs [N] f32 norms")
        tensors["norms"] = norms
    for name, t in tensors.items():
        if (t.device != table.device or t.device.type != "cuda"
                or not t.is_contiguous()):
            raise ValueError(f"id_scan kernel: {name} must be a contiguous "
                             f"tensor on the table's CUDA device "
                             f"({table.device}), got {t.device}")
        if name in ("queries", "table") and t.data_ptr() % 16 != 0:
            raise ValueError(f"id_scan kernel: {name} must be 16-byte "
                             f"aligned")


@functools.lru_cache(maxsize=None)
def _kernel():
    """vdb_id_scan of the id_scan library (built on first use), typed."""
    from .. import _cuda_build

    fn = _cuda_build.load("id_scan").vdb_id_scan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    return fn


def _launch(queries, table, norms, ids, metric):
    global launches
    check_kernel_args(queries, table, norms, ids, metric)
    b, d = queries.shape
    m = ids.shape[0]
    dev = table.device
    out = torch.empty((b, m), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    fn = _kernel()
    l2 = metric == int(MetricType.EUCLIDEAN)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(table.data_ptr(), ids.data_ptr(), queries.data_ptr(),
                norms.data_ptr() if l2 else None, out.data_ptr(), b, m, d,
                metric, int(table.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"id_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
