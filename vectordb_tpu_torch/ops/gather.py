"""Random row gather (counterpart of benchmarks/gather_micro.py:pallas_gather
and of every `jnp.take(..., axis=0)` row gather in vectordb_tpu/ops/beam.py
and vectordb_tpu/index/graph.py).

`gather_rows(table, ids)` returns `table[clamp(ids, 0, N - 1)]` with shape
`ids.shape + table.shape[1:]`. The clamp is the `jnp.clip` every JAX caller
applies before its `jnp.take`, so callers pass raw ids (-1 padding included)
and mask the padded slots themselves. On a CUDA tensor it launches the
hand-written kernel csrc/gather_rows.cu; on a CPU tensor it runs
`gather_rows_ref`, the plain PyTorch version. Both take the same arguments
and raise on the same ones, and their outputs are bit-identical.
"""
from __future__ import annotations

import contextlib
import ctypes
import math

import torch

# Kernel launches since the last reset (CPU calls of the plain version are
# not counted): a run reads it to show the main path went through the kernel.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _row_bytes(table: torch.Tensor) -> int:
    return table.element_size() * math.prod(table.shape[1:])


def _check(table: torch.Tensor, ids: torch.Tensor) -> None:
    if ids.dtype != torch.int32:
        raise TypeError(f"gather_rows: ids must be int32, got {ids.dtype}")
    if table.dim() < 1 or table.shape[0] <= 0:
        raise ValueError("gather_rows: table must have at least one row")
    if not table.is_contiguous():
        raise ValueError("gather_rows: table must be contiguous")
    rb = _row_bytes(table)
    if rb <= 0 or rb % 4 != 0:
        raise ValueError(f"gather_rows: a table row must be a positive "
                         f"multiple of 4 bytes, got {rb}")
    if ids.device != table.device:
        raise ValueError(f"gather_rows: ids on {ids.device}, table on "
                         f"{table.device}")


def gather_cost(n_ids: int, row_bytes: int) -> int:
    """Bytes one gather must move, each counted once: the int32 ids read,
    the rows read, the rows written. A gather does no arithmetic, so its
    bound is these bytes at the HBM rate (partial_min.bound_ms(0, bytes))."""
    return n_ids * (4 + 2 * row_bytes)


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table [N, ...] (contiguous, row a multiple of 4 bytes), ids int32 of
    any shape -> table[clamp(ids, 0, N - 1)] of shape ids.shape +
    table.shape[1:]."""
    _check(table, ids)
    if table.device.type == "cpu":
        return gather_rows_ref(table, ids)
    return _launch(table, ids)


def gather_rows_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: index_select on the clamped ids."""
    flat = ids.reshape(-1).clamp(0, table.shape[0] - 1).long()
    return table.index_select(0, flat).reshape(
        tuple(ids.shape) + tuple(table.shape[1:]))


_kernel_fn = None


def _kernel():
    """The ctypes entry point of csrc/gather_rows.cu, built, loaded and
    typed once: traversal calls the gather hundreds of times a query."""
    global _kernel_fn
    if _kernel_fn is None:
        from .. import _cuda_build

        fn = _cuda_build.load("gather_rows").vdb_gather_rows
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [
            ctypes.c_void_p]
        _kernel_fn = fn
    return _kernel_fn


def _launch(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    global launches
    ids = ids.contiguous()
    out = torch.empty(tuple(ids.shape) + tuple(table.shape[1:]),
                      dtype=table.dtype, device=table.device)
    if ids.numel() == 0:
        return out
    fn = _kernel()
    dev = table.device
    ctx = (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
           else torch.cuda.device(dev))
    with ctx:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(),
                ids.numel(), table.shape[0], _row_bytes(table), stream)
    if rc != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return out
