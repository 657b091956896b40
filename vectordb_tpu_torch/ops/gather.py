"""Random row gather (counterpart of benchmarks/gather_micro.py:pallas_gather
and of every `jnp.take(..., axis=0)` row gather in vectordb_tpu/ops/beam.py
and vectordb_tpu/index/graph.py).

`gather_rows(table, ids)` returns `table[clamp(ids, 0, N - 1)]` with shape
`ids.shape + table.shape[1:]`. The clamp is the `jnp.clip` every JAX caller
applies before its `jnp.take`, so callers pass raw ids (-1 padding included)
and mask the padded slots themselves. On a CUDA table it calls the PyTorch
operator `torch.ops.vdb.gather_rows` (csrc/gather_rows_op.cpp), which checks
the arguments, allocates the output and launches the hand-written kernel
csrc/gather_rows.cu in C++; on a CPU table it runs `gather_rows_ref`, the
plain PyTorch version. Both raise TypeError for ids that are not int32 and
ValueError for the other arguments the kernel does not take, and their
outputs are bit-identical.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

# Kernel launches since the last reset (CPU calls of the plain version are
# not counted), in all and by the bytes of a table row: a run reads them to
# show the main path went through the kernel.
launches = 0
launches_by_row_bytes: Dict[int, int] = {}


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_row_bytes.clear()


def _row_bytes(table: torch.Tensor) -> int:
    return table.element_size() * math.prod(table.shape[1:])


def _check(table: torch.Tensor, ids: torch.Tensor) -> None:
    """The operator's checks, in Python."""
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


# The row widths the main path gathers, at the 1M-row traversal's sizes:
# (name, dtype, table shape, number of ids).
MAIN_PATH_SHAPES = (
    # Store rows; 2,048 queries x a compacted 96 candidates (ops/beam.py:213).
    ("bf16_store", torch.bfloat16, (1_048_576, 128), 196_608),
    # Fused-neighbour rows of 48 x 128 int8 (ops/beam.py:201).
    ("int8_fused", torch.int8, (1_048_576, 48 * 128), 8_192),
    # Adjacency rows of degree 48 (ops/beam.py:187).
    ("int32_adjacency", torch.int32, (1_048_576, 48), 8_192),
    # A shard's full adjacency rows of degree 64, which the sharded
    # traversal walks: 2,048 queries x 4 picks (parallel/engine.py).
    ("int32_shard_adjacency", torch.int32, (1_048_576, 64), 8_192),
    # f32 re-rank rows of one flat-serve program: 8,192 queries x k_cand 42
    # (ops/beam.py:284).
    ("f32_rerank", torch.float32, (262_144, 128), 344_064),
    # 4-byte scalars: norms, the valid mask (ops/beam.py:151,266).
    ("f32_scalar", torch.float32, (1_048_576,), 131_072),
    # int8 store rows of 128 that the build packs into the fused table:
    # 21,504 adjacency rows x degree 48 a launch (index/graph.py:460).
    ("int8_build", torch.int8, (1_048_576, 128), 1_032_192),
    # A sparse query's f32 scatter over BERT's 30,522-term vocabulary plus
    # its trailing zero, read at every stored index of a 1M-row column of
    # about 120 terms a row. The sparse scorer no longer takes this route
    # (ops/sparse.csr_ip reads the scatter in one pass with the products
    # and row sums); kept as the yardstick of the route it replaced.
    ("f32_query_scatter", torch.float32, (30_523,), 120_000_000),
    # Candidate rows of one group of the IVF KNN loop over a 3M-row store
    # (capacity 4,194,304): 32 tiles x 8 probed tiles x 1,024 rows
    # (ops/ivf.py, _probed_knn_group).
    ("bf16_ivf_candidates", torch.bfloat16, (4_194_304, 128), 262_144),
)


def gather_cost(n_ids: int, row_bytes: int) -> int:
    """Bytes one gather must move, each counted once: the int32 ids read,
    the rows read, the rows written. A gather does no arithmetic, so its
    bound is these bytes at the HBM rate (partial_min.bound_ms(0, bytes))."""
    return n_ids * (4 + 2 * row_bytes)


_op = None


def _operator():
    """torch.ops.vdb.gather_rows, its library built and registered on first
    use (_cuda_build raises, naming nvcc's output, if it fails)."""
    global _op
    if _op is None:
        from .. import _cuda_build

        _cuda_build.load_operator("gather_rows_op")
        _op = torch.ops.vdb.gather_rows.default
    return _op


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table [N, ...] (contiguous, row a multiple of 4 bytes), ids int32 of
    any shape -> table[clamp(ids, 0, N - 1)] of shape ids.shape +
    table.shape[1:]. Most calls gather a few kilobytes, so the CUDA route
    does nothing in Python but count."""
    global launches
    if table.is_cuda:
        out = (_op if _op is not None else _operator())(table, ids)
        n = ids.numel()
        if n:
            launches += 1
            rb = out.nbytes // n
            launches_by_row_bytes[rb] = launches_by_row_bytes.get(rb, 0) + 1
        return out
    if table.device.type != "cpu":
        raise ValueError(f"gather_rows: table on {table.device}; the kernel "
                         "takes CUDA tensors, the plain version CPU ones")
    _check(table, ids)
    return gather_rows_ref(table, ids)


def gather_rows_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: index_select on the clamped ids."""
    flat = ids.reshape(-1).clamp(0, table.shape[0] - 1).long()
    return table.index_select(0, flat).reshape(
        tuple(ids.shape) + tuple(table.shape[1:]))
