"""Exact K-nearest-neighbour graph over a device table (counterpart of
vectordb_tpu/ops/knn.py).

The KNN graph is built by exact blocked distance products: each block of
`query_block` table rows is scored against the whole table and reduced to
its k nearest rows, self excluded. On a CUDA table that the partial-min
kernel tiles (capacity % 8192 == 0, block % 128 == 0) a block goes through
the fused partial-min scan (ops/partial_min, csrc/partial_min.cu) and an
exact top-k over its survivors, so the [block, N] score matrix never
reaches device memory; otherwise (`_knn_block`) it is scored chunk by chunk
with an exact `torch.topk` per chunk and one exact merge.

Divergences from the JAX package, on purpose:
  - `_knn_block` selects with exact `torch.topk` where the JAX package uses
    `lax.approx_max_k` (exact on the CPU, approximate on the TPU).
  - The port's partial-min kernel masks row q_base + i for query i of the
    whole block. The TPU kernel masks q_base + (i mod 128) in every
    128-query tile (pallas_topk.py:87-90), so with the 1,024-query KNN
    blocks a TPU-built graph keeps self-edges in 7 of 8 query tiles (and
    loses one true neighbour there); a graph built by the port has none.
  - Blocks run as a plain loop: the JAX package groups 16 blocks per
    dispatch only to amortise its relay's per-dispatch cost.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..schema import MetricType
from . import partial_min

# Rows scored per block (queries) and per score chunk (table).
DEFAULT_QUERY_BLOCK = 1024
DEFAULT_CHUNK = 16384


def _scores(q: torch.Tensor, tab: torch.Tensor, q_norms: torch.Tensor,
            t_norms: torch.Tensor, metric: int) -> torch.Tensor:
    """[B, D] x [C, D] -> [B, C] f32 distances. Operands are upcast to f32
    first: bf16 products are exact in f32 (TF32 is off), as the JAX
    package's f32-accumulating dot_general."""
    ip = q.float() @ tab.float().T
    if metric == int(MetricType.EUCLIDEAN):
        return q_norms[:, None] - 2.0 * ip + t_norms[None, :]
    if metric == int(MetricType.COSINE):
        return 1.0 - ip
    return -ip


def _knn_block(q_base: int, table: torch.Tensor, t_norms: torch.Tensor,
               n_valid: int, metric: int, k: int, chunk: int, block: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the whole table for rows [q_base, q_base + block),
    self excluded: per-chunk top-k, then one exact merge. Returns
    (dists [block, k] f32 ascending, ids [block, k] int32)."""
    n_pad, dev = table.shape[0], table.device
    q = table[q_base:q_base + block]
    q_norms = t_norms[q_base:q_base + block]
    self_ids = q_base + torch.arange(block, device=dev)[:, None]
    parts_d, parts_i = [], []
    for base in range(0, n_pad, chunk):
        d = _scores(q, table[base:base + chunk], q_norms,
                    t_norms[base:base + chunk], metric)
        ids = base + torch.arange(d.shape[1], device=dev)[None, :]
        d = d.masked_fill((ids >= n_valid) | (ids == self_ids), float("inf"))
        top_d, top_i = torch.topk(d, min(k, d.shape[1]), dim=1,
                                  largest=False, sorted=True)
        parts_d.append(top_d)
        parts_i.append(top_i + base)
    all_d = torch.cat(parts_d, dim=1)
    all_i = torch.cat(parts_i, dim=1)
    d, sel = torch.topk(all_d, k, dim=1, largest=False, sorted=True)
    return d, torch.gather(all_i, 1, sel).to(torch.int32)


def _fused_knn_block(q_base: int, table: torch.Tensor, norms: torch.Tensor,
                     n_valid: int, metric: int, k: int, block: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block through the partial-min scan (exclude_self, n_valid) and
    an exact top-k over its survivors (ops/partial_min.fused_topk): the
    kernel on a CUDA table, its plain version on a CPU one."""
    return partial_min.fused_topk(
        table[q_base:q_base + block], norms[q_base:q_base + block], q_base,
        table, norms, metric, k, n_valid=n_valid, exclude_self=True)


def uses_partial_min(table: torch.Tensor, query_block: int) -> bool:
    """Route of exact_knn: the partial-min scan on a CUDA table that the
    kernel tiles, where the JAX package takes its Pallas kernel."""
    return (table.is_cuda
            and partial_min.supports(table.shape[0], table.shape[1],
                                     partial_min.TILE_Q)
            and query_block % partial_min.TILE_Q == 0)


def exact_knn(table: torch.Tensor, norms: torch.Tensor, n: int, k: int,
              metric: MetricType, query_block: int = DEFAULT_QUERY_BLOCK,
              chunk: int = DEFAULT_CHUNK
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KNN graph over rows [0, n) of a device table [N_pad, D].

    Returns device tensors (ids [n_blocks * query_block, k] int32, dists
    f32) covering at least rows [0, n), neighbours ascending by distance,
    self excluded. Every block has the same shape: the last one starts at
    N_pad - block when it would run past the table, and the rows it
    repeats are dropped.
    """
    n_pad = table.shape[0]
    chunk = min(chunk, n_pad)
    if n_pad % chunk != 0:
        chunk = n_pad  # single chunk for small pads
    k = min(k, max(n - 1, 1))
    query_block = min(query_block, n_pad)
    fused = uses_partial_min(table, query_block)
    parts_d, parts_i = [], []
    for start in range(0, n_pad, query_block):
        if start >= n:
            break
        real_start = min(start, n_pad - query_block)
        if fused:
            d, ids = _fused_knn_block(real_start, table, norms, n,
                                      int(metric), k, query_block)
        else:
            d, ids = _knn_block(real_start, table, norms, n, int(metric), k,
                                chunk, query_block)
        if real_start != start:
            d, ids = d[start - real_start:], ids[start - real_start:]
        parts_d.append(d)
        parts_i.append(ids)
    return torch.cat(parts_i, dim=0), torch.cat(parts_d, dim=0)
