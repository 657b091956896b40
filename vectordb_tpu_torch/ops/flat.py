"""Flat (brute-force) distance scan + top-k in PyTorch (counterpart of
vectordb_tpu/ops/flat.py).

A batch of queries is scored against the whole device table with the
deleted/filter mask folded in, then the top-k is selected; large B x N
products stream the table in chunks with a running top-k so the [B, N]
distance matrix stays bounded. The flat-serve program (flat_serve_grouped)
replaces the score matrix with the partial-min scan of ops/partial_min.
id_topk scores only the rows of an id list (a device filter's kept rows)
through ops/id_scan, whose CUDA kernel reads each of them once.

Distance conventions match the reference dispatch (db/index/index.cpp):
  EUCLIDEAN   -> squared L2
  COSINE      -> 1 - inner_product (vectors normalized at ingest)
  DOT_PRODUCT -> -inner_product
All three are "smaller is better".

Scores are always f32: bf16 operands are upcast before the matmul (their
products are exact in f32), and TF32 is off (see _device.py), so a score
differs from an exact f32 sum only by summation order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..schema import MetricType
from . import id_scan, partial_min, qwire

# Rows per streamed chunk of the running-top-k scan.
DEFAULT_CHUNK = 8192
# Single matmul + top-k whenever the [B, N] score matrix is at most 1 GB of
# f32; larger products take the chunked scan.
SINGLE_PASS_MAX_ELEMS = 1 << 28

_INF = float("inf")


def _scores(q: torch.Tensor, tab: torch.Tensor,
            norms: Optional[torch.Tensor], metric: int) -> torch.Tensor:
    """[B, D] x [chunk, D] -> [B, chunk] f32 distance block."""
    qf = q.float()
    ip = qf @ tab.float().T
    if metric == int(MetricType.EUCLIDEAN):
        qn = (qf * qf).sum(dim=1, keepdim=True)
        return qn - 2.0 * ip + norms[None, :]
    if metric == int(MetricType.COSINE):
        return 1.0 - ip
    return -ip  # DOT_PRODUCT


def _smallest(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ascending k smallest per row: (values, column indices)."""
    return torch.topk(d, k, dim=1, largest=False, sorted=True)


def _flat_topk_scan(q, table, norms, mask, metric: int, k: int, chunk: int):
    """Streamed scan over row chunks, carrying a running top-k."""
    b = q.shape[0]
    dev = table.device
    best_d = torch.full((b, k), _INF, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for base in range(0, table.shape[0], chunk):
        nrm = None
        if metric == int(MetricType.EUCLIDEAN):
            nrm = (norms[base:base + chunk] if norms is not None else
                   torch.zeros(chunk, dtype=torch.float32, device=dev))
        d = _scores(q, table[base:base + chunk], nrm, metric)
        d = d.masked_fill(~mask[None, base:base + chunk], _INF)
        ids = base + torch.arange(chunk, device=dev).expand(b, chunk)
        all_d = torch.cat([best_d, d], dim=1)
        all_i = torch.cat([best_i, ids], dim=1)
        best_d, sel = _smallest(all_d, k)
        best_i = torch.gather(all_i, 1, sel)
    return best_d, best_i.to(torch.int32)


def _flat_topk_single(q, table, norms, mask, metric: int, k: int):
    d = _scores(q, table, norms, metric)
    d = d.masked_fill(~mask[None, :], _INF)
    vals, ids = _smallest(d, k)
    return vals, ids.to(torch.int32)


def flat_topk(queries: torch.Tensor, table: torch.Tensor,
              norms: Optional[torch.Tensor], mask: torch.Tensor,
              metric: MetricType, k: int, chunk: int = DEFAULT_CHUNK
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked distance + top-k over an [N, D] device table.

    queries: [B, D] (cast to the table dtype first, like the TPU path)
    table:   [N, D] device-resident
    norms:   [N] f32 squared row norms (EUCLIDEAN only; None otherwise)
    mask:    [N] bool — False rows (deleted / filtered / padding) are +inf
    Returns (distances [B, k] f32 ascending, ids [B, k] int32). Masked-out
    slots have distance +inf (the single pass keeps arbitrary ids there,
    the scan -1); callers drop non-finite entries.
    """
    n = table.shape[0]
    k = min(k, n)
    q = queries.to(table.dtype)
    mask = mask.bool()
    if q.shape[0] * n <= SINGLE_PASS_MAX_ELEMS or n % chunk != 0:
        return _flat_topk_single(q, table, norms, mask, int(metric), k)
    return _flat_topk_scan(q, table, norms, mask, int(metric), k, chunk)


def id_topk(queries: torch.Tensor, table: torch.Tensor,
            norms: Optional[torch.Tensor], ids: torch.Tensor,
            metric: MetricType, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """flat_topk over the rows `ids` alone: the filtered scan by ids.

    queries: [B, D] f32 (rounded to the table dtype by the scan, as
             flat_topk rounds them)
    table:   [N, D] device-resident; norms [N] f32 (EUCLIDEAN only)
    ids:     [m] int32 rows to score (a device filter's kept rows)
    The distances come from ops/id_scan (the kernel on the card), the k
    smallest from torch.topk, mapped back through `ids`; a [B, m] block
    past SINGLE_PASS_MAX_ELEMS goes in slices of ids with a running top-k.
    Returns (distances [B, k] f32 ascending, ids [B, k] int32), k =
    min(k, N) as flat_topk's; slots past the m rows are +inf with id -1.
    """
    b = queries.shape[0]
    k = min(k, table.shape[0])
    step = max(SINGLE_PASS_MAX_ELEMS // max(b, 1), 1)
    best_d = best_i = None
    for s in range(0, ids.shape[0], step):
        part = ids[s:s + step]
        d = id_scan.id_scan(queries, table, norms, part, int(metric))
        cand = part.expand(b, -1)
        if best_d is not None:
            d = torch.cat([best_d, d], dim=1)
            cand = torch.cat([best_i, cand], dim=1)
        best_d, sel = _smallest(d, min(k, d.shape[1]))
        best_i = torch.gather(cand, 1, sel)
    have = 0 if best_d is None else best_d.shape[1]
    if have < k:
        dev = table.device
        pad_d = torch.full((b, k - have), _INF, dtype=torch.float32,
                           device=dev)
        pad_i = torch.full((b, k - have), -1, dtype=torch.int32, device=dev)
        if best_d is None:
            return pad_d, pad_i
        best_d = torch.cat([best_d, pad_d], dim=1)
        best_i = torch.cat([best_i, pad_i], dim=1)
    return best_d, best_i


# Survivor slack for the flat-serve path: re-rank the top (k + slack)
# survivors so bf16 score quantization near the k-boundary never costs a
# true neighbor.
FLAT_SERVE_SLACK = 32


def flat_serve_grouped(q_flat: torch.Tensor, table: torch.Tensor,
                       norms: torch.Tensor, mask: torch.Tensor,
                       table_f32: Optional[torch.Tensor], metric: int,
                       k_cand: int, k_out: int, n_valid: int,
                       use_pallas: bool = True, pack_out: bool = True,
                       wire: str = "f32"):
    """Throughput flat serving: a [G*B, Dp] f32 query block against the
    whole device table.

      0. the query wire's rounding (ops/qwire.apply_wire; "f32" leaves the
         queries as they are): steps 1 and 2 score the wire's values.
      1. partial-min scan (ops/partial_min: the CUDA kernel on the card) —
         [GB, 2N/fold] survivors, scores never stored. use_pallas=False:
         the full masked score matrix instead (CPU / small tables).
      2. exact top-k_cand over the survivors.
      3. exact f32 re-rank of the candidates against the f32 queries
         (beam._exact_rerank_device) -> top-k_out with exact distances;
         skipped when table_f32 is None (the candidates go to the host
         re-rank). The JAX package re-ranks against the wire's values.
      4. optional packed int32 wire ([GB, 2w]: f32 distance bits in [:w],
         ids in [w:]; see beam.unpack_wire).

    mask: [N_pad] bool/f32 validity x filter mask (0 = excluded); n_valid:
    the kernel's row bound (the device capacity — the mask already
    excludes rows past record_number). The name use_pallas is kept from
    the TPU package: True selects the partial-min scan.
    """
    qf32 = qwire.apply_wire(q_flat.float(), wire)
    qs = qf32.to(table.dtype)
    if use_pallas:
        q_norms = (qf32 * qf32).sum(dim=1)
        vals, vids = partial_min.partial_min_scan(
            qs, q_norms, 0, table, norms, metric, n_valid=n_valid,
            mask=mask.float())
    else:
        d = _scores(qs, table,
                    norms if metric == int(MetricType.EUCLIDEAN) else None,
                    metric)
        vals = d.masked_fill(~mask.bool()[None, :], _INF)
        vids = None  # column index == table row
    kc = min(k_cand, vals.shape[1])
    cd, sel = _smallest(vals, kc)
    cids = sel if vids is None else torch.gather(vids, 1, sel)
    cids = torch.where(torch.isfinite(cd), cids, -1).to(torch.int32)
    if table_f32 is not None:
        from . import beam as beam_ops
        d_out, i_out = beam_ops._exact_rerank_device(
            q_flat.float(), table_f32, cd, cids, metric, min(k_out, kc))
    else:
        d_out, i_out = cd, cids
    if pack_out:
        return torch.cat([d_out.contiguous().view(torch.int32), i_out],
                         dim=-1)
    return d_out, i_out


def flat_distances(queries: torch.Tensor, table: torch.Tensor,
                   norms: Optional[torch.Tensor],
                   metric: MetricType) -> torch.Tensor:
    """Unfused [B, N] distance matrix (small N / testing)."""
    return _scores(queries.to(table.dtype), table, norms, int(metric))


def exact_rerank(queries_f32: np.ndarray,
                 table_f32: np.ndarray,
                 ids: np.ndarray,
                 metric: MetricType) -> np.ndarray:
    """Host-side exact f32 re-scoring of candidate ids against the host
    source-of-truth copy, so reported @distance values and the final
    ranking are exact. ids may contain -1 (padded slots) -> distance +inf.
    """
    b, kk = ids.shape
    safe = np.clip(ids, 0, table_f32.shape[0] - 1)
    cand = table_f32[safe.reshape(-1)].reshape(b, kk, -1)
    q = queries_f32[:, None, :]
    if metric == MetricType.EUCLIDEAN:
        diff = cand - q
        d = np.einsum("bkd,bkd->bk", diff, diff, dtype=np.float32)
    else:
        # einsum broadcasts the [B, 1, D] query view — no [B, k, D]
        # materialized copy.
        ip = np.einsum("bkd,bod->bk", cand, q, dtype=np.float32)
        d = 1.0 - ip if metric == MetricType.COSINE else -ip
    d = np.where(ids < 0, np.inf, d)
    return d
