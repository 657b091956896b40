"""Sparse vector representation and distance math.

Mirrors the reference's sorted-coordinate sparse vectors and merge-join
distance functions (reference db/vector.{hpp,cpp}): a sparse
vector is a pair of parallel arrays (indices ascending, values), and
EUCLIDEAN / COSINE / DOT_PRODUCT distances follow the same conventions as
dense (squared L2; 1 - ip with ingest-time normalization; -ip).

Host numpy scores individual pairs (the exact re-rank of a sparse query's
candidates); SparseColumnIndex scores a query against every row of a
column on the engine's device: the CSR arrays are uploaded once per
snapshot, each query uploads its dense scatter, and `csr_ip` reads the
scatter at every stored index and sums each row's products in one pass:
on a CUDA tensor the hand-written kernel csrc/csr_ip.cu through the
PyTorch operator `torch.ops.vdb.csr_ip` (csrc/csr_ip_op.cpp), on a CPU
tensor `csr_ip_ref`, its plain version (clamp, gather, multiply,
torch.segment_reduce).

Divergences from the JAX package, on purpose:
- JAX sums a row's products as the difference of one f32 prefix sum over
  the whole column at the row's boundaries
  (vectordb_tpu/ops/sparse.py:85-109). That sum drifts with the column's
  nnz (a max absolute error of 0.63 against a float64 row sum at 17.5M
  nnz, where the largest inner product was 80.4), which the exact re-rank
  of k + 32 candidates hides only while the drift stays below the gaps
  between scores. The port sums each row's own products, so the error of
  a row is that of its ~nnz-per-row f32 additions.
- The device row offsets are int64, where JAX casts them to int32
  (vectordb_tpu/ops/sparse.py:168), so a column of 2^31 nnz or more (17 GB
  of CSR, which fits on the card) would wrap silently; the kernel reads
  int64 offsets, and the limit is gone.
Not ported, as TPU workarounds: the power-of-two bucket padding of the CSR
arrays and of the query scatter.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .._device import default_device
from ..schema import MetricType
from .gather import gather_rows_ref


@dataclass
class SparseVector:
    indices: np.ndarray  # int64, strictly ascending
    values: np.ndarray   # float32

    @staticmethod
    def from_json(obj: Dict) -> "SparseVector":
        idx = np.asarray(obj.get("indices", []), dtype=np.int64)
        val = np.asarray(obj.get("values", []), dtype=np.float32)
        return SparseVector(idx, val)

    def to_json(self) -> Dict:
        return {"indices": self.indices.tolist(),
                "values": [float(v) for v in self.values]}

    def norm_sq(self) -> float:
        return float(np.dot(self.values, self.values))

    def normalized(self) -> "SparseVector":
        s = self.norm_sq()
        if s > 1e-10:
            return SparseVector(self.indices, self.values / np.float32(np.sqrt(s)))
        return self


def inner_product(a: SparseVector, b: SparseVector) -> float:
    """Merge-join IP (reference vector.cpp:7-25)."""
    ia = np.searchsorted(a.indices, b.indices)
    ia = np.clip(ia, 0, len(a.indices) - 1) if len(a.indices) else ia
    if len(a.indices) == 0 or len(b.indices) == 0:
        return 0.0
    match = a.indices[ia] == b.indices
    return float(np.dot(a.values[ia[match]], b.values[match]))


def ip_distance(a: SparseVector, b: SparseVector) -> float:
    return -inner_product(a, b)


def cosine_distance(a: SparseVector, b: SparseVector) -> float:
    """1 - ip; assumes ingest-time normalization (reference vector.cpp:27-47
    normalizes explicitly — ingest already normalized, matching the dense
    convention used by the search path)."""
    return 1.0 - inner_product(a, b)


def l2_distance_sq(a: SparseVector, b: SparseVector) -> float:
    """||a||^2 + ||b||^2 - 2 a.b (reference vector.cpp:71-100)."""
    return a.norm_sq() + b.norm_sq() - 2.0 * inner_product(a, b)


def distance(a: SparseVector, b: SparseVector, metric: MetricType) -> float:
    if metric == MetricType.EUCLIDEAN:
        return l2_distance_sq(a, b)
    if metric == MetricType.COSINE:
        return cosine_distance(a, b)
    return ip_distance(a, b)


def _distances_from_ip(ip, query: SparseVector, norms_sq,
                       metric: MetricType):
    """Distances from inner products (numpy or torch): EUCLIDEAN
    |q|^2 + |x|^2 - 2 ip, COSINE 1 - ip, DOT_PRODUCT -ip."""
    if metric == MetricType.EUCLIDEAN:
        return query.norm_sq() + norms_sq - 2.0 * ip
    if metric == MetricType.COSINE:
        return 1.0 - ip
    return -ip


def _row_sums(x: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """float64 sum of x over each row's CSR range [offsets[r],
    offsets[r + 1]); 0 for a row with no entries."""
    starts = offsets[:-1]
    full = starts < offsets[1:]
    out = np.zeros(len(starts), dtype=np.float64)
    if full.any():
        out[full] = np.add.reduceat(x, starts[full], dtype=np.float64)
    return out


# Kernel launches since the last reset (CPU calls of the plain version are
# not counted), in all and by variant ("shared": the scatter in shared
# memory, "l2": read from global memory): a run reads them to show the
# main path went through the kernel.
launches = 0
launches_by_variant: Dict[str, int] = {}

# The largest scatter (floats) that the kernel keeps in shared memory:
# Hopper's 232,448 bytes of dynamic shared memory a block (the sm_90a build
# runs on nothing else). BERT's 30,522 terms plus the trailing zero fit.
MAX_SHARED_SCATTER = 232_448 // 4


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_variant.clear()


def scatter_variant(len_q: int) -> str:
    """The kernel variant for a scatter of len_q floats: "shared" up to
    MAX_SHARED_SCATTER, else "l2"."""
    return "shared" if len_q <= MAX_SHARED_SCATTER else "l2"


def csr_ip_cost(nnz: int, n_rows: int, len_q: int) -> int:
    """Bytes one scoring must move, each counted once: the int32 index and
    f32 value of every nnz, the n_rows + 1 int64 offsets, the scatter, the
    n_rows f32 outputs. Its 2 f32 operations a nnz on the CUDA cores take
    about 1% of the bytes' time, so the bound is these bytes at the HBM rate
    (partial_min.bound_ms(0, bytes))."""
    return 8 * nnz + 8 * (n_rows + 1) + 4 * len_q + 4 * n_rows


def _check(idx: torch.Tensor, val: torch.Tensor, offs: torch.Tensor,
           q: torch.Tensor) -> None:
    """The operator's checks, in Python (the kernel also needs idx and val
    16-byte aligned, which only the operator checks)."""
    for name, t, dtype in (("idx", idx, torch.int32),
                           ("val", val, torch.float32),
                           ("offs", offs, torch.int64),
                           ("q", q, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"csr_ip: {name} must be {dtype}, got {t.dtype}")
    if not all(t.dim() == 1 for t in (idx, val, offs, q)):
        raise ValueError("csr_ip: idx, val, offs and q must be 1-D")
    if idx.numel() != val.numel():
        raise ValueError(f"csr_ip: {idx.numel()} indices but {val.numel()} "
                         "values")
    if offs.numel() < 1 or q.numel() < 1:
        raise ValueError("csr_ip: offs and q must not be empty")
    if not all(t.is_contiguous() for t in (idx, val, offs, q)):
        raise ValueError("csr_ip: idx, val, offs and q must be contiguous")
    if not all(t.device == idx.device for t in (val, offs, q)):
        raise ValueError(f"csr_ip: idx on {idx.device}, val on {val.device}, "
                         f"offs on {offs.device}, q on {q.device}")


_op = None


def _operator():
    """torch.ops.vdb.csr_ip, its library built and registered on first use
    (_cuda_build raises, naming nvcc's output, if it fails)."""
    global _op
    if _op is None:
        from .. import _cuda_build

        _cuda_build.load_operator("csr_ip_op")
        _op = torch.ops.vdb.csr_ip.default
    return _op


def csr_ip(idx: torch.Tensor, val: torch.Tensor, offs: torch.Tensor,
           q: torch.Tensor) -> torch.Tensor:
    """Inner products of the query scatter q with every row of the CSR
    column (idx int32 [nnz], val f32 [nnz], offs int64 [n_rows + 1],
    non-decreasing from 0 to nnz): out[r] = sum over j in [offs[r],
    offs[r + 1]) of q[clamp(idx[j], 0, len(q) - 1)] * val[j], each row summed
    on its own in f32, 0 for an empty row; [n_rows] f32. On CUDA tensors
    the kernel (the scatter in shared memory up to MAX_SHARED_SCATTER
    floats, else read from global memory), on CPU tensors csr_ip_ref. Both
    raise TypeError for a wrong dtype and ValueError for the other
    arguments the kernel does not take."""
    global launches
    if idx.is_cuda:
        variant = scatter_variant(q.numel())
        out = (_op if _op is not None else _operator())(
            idx, val, offs, q, variant == "shared")
        if out.numel():
            launches += 1
            launches_by_variant[variant] = (
                launches_by_variant.get(variant, 0) + 1)
        return out
    if idx.device.type != "cpu":
        raise ValueError(f"csr_ip: idx on {idx.device}; the kernel takes "
                         "CUDA tensors, the plain version CPU ones")
    _check(idx, val, offs, q)
    return csr_ip_ref(idx, val, offs, q)


def csr_ip_ref(idx: torch.Tensor, val: torch.Tensor, offs: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of csr_ip: the scatter gathered at the clamped
    indices (gather_rows_ref), multiplied by the values, summed per row by
    torch.segment_reduce over the offsets."""
    contrib = gather_rows_ref(q, idx) * val
    return torch.segment_reduce(contrib, "sum", offsets=offs)


class SparseColumnIndex:
    """CSR snapshot of a sparse column for vectorized batch scoring.

    Concatenates all stored vectors into (indices, values, row offsets) so a
    query scores EVERY row in one pass (csr_ip) — replacing the per-row
    merge loop of the reference's sparse path (vector.cpp:7-25). The host
    arrays are int32 indices, f32 values and int64 offsets; the device
    copies (int32 indices, f32 values, int64 offsets, f32 squared norms) are
    uploaded to the engine's device on the first device scoring and kept
    with the snapshot. The offsets stay int64 on the device, so no count of
    nnz wraps.
    """

    def __init__(self, column: Sequence[Optional[SparseVector]], n_rows: int):
        idx_parts, val_parts, offsets = [], [], [0]
        for r in range(n_rows):
            v = column[r]
            if v is not None and len(v.indices):
                idx_parts.append(v.indices)
                val_parts.append(v.values)
                offsets.append(offsets[-1] + len(v.indices))
            else:
                offsets.append(offsets[-1])
        self.indices = (np.concatenate(idx_parts, dtype=np.int32)
                        if idx_parts else np.zeros(0, np.int32))
        self.values = (np.concatenate(val_parts, dtype=np.float32)
                       if val_parts else np.zeros(0, np.float32))
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.n_rows = n_rows
        self.norms_sq = _row_sums(self.values.astype(np.float64) ** 2,
                                  self.offsets).astype(np.float32)
        self.device = default_device()
        self._dev = None

    def _device_arrays(self):
        """(indices int32, values f32, offsets int64, norms_sq f32) on the
        index's device, uploaded once."""
        if self._dev is None:
            dev = self.device
            self._dev = (
                torch.from_numpy(self.indices).to(dev),
                torch.from_numpy(self.values).to(dev),
                torch.from_numpy(self.offsets).to(dev),
                torch.from_numpy(self.norms_sq).to(dev))
        return self._dev

    def device_scores(self, query: SparseVector,
                      metric: MetricType) -> torch.Tensor:
        """Distances of the query to every row, [n_rows] f32 on the index's
        device. The query's dense scatter gets a trailing zero, and
        csr_ip's clamp to [0, len - 1] lands every stored index past the
        query's largest on it (JAX's jnp.minimum(idx, len) on the
        zero-padded scatter). An empty query or column launches nothing."""
        idx, val, offs, norms = self._device_arrays()
        if len(query.indices) and len(self.indices):
            qmax = int(query.indices.max()) + 1
            qdense = np.zeros(qmax + 1, dtype=np.float32)
            qdense[query.indices] = query.values
            ip = csr_ip(idx, val, offs,
                        torch.from_numpy(qdense).to(self.device))
        else:
            ip = torch.zeros(self.n_rows, dtype=torch.float32,
                             device=self.device)
        return _distances_from_ip(ip, query, norms, metric)

    def scores(self, query: SparseVector, metric: MetricType) -> np.ndarray:
        """Distances of the query to every row, [n_rows] f32 on the host
        (device_scores, fetched)."""
        return self.device_scores(query, metric).cpu().numpy()

    def scores_host(self, query: SparseVector,
                    metric: MetricType) -> np.ndarray:
        """Pure-numpy scoring path (no device round trip)."""
        if len(query.indices):
            qmax = int(query.indices[-1]) + 1
            qdense = np.zeros(qmax + 1, dtype=np.float32)
            qdense[query.indices] = query.values
            contrib = np.where(self.indices < qmax,
                               qdense[np.minimum(self.indices, qmax)]
                               * self.values, 0.0)
            ip = _row_sums(contrib, self.offsets).astype(np.float32)
        else:
            ip = np.zeros(self.n_rows, dtype=np.float32)
        return _distances_from_ip(ip, query, self.norms_sq, metric)


def batch_distances(query: SparseVector,
                    column: Sequence[SparseVector],
                    row_ids: np.ndarray,
                    metric: MetricType,
                    index: Optional[SparseColumnIndex] = None) -> np.ndarray:
    """Score a query against stored sparse vectors at `row_ids`.

    With a SparseColumnIndex this is one vectorized pass over the CSR
    arrays; otherwise a temporary index is built from the column.
    """
    if index is None:
        n = (int(row_ids.max()) + 1) if len(row_ids) else 0
        index = SparseColumnIndex(column, n)
    return index.scores(query, metric)[row_ids]
