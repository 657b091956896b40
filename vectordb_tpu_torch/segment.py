"""Columnar in-memory table segment with device-resident dense vector columns.

Counterpart of vectordb_tpu/segment.py on PyTorch. Same data model as the
reference's TableSegmentMVP (db/table_segment_mvp.{hpp,cpp}) — fixed-capacity
columnar segment, deleted bitset, PK maps, insert/upsert/delete semantics,
cosine normalization at ingest, capacity hard-error — and the same storage
layout and snapshot format as the TPU package, so either engine opens the
other's data directory:

  - primitive attributes: one numpy array per column, so filters evaluate
    as whole-column vector ops;
  - dense vector fields: a float32 numpy host mirror (source of truth,
    persistence, exact re-rank) plus a device buffer in DeviceVectorStore
    that grows geometrically so the scan kernels see tile-aligned shapes;
  - deleted rows: numpy bool mask, combined with filter masks into the
    device-side scan mask.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ._device import default_device
from .errors import (DB_UNEXPECTED_ERROR, INVALID_RECORD, RECORD_NOT_FOUND,
                     Status, VectorDBError)
from .logger import logger
from .metrics import metrics
from .index.geo import GeospatialIndex
from .ops.sparse import SparseVector
from .schema import (DENSE_VECTOR_TYPES, INT_TYPES, PRIMITIVE_DTYPES,
                     SPARSE_VECTOR_TYPES,
                     FieldType, MetricType, TableSchema)
from .utils import atomic_write_bytes

# Device buffers grow by doubling from this floor, so a table's capacity
# (and every kernel shape derived from it) changes only O(log N) times.
MIN_DEVICE_CAPACITY = 4096
# Rows a block of a pass over a whole column (ingest normalization, a
# store's upload): bounds its temporaries and staging copies.
BLOCK_ROWS = 1 << 16

SPARSE_INDICES_KEY = "indices"
SPARSE_VALUES_KEY = "values"

SNAPSHOT_MAGIC = b"VSNP1\x00"


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _normalize_rows(mat: np.ndarray) -> None:
    """Scales each row of a float32 [n, D] array to unit length in place,
    a block of rows at a time; a row of norm 1e-5 or less stays as it is.
    The same arithmetic, row by row, as np.where(nrm > 1e-5, mat /
    np.maximum(nrm, 1e-30), mat)."""
    for s in range(0, mat.shape[0], BLOCK_ROWS):
        blk = mat[s:s + BLOCK_ROWS]
        nrm = np.linalg.norm(blk, axis=1, keepdims=True)
        np.divide(blk, np.maximum(nrm, 1e-30), out=blk, where=nrm > 1e-5)


def column_device_dtype(col: np.ndarray):
    """The dtype a primitive column takes on the device: the one the host
    evaluator reads it in (bool, int64 for the ints, float64 otherwise)."""
    if col.dtype == np.bool_:
        return np.bool_
    return np.int64 if col.dtype.kind in "iu" else np.float64


class DeviceVectorStore:
    """Device-side mirror of one dense vector column.

    Holds a [capacity, dim_padded] tensor (store dtype, default bfloat16;
    rows zero-padded to 128 lanes) plus float32 squared row norms on the
    engine's device. Appends write the new rows in place; growth re-uploads
    into a buffer of double the capacity. The store is filled lazily on
    first search.
    """

    def __init__(self, dim: int, dtype: str = "bfloat16", device=None):
        self.dim = dim
        self.dim_padded = _round_up(dim, 128)
        self.dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        self.device = device if device is not None else default_device()
        self.capacity = 0
        self.length = 0  # rows uploaded so far
        self.buf = None  # [capacity, dim_padded] store dtype
        self.norms = None  # [capacity] f32 squared norms

    def _grow(self, needed: int, host: np.ndarray, norms_host: np.ndarray):
        new_cap = max(MIN_DEVICE_CAPACITY, self.capacity or MIN_DEVICE_CAPACITY)
        while new_cap < needed:
            new_cap *= 2
        # Re-upload everything below `needed` into the fresh buffer; amortized
        # O(1) per row, same policy as a growable array. Block by block:
        # copy_ rounds f32 -> bf16 on the device, to nearest-even.
        self.buf = None  # the old buffer's memory goes first
        self.buf = torch.zeros((new_cap, self.dim_padded), dtype=self.dtype,
                               device=self.device)
        for s in range(0, needed, BLOCK_ROWS):
            e = min(s + BLOCK_ROWS, needed)
            self.buf[s:e, : self.dim].copy_(torch.from_numpy(host[s:e]))
        nrm = np.zeros((new_cap,), dtype=np.float32)
        nrm[:needed] = norms_host[:needed]
        self.norms = torch.from_numpy(nrm).to(self.device)
        self.capacity = new_cap
        self.length = needed

    def sync(self, host: np.ndarray, norms_host: np.ndarray, n_rows: int):
        """Bring the device buffer up to date with host rows [0, n_rows)."""
        if n_rows > self.capacity or self.buf is None:
            self._grow(n_rows, host, norms_host)
            return
        if n_rows <= self.length:
            return
        start, stop = self.length, n_rows
        rows = np.zeros((stop - start, self.dim_padded), dtype=np.float32)
        rows[:, : self.dim] = host[start:stop]
        # In place: where JAX wrote the rows with a donated
        # dynamic_update_slice, a torch buffer is simply updated; copy_
        # rounds f32 -> bf16 to nearest-even, as jnp.asarray does.
        self.buf[start:stop].copy_(torch.from_numpy(rows))
        self.norms[start:stop].copy_(
            torch.from_numpy(np.ascontiguousarray(norms_host[start:stop])))
        self.length = stop

    def invalidate(self):
        self.buf = None
        self.norms = None
        self.capacity = 0
        self.length = 0


class TableSegment:
    """Fixed-capacity columnar segment (reference table_segment_mvp.cpp)."""

    SNAPSHOT_VERSION = 1

    def __init__(self, schema: TableSchema, capacity: int = 150000,
                 vector_dtype: str = "bfloat16"):
        self.schema = schema
        self.size_limit = int(capacity)
        self.vector_dtype = vector_dtype
        self.record_number = 0
        self.first_record_id = 0
        self.wal_global_id = -1
        self.deleted = np.zeros(self.size_limit, dtype=bool)
        self.skip_sync_disk = True

        # Column stores.
        self.primitive_cols: Dict[str, np.ndarray] = {}
        self.geo_cols: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self.varlen_cols: Dict[str, List[Optional[str]]] = {}  # STRING/JSON
        self.sparse_cols: Dict[str, List[Optional[SparseVector]]] = {}
        self.dense_host: Dict[str, np.ndarray] = {}    # f32 [cap, D]
        self.dense_norms: Dict[str, np.ndarray] = {}   # f32 [cap] squared
        self.dense_device: Dict[str, DeviceVectorStore] = {}

        self.pk_field: Optional[str] = None
        self.pk_map: Dict[Any, int] = {}
        self.geo_indices: Dict[str, GeospatialIndex] = {}
        # Bumped on every insert/delete; used to invalidate cached device
        # masks without re-uploading them per query.
        self.mutation_version = 0
        # valid_mask's snapshots: n_padded -> (version, mask, alive count).
        self._valid_masks: Dict[Optional[int], Tuple[int, np.ndarray, int]] = {}
        self._valid_masks_lock = threading.Lock()

        for f in schema.fields:
            if f.is_primary_key:
                self.pk_field = f.name
            ft = f.field_type
            if ft in PRIMITIVE_DTYPES:
                self.primitive_cols[f.name] = np.zeros(
                    self.size_limit, dtype=PRIMITIVE_DTYPES[ft])
            elif ft == FieldType.GEO_POINT:
                self.geo_cols[f.name] = (
                    np.zeros(self.size_limit, dtype=np.float64),
                    np.zeros(self.size_limit, dtype=np.float64))
                self.geo_indices[f.name] = GeospatialIndex()
            elif ft in (FieldType.STRING, FieldType.JSON):
                self.varlen_cols[f.name] = [None] * self.size_limit
            elif ft in DENSE_VECTOR_TYPES:
                self.dense_host[f.name] = np.zeros(
                    (self.size_limit, f.vector_dimension), dtype=np.float32)
                self.dense_norms[f.name] = np.zeros(self.size_limit,
                                                    dtype=np.float32)
                self.dense_device[f.name] = DeviceVectorStore(
                    f.vector_dimension, vector_dtype)
            else:  # sparse vector
                self.sparse_cols[f.name] = [None] * self.size_limit

        self.data_lock = threading.RLock()

    # ------------------------------------------------------------------
    # Column access for the filter compiler.
    # ------------------------------------------------------------------

    def column(self, name: str):
        if name in self.primitive_cols:
            return self.primitive_cols[name]
        if name in self.geo_cols:
            return self.geo_cols[name]
        if name in self.varlen_cols:
            return np.asarray(self.varlen_cols[name], dtype=object)
        raise VectorDBError(DB_UNEXPECTED_ERROR, "Unknown column: " + name)

    # ------------------------------------------------------------------
    # PK helpers.
    # ------------------------------------------------------------------

    def _pk_value(self, record: Dict[str, Any], fld) -> Any:
        v = record[fld.name]
        if fld.field_type in INT_TYPES:
            return int(v)
        return str(v)

    def pk_to_id(self, pk: Any) -> Optional[int]:
        fld = self.schema.field_map().get(self.pk_field) if self.pk_field else None
        if fld is None:
            return None
        key = int(pk) if fld.field_type in INT_TYPES else str(pk)
        return self.pk_map.get(key)

    def is_int_pk(self) -> bool:
        if not self.pk_field:
            return False
        return self.schema.field_map()[self.pk_field].field_type in INT_TYPES

    def is_string_pk(self) -> bool:
        if not self.pk_field:
            return False
        return self.schema.field_map()[self.pk_field].field_type == FieldType.STRING

    # ------------------------------------------------------------------
    # Insert (reference table_segment_mvp.cpp:455-814).
    # ------------------------------------------------------------------

    def pack_records(self, records: List[Dict[str, Any]]
                     ) -> Tuple[Status, Dict[str, Any], int, int]:
        """Validate records and extract columnar arrays.

        Returns (status, columns, n_valid_rows, skipped). Per-row validation
        matches insert semantics (reference table_segment_mvp.cpp:455-651):
        wrong dimension / malformed sparse vectors skip the row; a missing
        field rejects the whole batch. Columns: primitives as python lists
        (converted to numpy at the end), dense vectors stacked [m, D] f32
        with vectorized cosine normalization.
        """
        n_new = len(records)
        cols: Dict[str, List[Any]] = {
            f.name: [] for f in self.schema.fields if not f.is_index_field}
        fields = [f for f in self.schema.fields if not f.is_index_field]
        for i, rec in enumerate(records):
            for f in fields:
                if f.name not in rec:
                    return (Status(INVALID_RECORD,
                                   f"Record {i} missing field: {f.name}"),
                            {}, 0, 0)

        skipped = 0
        for i, rec in enumerate(records):
            row: Dict[str, Any] = {}
            row_ok = True
            for f in fields:
                ft = f.field_type
                try:
                    if ft in DENSE_VECTOR_TYPES:
                        vec = rec[f.name]
                        if len(vec) != f.vector_dimension:
                            logger.error(
                                f"Record {i} field {f.name} has wrong "
                                f"dimension, expecting: {f.vector_dimension} "
                                f"actual: {len(vec)}")
                            row_ok = False
                            break
                        row[f.name] = vec
                    elif ft in SPARSE_VECTOR_TYPES:
                        sv = rec[f.name]
                        idx = np.asarray(sv.get(SPARSE_INDICES_KEY, []),
                                         dtype=np.int64)
                        val = np.asarray(sv.get(SPARSE_VALUES_KEY, []),
                                         dtype=np.float32)
                        if len(idx) != len(val):
                            logger.error(
                                f"mismatched indices array length "
                                f"({len(idx)}) and value array length "
                                f"({len(val)}), skipping.")
                            row_ok = False
                            break
                        if len(idx) > 0 and (
                                idx[-1] >= f.vector_dimension
                                or np.any(idx < 0)
                                or np.any(np.diff(idx) <= 0)):
                            logger.error(
                                f"Record {i} field {f.name} has an invalid "
                                "sparse vector, skipping.")
                            row_ok = False
                            break
                        v = SparseVector(idx, val)
                        if f.metric_type == MetricType.COSINE:
                            v = v.normalized()
                        row[f.name] = v
                    elif ft == FieldType.GEO_POINT:
                        g = rec[f.name]
                        lat = min(max(float(g["latitude"]), -90.0), 90.0)
                        lon = min(max(float(g["longitude"]), -180.0), 180.0)
                        row[f.name] = (lat, lon)
                    elif ft == FieldType.STRING:
                        row[f.name] = str(rec[f.name])
                    elif ft == FieldType.JSON:
                        row[f.name] = json.dumps(rec[f.name])
                    elif ft == FieldType.BOOL:
                        row[f.name] = bool(rec[f.name])
                    elif ft in (FieldType.FLOAT, FieldType.DOUBLE):
                        row[f.name] = float(rec[f.name])
                    else:
                        row[f.name] = int(rec[f.name])
                except (TypeError, ValueError, KeyError) as e:
                    logger.error(f"Record {i} field {f.name} invalid: {e}")
                    row_ok = False
                    break
            if not row_ok:
                skipped += 1
                continue
            for f in fields:
                cols[f.name].append(row[f.name])

        m = n_new - skipped
        columns: Dict[str, Any] = {}
        for f in fields:
            ft = f.field_type
            vals = cols[f.name]
            if ft in DENSE_VECTOR_TYPES:
                try:
                    mat = np.asarray(vals, dtype=np.float32).reshape(
                        m, f.vector_dimension)
                except (TypeError, ValueError):
                    return (Status(INVALID_RECORD,
                                   f"Field {f.name} has malformed vectors."),
                            {}, 0, 0)
                if f.metric_type == MetricType.COSINE:
                    nrm = np.linalg.norm(mat, axis=1, keepdims=True)
                    mat = np.where(nrm > 1e-5, mat / np.maximum(nrm, 1e-30),
                                   mat)
                columns[f.name] = mat
            elif ft == FieldType.GEO_POINT:
                columns[f.name] = (
                    np.asarray([v[0] for v in vals], np.float64),
                    np.asarray([v[1] for v in vals], np.float64))
            elif ft in SPARSE_VECTOR_TYPES or ft in (FieldType.STRING,
                                                     FieldType.JSON):
                columns[f.name] = vals
            else:
                columns[f.name] = np.asarray(
                    vals, dtype=PRIMITIVE_DTYPES[ft])
        return Status.OK(), columns, m, skipped

    def column_kinds(self) -> Dict[str, str]:
        """colcodec kind per non-index field (for binary WAL encoding)."""
        kinds: Dict[str, str] = {}
        for f in self.schema.fields:
            if f.is_index_field:
                continue
            if f.field_type in DENSE_VECTOR_TYPES:
                kinds[f.name] = "array"
            elif f.field_type in SPARSE_VECTOR_TYPES:
                kinds[f.name] = "sparse"
            elif f.field_type == FieldType.GEO_POINT:
                kinds[f.name] = "geo"
            elif f.field_type in (FieldType.STRING, FieldType.JSON):
                kinds[f.name] = "strings"
            else:
                kinds[f.name] = "array"
        return kinds

    def insert(self, records: List[Dict[str, Any]], wal_id: int = -1,
               upsert: bool = False,
               embedding_service=None,
               headers: Optional[Dict[str, str]] = None) -> Status:
        status, columns, m, skipped = self.pack_records(records)
        if not status.ok():
            return status
        return self.insert_columns(columns, m, wal_id, upsert,
                                   embedding_service, headers,
                                   pre_skipped=skipped)

    def insert_columns(self, columns: Dict[str, Any], n_rows: int,
                       wal_id: int = -1, upsert: bool = False,
                       embedding_service=None,
                       headers: Optional[Dict[str, str]] = None,
                       pre_skipped: int = 0) -> Status:
        """Bulk insert of a packed column batch (vectorized writes).

        PK dedup / upsert bookkeeping runs sequentially over the batch
        (matching per-record semantics incl. intra-batch duplicates,
        reference table_segment_mvp.cpp:652-741); everything else is
        columnar slice assignment.
        """
        with self.data_lock:
            self.wal_global_id = wal_id
            if n_rows == 0:
                return Status(0, json.dumps(
                    {"inserted": 0, "skipped": pre_skipped}))
            if self.record_number + n_rows > self.size_limit:
                return Status(
                    DB_UNEXPECTED_ERROR,
                    "Currently, each table in this database can hold up to "
                    f"{self.size_limit} records. To insert more records, "
                    "please unload the database and reload with a larger "
                    "vectorScale parameter.")

            start = self.record_number
            fmap = self.schema.field_map()
            upserts: List[Tuple[Any, int, int]] = []
            if self.pk_field is not None:
                pk_fld = fmap[self.pk_field]
                raw = columns[self.pk_field]
                if pk_fld.field_type in INT_TYPES:
                    pk_vals = [int(v) for v in raw]
                else:
                    pk_vals = [str(v) for v in raw]
                keep = np.zeros(n_rows, dtype=bool)
                cursor = start
                for i, pk in enumerate(pk_vals):
                    old = self.pk_map.get(pk)
                    if old is not None:
                        if upsert:
                            upserts.append((pk, old, cursor))
                            self.pk_map[pk] = cursor
                        else:
                            continue
                    else:
                        self.pk_map[pk] = cursor
                    keep[i] = True
                    cursor += 1
            else:
                keep = np.ones(n_rows, dtype=bool)
                cursor = start + n_rows
            kept = int(keep.sum())
            skipped = pre_skipped + (n_rows - kept)
            stop = start + kept

            for f in self.schema.fields:
                if f.is_index_field:
                    continue
                name = f.name
                ft = f.field_type
                col = columns[name]
                if ft in DENSE_VECTOR_TYPES:
                    mat = np.asarray(col, dtype=np.float32)
                    if mat.ndim != 2 or mat.shape[1] != f.vector_dimension:
                        return Status(
                            INVALID_RECORD,
                            f"Field {name} expects [n, "
                            f"{f.vector_dimension}] vectors, got "
                            f"{mat.shape}.")
                    dst = self.dense_host[name][start:stop]
                    dst[...] = mat if kept == n_rows else mat[keep]
                    if f.metric_type == MetricType.COSINE:
                        # Ingest-time normalization (reference
                        # table_segment_mvp.cpp:564-587); idempotent, so
                        # WAL replay of already-normalized batches is safe.
                        _normalize_rows(dst)
                    self.dense_norms[name][start:stop] = np.einsum(
                        "nd,nd->n", dst, dst).astype(np.float32)
                elif ft in SPARSE_VECTOR_TYPES:
                    kept_vals = [v for v, k in zip(col, keep) if k]
                    if f.metric_type == MetricType.COSINE:
                        kept_vals = [v.normalized() if v is not None else v
                                     for v in kept_vals]
                    self.sparse_cols[name][start:stop] = kept_vals
                elif ft == FieldType.GEO_POINT:
                    lat, lon = col
                    self.geo_cols[name][0][start:stop] = lat[keep]
                    self.geo_cols[name][1][start:stop] = lon[keep]
                    kept_n = stop - start
                    self.geo_indices[name].bulk_insert(
                        lat[keep], lon[keep],
                        start + np.arange(kept_n, dtype=np.int64))
                elif ft in (FieldType.STRING, FieldType.JSON):
                    kept_vals = [v for v, k in zip(col, keep) if k]
                    self.varlen_cols[name][start:stop] = kept_vals
                else:
                    self.primitive_cols[name][start:stop] = col[keep]

            # Auto-embedding of index fields over rows [start, stop)
            # (reference table_segment_mvp.cpp:746-762).
            if embedding_service is not None:
                for index in self.schema.indices:
                    src_field = self.schema.fields[index.src_field_id].name
                    tgt = self.schema.fields[index.tgt_field_id]
                    docs = self.varlen_cols[src_field][start:stop]
                    try:
                        embs = embedding_service.dense_embed_documents(
                            index.embedding_model_name, docs,
                            tgt.vector_dimension, headers or {},
                            index.dimensions > 0)
                    except VectorDBError as e:
                        logger.error("embedding service error: " + e.message)
                        return e.status
                    mat = np.asarray(embs, dtype=np.float32)
                    self.dense_host[tgt.name][start:stop] = mat
                    self.dense_norms[tgt.name][start:stop] = np.einsum(
                        "nd,nd->n", mat, mat).astype(np.float32)

            self.record_number = stop
            for pk_key, old_row, new_row in upserts:
                self.deleted[old_row] = True
            self.skip_sync_disk = False
            self.mutation_version += 1
            return Status(0, json.dumps(
                {"inserted": kept, "skipped": skipped}))

    # ------------------------------------------------------------------
    # Delete (reference table_segment_mvp.cpp:321-453).
    # ------------------------------------------------------------------

    def delete(self, pk_list: List[Any], filter_compiler, wal_id: int = -1) -> Status:
        with self.data_lock:
            self.wal_global_id = wal_id
            deleted_count = 0
            if pk_list:
                for pk in pk_list:
                    row = self.pk_to_id(pk)
                    if row is None or self.deleted[row]:
                        continue
                    if filter_compiler is not None:
                        ok = filter_compiler.mask(
                            row_ids=np.asarray([row], dtype=np.int64))[0]
                        if not ok:
                            continue
                    self.deleted[row] = True
                    fld = self.schema.field_map()[self.pk_field]
                    key = int(pk) if fld.field_type in INT_TYPES else str(pk)
                    self.pk_map.pop(key, None)
                    deleted_count += 1
            else:
                n = self.record_number
                alive = ~self.deleted[:n]
                if filter_compiler is not None:
                    mask = filter_compiler.mask(n_rows=n) & alive
                else:
                    mask = alive
                rows = np.nonzero(mask)[0]
                for row in rows:
                    self.deleted[row] = True
                if self.pk_field is not None and len(rows):
                    doomed = set(rows.tolist())
                    self.pk_map = {k: v for k, v in self.pk_map.items()
                                   if v not in doomed}
                deleted_count = len(rows)
            self.skip_sync_disk = False
            self.mutation_version += 1
            return Status(0, json.dumps({"deleted": int(deleted_count)}))

    # ------------------------------------------------------------------
    # InsertPrepare (reference table_segment_mvp.cpp:816-876).
    # ------------------------------------------------------------------

    def insert_prepare(self, pks: List[Any]) -> Dict[str, Any]:
        result: Dict[str, Any] = {
            "capacity": self.size_limit,
            "recordNumber": self.record_number,
        }
        if pks:
            masks: List[int] = []
            mask = 0xFFFFFFFF
            for i, pk in enumerate(pks):
                mod = i % 32
                if mod == 0:
                    mask = 0xFFFFFFFF
                if self.pk_to_id(pk) is not None:
                    mask -= 1 << mod
                if mod == 31:
                    masks.append(mask)
            if len(pks) % 32 != 0:
                masks.append(mask)
            result["masks"] = masks
        return result

    # ------------------------------------------------------------------
    # Device sync.
    # ------------------------------------------------------------------

    def device_view(self, field_name: str) -> DeviceVectorStore:
        """Device buffer for a dense field, synced to the current row count."""
        store = self.dense_device[field_name]
        with self.data_lock:
            store.sync(self.dense_host[field_name],
                       self.dense_norms[field_name], self.record_number)
        return store

    def device_view_f32(self, field_name: str) -> DeviceVectorStore:
        """Float32 device mirror of a dense field — the exact re-rank view
        for the flat-serve path (the primary store is bf16). Created
        lazily, synced like device_view; callers gate its memory cost
        before asking."""
        cache = getattr(self, "_dense_device_f32", None)
        if cache is None:
            cache = self._dense_device_f32 = {}
        store = cache.get(field_name)
        if store is None:
            store = cache[field_name] = DeviceVectorStore(
                self.dense_host[field_name].shape[1], "float32")
        with self.data_lock:
            store.sync(self.dense_host[field_name],
                       self.dense_norms[field_name], self.record_number)
        return store

    def device_column(self, name: str, capacity: int):
        """Device-resident primitive column, or (lat, lon) pair for a geo
        column, zero-padded to `capacity` and cached by segment mutation
        version (the inputs of expr/device.py filter masks).

        Each column goes up in the dtype the host evaluator
        (expr/evaluator.py) reads it in: float64 for DOUBLE and FLOAT and
        for geo lat/lon, int64 for the int types, bool for BOOL. Every
        column is therefore exact on the device and a device mask equals
        the host mask bit for bit. vectordb_tpu uploads these columns as
        float32 and falls back to the host for ints of 2^24 and up: its
        float32 DOUBLE columns and constants round, so `price > 10.5` can
        keep no row of prices 10.5 +- 1e-9 where the host keeps half
        (ROADMAP queue 3)."""
        cache = getattr(self, "_device_col_cache", None)
        if cache is None:
            cache = self._device_col_cache = {}
        key = (name, capacity)
        hit = cache.get(key)
        if hit is not None and hit[0] == self.mutation_version:
            return hit[1]
        n = self.record_number
        dev = default_device()

        def upload(col: np.ndarray, dtype) -> torch.Tensor:
            p = np.zeros(capacity, dtype)
            p[:n] = col[:n]
            return torch.from_numpy(p).to(dev)

        if name in self.geo_cols:
            lat, lon = self.geo_cols[name]
            out = (upload(lat, np.float64), upload(lon, np.float64))
        else:
            col = self.primitive_cols[name]
            out = upload(col, column_device_dtype(col))
        cache[key] = (self.mutation_version, out)
        return out

    def release_device(self) -> None:
        """Drop every device buffer of the segment (stores, f32 mirrors,
        cached filter columns)."""
        for store in self.dense_device.values():
            store.invalidate()
        for store in getattr(self, "_dense_device_f32", {}).values():
            store.invalidate()
        self._device_col_cache = {}

    def valid_mask(self, n_padded: Optional[int] = None) -> np.ndarray:
        """Bool mask over [0, n_padded): alive rows below record_number.

        One read-only snapshot per (mutation version, n_padded), its alive
        count stored beside it (alive_count). The version is read before
        the build and the snapshot stored only if it still holds after, so
        a mask that predates a concurrent insert or delete is never served
        at the write's version. A caller that needs another mask makes a
        new array (`valid & other`); an in-place write raises."""
        ver = self.mutation_version
        hit = self._valid_masks.get(n_padded)
        if hit is not None and hit[0] == ver:
            metrics.inc("valid_mask_reuses_total")
            return hit[1]
        n = self.record_number
        size = n_padded if n_padded is not None else n
        mask = np.zeros(size, dtype=bool)
        lim = min(n, size)
        mask[:lim] = ~self.deleted[:lim]
        mask.flags.writeable = False
        metrics.inc("valid_mask_builds_total")
        with self._valid_masks_lock:
            if self.mutation_version == ver:
                # Copy on write: readers look entries up without the lock.
                kept = {k: e for k, e in self._valid_masks.items()
                        if e[0] == ver}
                kept[n_padded] = (ver, mask, int(np.count_nonzero(mask)))
                self._valid_masks = kept
        return mask

    def alive_count(self, mask: np.ndarray) -> int:
        """np.count_nonzero(mask): the stored count when `mask` is a cached
        valid_mask snapshot, else counted."""
        for _, snap, count in self._valid_masks.values():
            if snap is mask:
                return count
        return int(np.count_nonzero(mask))

    def count_alive(self) -> int:
        return int(self.record_number - np.count_nonzero(
            self.deleted[: self.record_number]))

    # ------------------------------------------------------------------
    # Snapshot persistence. Layout differs from the reference binary (this
    # store is column-major numpy, not a packed byte table); the artifact
    # role matches data_mvp.bin (reference table_segment_mvp.cpp:939-1010):
    # record count, deleted bitset, all columns, consumed WAL id, written
    # atomically via tmp+rename+fsync.
    # ------------------------------------------------------------------

    def save(self, path: str) -> Status:
        from .colcodec import encode_columns

        with self.data_lock:
            if self.skip_sync_disk:
                return Status.OK()
            n = self.record_number
            columns: Dict[str, Any] = {
                "__deleted__": np.packbits(self.deleted[:n])}
            kinds: Dict[str, str] = {"__deleted__": "array"}
            for name, col in self.primitive_cols.items():
                columns["prim:" + name] = col[:n]
                kinds["prim:" + name] = "array"
            for name, (lat, lon) in self.geo_cols.items():
                columns["geo:" + name] = (lat[:n], lon[:n])
                kinds["geo:" + name] = "geo"
            for name, col in self.varlen_cols.items():
                columns["varlen:" + name] = col[:n]
                kinds["varlen:" + name] = "strings"
            for name, col in self.sparse_cols.items():
                columns["sparse:" + name] = col[:n]
                kinds["sparse:" + name] = "sparse"
            for name, col in self.dense_host.items():
                columns["dense:" + name] = col[:n]
                kinds["dense:" + name] = "array"

            blob = encode_columns(columns, n, kinds)
            meta = json.dumps({
                "version": self.SNAPSHOT_VERSION,
                "record_number": n,
                "first_record_id": self.first_record_id,
                "wal_global_id": self.wal_global_id,
                "size_limit": self.size_limit,
            }).encode("utf-8")
            import struct as _struct

            header = (SNAPSHOT_MAGIC + _struct.pack("<Q", len(meta)) + meta)
            from .native import get_native
            from .utils import ensure_dir

            ensure_dir(os.path.dirname(path) or ".")
            native = get_native()
            if native is not None:
                native.snapshot_write(path, header, [blob])
            else:
                atomic_write_bytes(path, header + blob)
            self.skip_sync_disk = True
        return Status.OK()

    @classmethod
    def load(cls, path: str, schema: TableSchema, capacity: int = 150000,
             vector_dtype: str = "bfloat16") -> "TableSegment":
        from .colcodec import decode_columns

        seg = cls(schema, capacity, vector_dtype)
        if not os.path.exists(path):
            return seg
        import struct as _struct

        with open(path, "rb") as f:
            data = f.read()
        if data[: len(SNAPSHOT_MAGIC)] != SNAPSHOT_MAGIC:
            raise VectorDBError(DB_UNEXPECTED_ERROR,
                                "Bad snapshot magic: " + path)
        off = len(SNAPSHOT_MAGIC)
        (meta_len,) = _struct.unpack_from("<Q", data, off)
        off += 8
        meta = json.loads(data[off:off + meta_len].decode("utf-8"))
        columns, n = decode_columns(data[off + meta_len:])
        n = int(meta["record_number"])
        if n > seg.size_limit:
            raise VectorDBError(
                DB_UNEXPECTED_ERROR,
                f"Snapshot has {n} records which exceeds the table "
                f"capacity {seg.size_limit}; reload with a larger "
                "vectorScale parameter.")
        seg.record_number = n
        seg.first_record_id = int(meta.get("first_record_id", 0))
        seg.wal_global_id = int(meta.get("wal_global_id", -1))
        seg.deleted[:n] = np.unpackbits(columns["__deleted__"],
                                        count=n).astype(bool)
        for name in seg.primitive_cols:
            seg.primitive_cols[name][:n] = columns["prim:" + name]
        alive_rows = np.nonzero(~seg.deleted[:n])[0]
        for name in seg.geo_cols:
            lat_src, lon_src = columns["geo:" + name]
            seg.geo_cols[name][0][:n] = lat_src
            seg.geo_cols[name][1][:n] = lon_src
            seg.geo_indices[name].bulk_insert(
                lat_src[alive_rows], lon_src[alive_rows], alive_rows)
        for name in seg.varlen_cols:
            seg.varlen_cols[name][:n] = columns["varlen:" + name]
        for name in seg.sparse_cols:
            seg.sparse_cols[name][:n] = columns["sparse:" + name]
        for name in seg.dense_host:
            seg.dense_host[name][:n] = columns["dense:" + name]
            seg.dense_norms[name][:n] = np.einsum(
                "nd,nd->n", seg.dense_host[name][:n],
                seg.dense_host[name][:n]).astype(np.float32)
        # Rebuild PK map (reference load ctor rebuilds it, 177-236);
        # vectorized — one tolist + dict.update instead of an O(N) loop of
        # per-row int()/dict stores.
        if seg.pk_field is not None:
            fld = seg.schema.field_map()[seg.pk_field]
            rows = alive_rows.tolist()
            if fld.field_type in INT_TYPES:
                keys = seg.primitive_cols[seg.pk_field][alive_rows].tolist()
            else:
                col = seg.varlen_cols[seg.pk_field]
                keys = [str(col[r]) for r in rows]
            seg.pk_map.update(zip(keys, rows))
        seg.skip_sync_disk = True
        return seg
