"""vectordb_tpu_torch — the vectordb_tpu engine on PyTorch and CUDA.

The PyTorch/CUDA port of vectordb_tpu: the same data model (databases ->
tables -> fields), filter language, facets, WAL + snapshot persistence,
function API, REST server (`python -m vectordb_tpu_torch`, rest/), periodic
rebuild thread, leader/follower and embedding service, with the dense query
path running on an NVIDIA GPU: the flat-serve scan, the graph index
(exact-KNN build, or the IVF-partitioned KNN from IvfKnnThreshold rows up;
beam traversal, search tuning), filter masks evaluated on the device
(expr/device.py), and sparse and hybrid (dense + sparse) search with every
row of a sparse column scored on the device (ops/sparse.py). Its three
hand-written CUDA kernels are the partial-min scan (csrc/partial_min.cu),
the row gather of traversal and of the IVF build (csrc/gather_rows.cu,
called through the PyTorch operator torch.ops.vdb.gather_rows of
csrc/gather_rows_op.cpp) and the sparse scorer's one-pass CSR inner
product (csrc/csr_ip.cu, through torch.ops.vdb.csr_ip of
csrc/csr_ip_op.cpp). With ShardCount >= 2
a table's dense fields are sharded over a list of devices (parallel/: one
process drives every shard; `parallel.set_engine_mesh` can place several
shards on one card). QueryDtype selects the grouped paths' query wire
(ops/qwire: f32, bf16 or block-int8; "auto" follows the tuner): the
candidates come from the wire's values and `@distance` stays exact.

A data directory written by either package opens in the other.

The engine runs on the first CUDA device and raises when there is none;
`set_device("cpu")` asks for the CPU, where every kernel runs its plain
PyTorch version.

This module exposes the reference's CPython-binding function API
(reference engine bindings/python/interface.cpp): load_db / use_db /
create_table / insert / delete_by_pk / query / drop_table / unload_db —
returning the same (status_code, payload) shapes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ._device import set_device
from .config import global_config
from .db_server import DBServer
from .errors import Status, VectorDBError
from .schema import FieldType, MetricType, TableSchema

__version__ = "0.1.0"

# Module-global engine + active db name, mirroring the reference bindings'
# module-global `DBServer* db` and `db_name` (interface.cpp:32, use_db).
_db: Optional[DBServer] = None
_db_name: str = ""

InitTableScale = 150000  # reference web_controller.hpp:38


def _engine() -> DBServer:
    global _db
    if _db is None:
        _db = DBServer()
    return _db


def load_db(db_name: str, db_path: str,
            vector_scale: int = InitTableScale,
            wal_enabled: bool = True) -> int:
    if not db_name:
        raise Exception("empty db name")
    if not db_path:
        raise Exception("empty path name")
    status = _engine().load_db(db_name, db_path, vector_scale, wal_enabled)
    return status.code


def use_db(db_name: str) -> int:
    global _db_name
    _db_name = db_name
    return 0


def create_table(table_name: str, table_fields: List[Dict[str, Any]],
                 indices: Optional[List[Dict[str, Any]]] = None) -> int:
    body: Dict[str, Any] = {"name": table_name, "fields": table_fields}
    if indices:
        body["indices"] = indices
    status, _ = _engine().create_table(_db_name, body)
    if not status.ok():
        raise Exception(status.message)
    return status.code


def insert(table_name: str, records: List[Dict[str, Any]],
           upsert: bool = False) -> int:
    status = _engine().insert(_db_name, table_name, records, upsert=upsert)
    return status.code


def insert_columns(table_name: str, columns: Dict[str, Any],
                   upsert: bool = False) -> Tuple[int, Dict[str, Any]]:
    """Bulk columnar ingest (fast path): dense vectors as [n, D] numpy
    arrays, primitive columns as numpy arrays, strings as lists."""
    import json as _json

    status = _engine().insert_columns(_db_name, table_name, columns,
                                      upsert=upsert)
    if not status.ok():
        raise Exception(status.message)
    return status.code, _json.loads(status.message)


def delete_by_pk(table_name: str, primary_keys: List[Any]) -> int:
    status = _engine().delete(_db_name, table_name, primary_keys, "")
    return status.code


def delete(table_name: str, primary_keys: Optional[List[Any]] = None,
           filter: str = "") -> int:
    status = _engine().delete(_db_name, table_name, primary_keys or [],
                              filter)
    return status.code


def query(table_name: str, query_field: str = "",
          query_vector: Any = None, response_fields: Optional[List[str]] = None,
          limit: int = 10, filter: str = "", with_distance: bool = False,
          facets: Optional[List[Dict[str, Any]]] = None
          ) -> Tuple[int, List[Dict[str, Any]]]:
    status, rows, facet_out = _engine().search(
        _db_name, table_name, query_field, response_fields or [],
        query_vector, limit, filter, with_distance, facets)
    if not status.ok():
        raise Exception(status.message)
    if facets:
        return status.code, rows, facet_out
    return status.code, rows


def hybrid_query(table_name: str, queries: List[Dict[str, Any]],
                 response_fields: Optional[List[str]] = None,
                 limit: int = 10, filter: str = "",
                 with_distance: bool = False, rerank: str = "rrf"
                 ) -> Tuple[int, List[Dict[str, Any]]]:
    """Dense + sparse fusion search: queries = [{"field", "vector",
    "weight"}]; rerank is "rrf" or "weighted"."""
    status, rows, _ = _engine().hybrid_search(
        _db_name, table_name, queries, response_fields or [], limit, filter,
        with_distance, rerank)
    if not status.ok():
        raise Exception(status.message)
    return status.code, rows


def tune_search(table_name: str, field_name: str = "",
                target_recall: float = 0.99, sample: int = 256,
                k: int = 10) -> Tuple[int, Dict[str, Any]]:
    """Auto-tune per-field SearchEf (beam width) and traversal depth to a
    recall target; the tuned values persist with the table and override
    the global config."""
    status, report = _engine().tune_search(
        _db_name, table_name, field_name, target_recall, sample, k)
    if not status.ok():
        raise Exception(status.message)
    return status.code, report


def get(table_name: str, response_fields: Optional[List[str]] = None,
        primary_keys: Optional[List[Any]] = None, filter: str = "",
        skip: int = 0, limit: int = -1,
        facets: Optional[List[Dict[str, Any]]] = None
        ) -> Tuple[int, List[Dict[str, Any]]]:
    status, rows, facet_out = _engine().project(
        _db_name, table_name, response_fields or [], primary_keys or [],
        filter, skip, limit, facets)
    if not status.ok():
        raise Exception(status.message)
    if facets:
        return status.code, rows, facet_out
    return status.code, rows


def drop_table(table_name: str) -> int:
    if not table_name:
        raise Exception("empty table name")
    status = _engine().drop_table(_db_name, table_name)
    return status.code


def unload_db(db_name: str) -> int:
    if not db_name:
        raise Exception("empty db name")
    status = _engine().unload_db(db_name)
    return status.code


def statistics(db_name: Optional[str] = None) -> Tuple[int, Dict[str, Any]]:
    status, stats = _engine().get_statistics(db_name or _db_name)
    return status.code, stats


def rebuild() -> int:
    """Build the graph index of every dense field whose row count changed
    (tables below MinimalGraphSize rows stay flat; from IvfKnnThreshold
    rows up the KNN graph is IVF-partitioned). Returns 0."""
    return _engine().rebuild().code


def dump_db(db_name: str, db_path: str) -> int:
    return _engine().dump_db(db_name, db_path).code


def export_reference_format(db_name: Optional[str] = None) -> int:
    """Write the database's state as the reference C++ engine's binary
    artifacts inside its own data directory (rollback / two-way migration;
    see compat.py)."""
    return _engine().export_reference_format(db_name or _db_name).code


def update_config(cfg: Dict[str, Any]) -> int:
    ok, swap = global_config.update(cfg)
    if not ok:
        return 1
    if swap:
        _engine().swap_executors()
    return 0


def _reset_for_tests() -> None:
    """Stop and drop the module-global engine, forget the engine mesh and
    ask for the CUDA device again (test isolation only)."""
    global _db, _db_name
    from .parallel import engine

    if _db is not None:
        _db.stop()
    _db = None
    _db_name = ""
    engine._reset_for_tests()
    set_device("cuda")


__all__ = [
    "DBServer", "Status", "VectorDBError", "FieldType", "MetricType",
    "TableSchema", "global_config",
    "load_db", "use_db", "create_table", "insert", "delete_by_pk", "delete",
    "query", "hybrid_query", "tune_search", "get", "insert_columns",
    "drop_table", "unload_db", "statistics",
    "rebuild", "dump_db", "update_config", "export_reference_format",
    "InitTableScale", "set_device",
]
