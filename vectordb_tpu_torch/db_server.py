"""DBServer: the engine facade (reference db/db_server.{hpp,cpp};
counterpart of vectordb_tpu/db_server.py).

Owns the catalog, the name -> Database registry, the background rebuild
thread (every RebuildIntervalSeconds, 60 s by default; db_server.hpp:21,
133-142), the leader flag and the embedding-service injection point. Its
entry points mirror the reference facade: LoadDB/UnloadDB/ReleaseDB/DumpDB/
CreateTable/DropTable/Insert/InsertPrepare/Delete/Search/SearchByContent/
Project/GetStatistics/Rebuild/SwapExecutors/SetLeader, plus search tuning
and the reference-format export, and hybrid (dense + sparse) search.
"""
from __future__ import annotations

import json
import threading
import traceback
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ._device import default_device
from .batcher import QueryBatcher
from .catalog import Catalog
from .config import global_config
from .database import Database
from .executor import DeviceExecutor
from .errors import (DB_UNEXPECTED_ERROR, INVALID_PAYLOAD, Status,
                     VectorDBError)
from .expr.parser import parse_expr
from .facets import preprocess_facets
from .logger import logger
from .metrics import span
from .ops.sparse import SparseVector
from .schema import (DENSE_VECTOR_TYPES, INT_TYPES, FieldType,
                     parse_table_schema_from_user_json)


class DBServer:
    def __init__(self):
        # The engine's device: raises here, before any table is opened,
        # when there is no CUDA device and the CPU was not asked for.
        default_device()
        self.catalog = Catalog()
        # All device work funnels through this executor (see executor.py);
        # with no loop running it executes inline on the calling thread.
        self.device_executor = DeviceExecutor()
        # Concurrent unfiltered queries coalesce into batched kernel calls.
        self.query_batcher = QueryBatcher(self.device_executor)
        self.databases: Dict[str, Database] = {}
        self._lock = threading.Lock()
        self.is_leader = True
        self.embedding_service = None
        self._stop = threading.Event()
        self._rebuild_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # Lifecycle.
    # ------------------------------------------------------------------

    def start_rebuild(self) -> None:
        """Start the background thread that calls rebuild() every
        RebuildIntervalSeconds (read afresh each cycle). A failed or
        crashed cycle is logged and the thread goes on."""
        if self._rebuild_thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(global_config.rebuild_interval_s):
                try:
                    status = self.rebuild()
                    if not status.ok():
                        logger.error("Rebuild failed: " + status.message)
                except Exception:  # the thread must outlive a bad cycle
                    logger.error("Rebuild cycle crashed:\n"
                                 + traceback.format_exc())

        self._rebuild_thread = threading.Thread(
            target=loop, name="vdb-rebuild", daemon=True)
        self._rebuild_thread.start()

    def stop(self) -> None:
        """Stop the rebuild thread and wait for it (a cycle in progress
        finishes first)."""
        self._stop.set()
        if self._rebuild_thread is not None:
            self._rebuild_thread.join()
            self._rebuild_thread = None

    def inject_embedding_service(self, service) -> None:
        self.embedding_service = service

    def set_leader(self, leader: bool) -> None:
        self.is_leader = leader
        self.catalog.set_leader(leader)
        for db in self.databases.values():
            if db is not None:
                db.set_leader(leader)

    # ------------------------------------------------------------------
    # DB registry (reference db_server.cpp:27-133).
    # ------------------------------------------------------------------

    def load_db(self, db_name: str, db_path: str,
                init_table_scale: int = 150000,
                wal_enabled: bool = True,
                headers: Optional[Dict[str, str]] = None) -> Status:
        """Load (or create) a database. `headers` (the request's API-key
        headers) is accepted for the REST layer's call and not used."""
        from .errors import DB_ALREADY_EXIST

        # Reserve the name under the lock so concurrent loads of the same
        # db cannot both construct (and double-open WAL files).
        with self._lock:
            if db_name in self.databases:
                return Status(DB_ALREADY_EXIST,
                              "DB already loaded: " + db_name)
            self.databases[db_name] = None  # reservation
        try:
            schema = self.catalog.load_database(db_name, db_path)
            db = Database(schema, self.is_leader, init_table_scale,
                          wal_enabled, self.embedding_service)
        except Exception as e:
            # Any failure (not just VectorDBError — e.g. a corrupted
            # on-disk artifact raising ValueError) must release the name
            # reservation, or the DB can never be loaded again.
            with self._lock:
                if self.databases.get(db_name) is None:
                    del self.databases[db_name]
            if isinstance(e, VectorDBError):
                return e.status
            raise
        with self._lock:
            self.databases[db_name] = db
        return Status.OK()

    def unload_db(self, db_name: str) -> Status:
        with self._lock:
            db = self.databases.pop(db_name, None)
        if db is None:
            return Status(DB_UNEXPECTED_ERROR, "DB not found: " + db_name)
        db.release()
        self.catalog.unload_database(db_name)
        return Status.OK()

    def release_db(self, db_name: str) -> Status:
        return self.unload_db(db_name)

    def dump_db(self, db_name: str, path: str) -> Status:
        from .errors import DB_NOT_FOUND

        db = self.get_db(db_name)
        if db is None:
            return Status(DB_NOT_FOUND, "DB not found: " + db_name)
        status = db.dump(path)
        if not status.ok():
            return status
        # The catalog must land in the DUMP path (reference db_server.cpp
        # SaveDBToFile(db_catalog_path + "/catalog")), or the dump can
        # never be loaded.
        return self.catalog.save(db_name, path)

    def export_reference_format(self, db_name: str) -> Status:
        """Write every table's state as the reference C++ engine's binary
        artifacts (data_mvp.bin + ann_graph_<fid>.bin) inside the db path;
        the catalog is already the shared JSON format, so the reference
        engine opens the directory directly (rollback / two-way migration;
        see compat.py). Sharded graphs (ShardCount >= 2) are not exported:
        rebuild on one device first."""
        from .errors import DB_NOT_FOUND

        db = self.get_db(db_name)
        if db is None:
            return Status(DB_NOT_FOUND, "DB not found: " + db_name)
        for table in db.tables.values():
            status = table.export_reference_format()
            if not status.ok():
                return status
        return self.catalog.save(db_name)

    def get_db(self, db_name: str) -> Optional[Database]:
        db = self.databases.get(db_name)
        return db if db is not None else None

    def get_statistics(self, db_name: str) -> Tuple[Status, Dict[str, Any]]:
        db = self.get_db(db_name)
        if db is None:
            return (Status(DB_UNEXPECTED_ERROR, "DB not found: " + db_name),
                    {})
        result = {
            "totalTableCount": len(db.tables),
            "tables": [
                {"name": t.schema.name,
                 "totalRecordCount": t.segment.count_alive()}
                for t in db.tables.values()
            ],
        }
        return Status.OK(), result

    # ------------------------------------------------------------------
    # Tables.
    # ------------------------------------------------------------------

    def create_table(self, db_name: str, schema_json: str | Dict[str, Any]
                     ) -> Tuple[Status, int]:
        db = self.get_db(db_name)
        if db is None:
            return Status(DB_UNEXPECTED_ERROR, "DB not found: " + db_name), -1
        body = (json.loads(schema_json) if isinstance(schema_json, str)
                else schema_json)
        try:
            schema = parse_table_schema_from_user_json(body)
        except VectorDBError as e:
            return e.status, -1
        models = (self.embedding_service.get_supported_models()
                  if self.embedding_service and schema.indices else [])
        status = self.catalog.create_table(db_name, schema, models)
        if not status.ok():
            return status, -1
        status = db.create_table(schema)
        return status, schema.id

    def drop_table(self, db_name: str, table_name: str) -> Status:
        db = self.get_db(db_name)
        if db is None:
            return Status(DB_UNEXPECTED_ERROR, "DB not found: " + db_name)
        status = db.delete_table(table_name)
        if not status.ok():
            return status
        return self.catalog.drop_table(db_name, table_name)

    def list_tables(self, db_name: str) -> Tuple[Status, List[str]]:
        db = self.get_db(db_name)
        if db is None:
            return Status(DB_UNEXPECTED_ERROR, "DB not found: " + db_name), []
        return Status.OK(), db.table_names()

    # ------------------------------------------------------------------
    # Data plane.
    # ------------------------------------------------------------------

    def _get_table(self, db_name: str, table_name: str):
        db = self.get_db(db_name)
        if db is None:
            raise VectorDBError(DB_UNEXPECTED_ERROR,
                                "DB not found: " + db_name)
        table = db.get_table(table_name)
        if table is None:
            raise VectorDBError(DB_UNEXPECTED_ERROR,
                                "Table not found: " + table_name)
        # Attach the shared device executor + batcher (idempotent).
        table.device_executor = self.device_executor
        table.batcher = self.query_batcher
        return table

    def insert(self, db_name: str, table_name: str,
               records: List[Dict[str, Any]],
               headers: Optional[Dict[str, str]] = None,
               upsert: bool = False) -> Status:
        try:
            table = self._get_table(db_name, table_name)
        except VectorDBError as e:
            return e.status
        return table.insert(records, upsert=upsert, headers=headers)

    def insert_columns(self, db_name: str, table_name: str,
                       columns: Dict[str, Any], n_rows: Optional[int] = None,
                       upsert: bool = False) -> Status:
        """Bulk columnar ingest: dense vector fields as [n, D] numpy
        arrays, primitives as arrays, strings as lists. The fast path for
        large loads (no per-record python overhead)."""
        try:
            table = self._get_table(db_name, table_name)
        except VectorDBError as e:
            return e.status
        if n_rows is None:
            first = next(iter(columns.values()))
            n_rows = (len(first[0]) if isinstance(first, tuple)
                      else len(first))
        return table.insert_columns(columns, int(n_rows), upsert=upsert)

    def insert_prepare(self, db_name: str, table_name: str,
                       pks: List[Any]) -> Tuple[Status, Dict[str, Any]]:
        try:
            table = self._get_table(db_name, table_name)
        except VectorDBError as e:
            return e.status, {}
        return Status.OK(), table.insert_prepare(pks)

    def delete(self, db_name: str, table_name: str, pk_list: List[Any],
               filter_str: str = "") -> Status:
        try:
            table = self._get_table(db_name, table_name)
        except VectorDBError as e:
            return e.status
        # PK type sanity check (reference db_server.cpp:297-360).
        if pk_list:
            pk_field = table.schema.primary_key_field()
            if pk_field is None:
                return Status(DB_UNEXPECTED_ERROR,
                              "Primary key not found: " + table_name)
            if pk_field.field_type in INT_TYPES:
                for i, pk in enumerate(pk_list):
                    if isinstance(pk, bool) or not isinstance(pk, (int, float)):
                        return Status(
                            DB_UNEXPECTED_ERROR,
                            "Primary key type mismatch at field position "
                            + str(i))
            elif pk_field.field_type == FieldType.STRING:
                for i, pk in enumerate(pk_list):
                    if not isinstance(pk, str):
                        return Status(
                            DB_UNEXPECTED_ERROR,
                            "Primary key type mismatch at field position "
                            + str(i))
            else:
                return Status(DB_UNEXPECTED_ERROR,
                              "unexpected Primary key type.")
        try:
            nodes = parse_expr(filter_str or "", table.field_type_map)
        except VectorDBError as e:
            return e.status
        return table.delete(pk_list, filter_str or "", nodes)

    def _resolve_query_field(self, table, field_name: str) -> str:
        """Empty field name resolves iff exactly one vector field exists
        (reference db_server.cpp:480-492)."""
        if field_name:
            return field_name
        resolved = ""
        for f in table.schema.fields:
            if f.is_vector():
                if resolved:
                    raise VectorDBError(
                        INVALID_PAYLOAD,
                        "Must specify queryField if there are more than 1 "
                        "vector fields.")
                resolved = f.name
        return resolved

    def search(self, db_name: str, table_name: str, field_name: str,
               query_fields: List[str], query_vector,
               limit: int, filter_str: str = "", with_distance: bool = False,
               facets_config: Optional[List[Dict[str, Any]]] = None,
               columnar: bool = False
               ) -> Tuple[Status, List[Dict[str, Any]], List[Any]]:
        with span("vdb.search"):
            try:
                table = self._get_table(db_name, table_name)
                field_name = self._resolve_query_field(table, field_name)
                nodes = parse_expr(filter_str or "", table.field_type_map)
                facet_executors = preprocess_facets(facets_config or [],
                                                    table.field_type_map)
                if isinstance(query_vector, dict):
                    query: Any = SparseVector.from_json(query_vector)
                    dim = 0
                else:
                    query = np.asarray(query_vector, dtype=np.float32)
                    dim = int(query.shape[0])
                    ftype = table.field_type_map.get(field_name)
                    if ftype in DENSE_VECTOR_TYPES:
                        fdim = table.schema.field_map()[
                            field_name].vector_dimension
                        if dim != fdim:
                            return (Status(DB_UNEXPECTED_ERROR,
                                           "Query dimension doesn't match the "
                                           "vector field dimension."), [], [])
                rows, facets = table.search(field_name, query_fields, dim,
                                            query, limit, nodes, with_distance,
                                            facet_executors, columnar=columnar)
            except VectorDBError as e:
                return e.status, [], []
            return Status.OK(), rows, facets

    def hybrid_search(self, db_name: str, table_name: str,
                      subqueries: List[Dict[str, Any]],
                      query_fields: List[str], limit: int,
                      filter_str: str = "", with_distance: bool = False,
                      rerank: str = "rrf",
                      facets_config: Optional[List[Dict[str, Any]]] = None
                      ) -> Tuple[Status, List[Dict[str, Any]], List[Any]]:
        """Dense + sparse fusion re-ranking across vector fields
        (Table.hybrid_search: rrf or weighted)."""
        try:
            table = self._get_table(db_name, table_name)
            nodes = parse_expr(filter_str or "", table.field_type_map)
            facet_executors = preprocess_facets(facets_config or [],
                                                table.field_type_map)
            rows, facets = table.hybrid_search(
                subqueries, limit, nodes, with_distance, query_fields,
                rerank, facet_executors)
        except VectorDBError as e:
            return e.status, [], []
        return Status.OK(), rows, facets

    def tune_search(self, db_name: str, table_name: str,
                    field_name: str = "", target_recall: float = 0.99,
                    sample: int = 256, k: int = 10
                    ) -> Tuple[Status, Dict[str, Any]]:
        """Auto-tune per-field (SearchEf, iterations) of graph-indexed
        fields to a recall target."""
        try:
            table = self._get_table(db_name, table_name)
            report = table.tune_search_ef(field_name or None,
                                          float(target_recall),
                                          int(sample), int(k))
        except VectorDBError as e:
            return e.status, {}
        return Status.OK(), report

    def search_by_content(self, db_name: str, table_name: str,
                          index_name: str, query_fields: List[str],
                          query: str, limit: int, filter_str: str = "",
                          with_distance: bool = False,
                          facets_config: Optional[List[Dict[str, Any]]] = None,
                          headers: Optional[Dict[str, str]] = None
                          ) -> Tuple[Status, List[Dict[str, Any]], List[Any]]:
        """Embed query text via the embedding service, then search
        (reference db_server.cpp:512-600)."""
        try:
            table = self._get_table(db_name, table_name)
        except VectorDBError as e:
            return e.status, [], []
        if not index_name:
            for f in table.schema.fields:
                if f.is_index_field and f.is_vector():
                    if index_name:
                        return (Status(INVALID_PAYLOAD,
                                       "Must specify queryIndex if there are "
                                       "more than 1 vector indices."), [], [])
                    index_name = f.name
        if not index_name:
            return (Status(INVALID_PAYLOAD,
                           "There is no index in the table. Cannot search by "
                           "query content."), [], [])
        index = next((i for i in table.schema.indices
                      if i.name == index_name), None)
        if index is None:
            return (Status(INVALID_PAYLOAD, "Index not found: " + index_name),
                    [], [])
        if self.embedding_service is None:
            return (Status(DB_UNEXPECTED_ERROR,
                           "Embedding service is not configured."), [], [])
        field = table.schema.fields[index.tgt_field_id]
        try:
            vec = self.embedding_service.dense_embed_query(
                index.embedding_model_name, query, field.vector_dimension,
                headers or {}, index.dimensions > 0)
        except VectorDBError as e:
            logger.error("Embedding service error: " + e.message)
            return e.status, [], []
        return self.search(db_name, table_name, index_name, query_fields,
                           vec, limit, filter_str, with_distance,
                           facets_config)

    def project(self, db_name: str, table_name: str,
                query_fields: List[str], primary_keys: List[Any],
                filter_str: str = "", skip: int = 0, limit: int = -1,
                facets_config: Optional[List[Dict[str, Any]]] = None
                ) -> Tuple[Status, List[Dict[str, Any]], List[Any]]:
        try:
            table = self._get_table(db_name, table_name)
            nodes = parse_expr(filter_str or "", table.field_type_map)
            facet_executors = preprocess_facets(facets_config or [],
                                                table.field_type_map)
            if limit < 0:
                limit = table.segment.record_number
            rows, facets = table.search_by_attribute(
                query_fields, primary_keys, nodes, skip, limit,
                facet_executors)
        except VectorDBError as e:
            return e.status, [], []
        return Status.OK(), rows, facets

    # ------------------------------------------------------------------
    # Maintenance.
    # ------------------------------------------------------------------

    def rebuild(self) -> Status:
        """Rebuild the graphs of every loaded database (on the device
        executor); returns the first failing status, else OK. The rebuild
        thread and POST /api/rebuild call this."""
        first = Status.OK()
        for name in list(self.databases.keys()):
            db = self.databases.get(name)
            if db is None:
                continue
            status = self.device_executor.run(db.rebuild)
            if not status.ok() and first.ok():
                first = status
        return first

    def swap_executors(self) -> Status:
        for db in list(self.databases.values()):
            if db is not None:
                db.swap_executors()
        return Status.OK()

    def set_wal_enabled(self, db_name: str, enabled: bool) -> Status:
        db = self.get_db(db_name)
        if db is None:
            return Status(DB_UNEXPECTED_ERROR, "DB not found: " + db_name)
        db.set_wal_enabled(enabled)
        return Status.OK()
