"""DBServer: the engine facade (reference db/db_server.{hpp,cpp};
counterpart of vectordb_tpu/db_server.py).

Owns the catalog and the name -> Database registry. Its entry points mirror
the reference facade for the ported slice: LoadDB/UnloadDB/DumpDB/
CreateTable/DropTable/Insert/Delete/Search/Project/GetStatistics/Rebuild
and search tuning. Hybrid search answers NOT_IMPLEMENTED_ERROR; the rebuild
thread, leader/follower switching and the embedding service are not ported.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .batcher import QueryBatcher
from .catalog import Catalog
from .database import Database
from .executor import DeviceExecutor
from .errors import (DB_UNEXPECTED_ERROR, INVALID_PAYLOAD, Status,
                     VectorDBError)
from .expr.parser import parse_expr
from .facets import preprocess_facets
from .ops.sparse import SparseVector
from .schema import (DENSE_VECTOR_TYPES, INT_TYPES, FieldType,
                     parse_table_schema_from_user_json)

class DBServer:
    def __init__(self):
        self.catalog = Catalog()
        # All device work funnels through this executor (see executor.py);
        # with no loop running it executes inline on the calling thread.
        self.device_executor = DeviceExecutor()
        # Concurrent unfiltered queries coalesce into batched kernel calls.
        self.query_batcher = QueryBatcher(self.device_executor)
        self.databases: Dict[str, Database] = {}
        self._lock = threading.Lock()
        self.is_leader = True

    # ------------------------------------------------------------------
    # DB registry (reference db_server.cpp:27-133).
    # ------------------------------------------------------------------

    def load_db(self, db_name: str, db_path: str,
                init_table_scale: int = 150000,
                wal_enabled: bool = True) -> Status:
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
                          wal_enabled)
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
        status = self.catalog.create_table(db_name, schema, [])
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
               upsert: bool = False) -> Status:
        try:
            table = self._get_table(db_name, table_name)
        except VectorDBError as e:
            return e.status
        return table.insert(records, upsert=upsert)

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
               facets_config: Optional[List[Dict[str, Any]]] = None
               ) -> Tuple[Status, List[Dict[str, Any]], List[Any]]:
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
                    fdim = table.schema.field_map()[field_name].vector_dimension
                    if dim != fdim:
                        return (Status(DB_UNEXPECTED_ERROR,
                                       "Query dimension doesn't match the "
                                       "vector field dimension."), [], [])
            rows, facets = table.search(field_name, query_fields, dim,
                                        query, limit, nodes, with_distance,
                                        facet_executors)
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
        """Dense + sparse fusion re-ranking across vector fields (not
        ported: the table raises NOT_IMPLEMENTED_ERROR)."""
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
        executor); returns the first failing status, else OK. The periodic
        rebuild thread of the JAX package is not ported."""
        first = Status.OK()
        for name in list(self.databases.keys()):
            db = self.databases.get(name)
            if db is None:
                continue
            status = self.device_executor.run(db.rebuild)
            if not status.ok() and first.ok():
                first = status
        return first

    def set_wal_enabled(self, db_name: str, enabled: bool) -> Status:
        db = self.get_db(db_name)
        if db is None:
            return Status(DB_UNEXPECTED_ERROR, "DB not found: " + db_name)
        db.set_wal_enabled(enabled)
        return Status.OK()
