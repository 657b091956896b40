"""One loaded database: table registry (reference DBMVP, db/db_mvp.cpp;
counterpart of vectordb_tpu/database.py)."""
from __future__ import annotations

import os
import shutil
import threading
from typing import Dict, List, Optional

from .errors import DB_UNEXPECTED_ERROR, TABLE_NOT_FOUND, Status
from .schema import DatabaseSchema, TableSchema
from .table import Table


class Database:
    def __init__(self, db_schema: DatabaseSchema, is_leader: bool,
                 init_table_scale: int = 150000, wal_enabled: bool = True,
                 embedding_service=None):
        self.schema = db_schema
        self.is_leader = is_leader
        self.init_table_scale = init_table_scale
        self.wal_enabled = wal_enabled
        self.embedding_service = embedding_service
        self.tables: Dict[str, Table] = {}
        self._lock = threading.Lock()
        for ts in db_schema.tables:
            self.tables[ts.name] = Table(
                ts, db_schema.path, is_leader, init_table_scale, wal_enabled,
                embedding_service)

    def get_table(self, name: str) -> Optional[Table]:
        return self.tables.get(name)

    def table_names(self) -> List[str]:
        return list(self.tables.keys())

    def create_table(self, table_schema: TableSchema) -> Status:
        with self._lock:
            if table_schema.name in self.tables:
                return Status(DB_UNEXPECTED_ERROR,
                              "Table already exists: " + table_schema.name)
            self.tables[table_schema.name] = Table(
                table_schema, self.schema.path, self.is_leader,
                self.init_table_scale, self.wal_enabled,
                self.embedding_service)
        return Status.OK()

    def delete_table(self, name: str) -> Status:
        with self._lock:
            table = self.tables.pop(name, None)
            if table is None:
                return Status(TABLE_NOT_FOUND, "Table not found: " + name)
            table.release()
            if self.is_leader:
                path = os.path.join(self.schema.path, str(table.schema.id))
                shutil.rmtree(path, ignore_errors=True)
        return Status.OK()

    def rebuild(self) -> Status:
        """Rebuild every table's graphs; returns the first failing status
        (after trying every table), else OK."""
        first = Status.OK()
        for table in list(self.tables.values()):
            status = table.rebuild()
            if not status.ok() and first.ok():
                first = status
        return first

    def swap_executors(self) -> Status:
        for table in list(self.tables.values()):
            table.swap_executors()
        return Status.OK()

    def dump(self, path: str) -> Status:
        for table in list(self.tables.values()):
            status = table.dump(path)
            if not status.ok():
                return status
        return Status.OK()

    def set_leader(self, leader: bool) -> None:
        self.is_leader = leader
        for table in self.tables.values():
            table.set_leader(leader)

    def set_wal_enabled(self, enabled: bool) -> None:
        self.wal_enabled = enabled
        for table in self.tables.values():
            table.set_wal_enabled(enabled)

    def release(self) -> None:
        for table in self.tables.values():
            table.release()
        self.tables.clear()
