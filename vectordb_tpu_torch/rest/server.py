"""REST API server (counterpart of vectordb_tpu/rest/server.py).

Mirrors the reference's oatpp WebController surface (reference engine
server/web_server/web_controller.hpp): identical
endpoint paths, request payloads, response JSON shapes ({statusCode, message,
result}) and status-code mapping, so clients of the reference engine (e.g.
pyepsilla) work unchanged. HTTP plumbing is Python stdlib (ThreadingHTTPServer)
— the reference's perf-critical path is the engine, not the web layer, and
the engine batches concurrent requests onto the device kernels. Hybrid
(`queryVectors`) and sparse (`queryVector` as {indices, values}) queries
take the engine's sparse and hybrid search.
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..config import global_config
from ..db_server import DBServer
from ..fastjson import dumps_bytes
from ..errors import (DB_ALREADY_EXIST, DB_NOT_FOUND, INVALID_EXPR,
                      INVALID_PAYLOAD, NOT_IMPLEMENTED_ERROR)
from ..logger import logger

# Embedding API-key forwarding headers (reference utils/constants.hpp:4-9).
API_KEY_HEADERS = [
    "X-OpenAI-API-Key", "X-JinaAI-API-Key", "X-VoyageAI-API-Key",
    "X-MixedbreadAI-API-Key", "X-NOMIC-API-Key", "X-MistralAI-API-Key",
]

InitTableScale = 150000


def _status(code: int, message: str) -> Tuple[int, Dict[str, Any]]:
    return code, {"statusCode": code, "message": message}


class RestServer:
    """Routes requests to a DBServer (the reference's WebController role)."""

    def __init__(self, db_server: Optional[DBServer] = None):
        self.db = db_server or DBServer()
        self.routes: List[Tuple[str, re.Pattern, Callable]] = []
        r = self._route
        r("GET", r"^/$", self.root)
        r("GET", r"^/state$", self.state)
        r("POST", r"^/api/load$", self.load_db)
        r("POST", r"^/api/dump$", self.dump_db)
        # Extension (no reference equivalent): write reference-engine
        # binary artifacts for rollback / two-way migration (compat.py).
        r("POST", r"^/api/exportreference$", self.export_reference)
        # Extension: auto-tune per-field SearchEf to a recall target.
        r("POST", r"^/api/(?P<db>[^/]+)/data/tunesearch$", self.tune_search)
        r("POST", r"^/api/rebuild$", self.rebuild)
        r("POST", r"^/api/setleader$", self.set_leader)
        r("POST", r"^/api/config$", self.update_config)
        r("POST", r"^/api/(?P<db>[^/]+)/unload$", self.unload_db)
        r("POST", r"^/api/(?P<db>[^/]+)/release$", self.release_db)
        r("DELETE", r"^/api/(?P<db>[^/]+)/drop$", self.drop_db)
        r("POST", r"^/api/(?P<db>[^/]+)/schema/tables$", self.create_table)
        r("DELETE", r"^/api/(?P<db>[^/]+)/schema/tables/(?P<table>[^/]+)$",
          self.drop_table)
        r("GET", r"^/api/(?P<db>[^/]+)/schema/tables/show$", self.list_tables)
        r("GET",
          r"^/api/(?P<db>[^/]+)/schema/tables/(?P<table>[^/]+)/describe$",
          self.describe_table)
        r("POST", r"^/api/(?P<db>[^/]+)/data/insert$", self.insert)
        r("POST", r"^/api/(?P<db>[^/]+)/data/insertprepare$",
          self.insert_prepare)
        r("POST", r"^/api/(?P<db>[^/]+)/data/delete$", self.delete)
        r("POST", r"^/api/(?P<db>[^/]+)/data/query$", self.query)
        r("POST", r"^/api/(?P<db>[^/]+)/data/get$", self.get)
        r("POST", r"^/api/(?P<db>[^/]+)/data/load$", self.load_csv)
        r("GET", r"^/api/(?P<db>[^/]+)/statistics$", self.statistics)
        r("GET", r"^/api/metrics$", self.metrics)

    def _route(self, method: str, pattern: str, handler: Callable) -> None:
        self.routes.append((method, re.compile(pattern), handler))

    def dispatch(self, method: str, path: str, body: Optional[Dict[str, Any]],
                 headers: Dict[str, str]) -> Tuple[int, Any]:
        for m, pattern, handler in self.routes:
            if m != method:
                continue
            match = pattern.match(path)
            if match:
                return handler(match.groupdict(), body, headers)
        return _status(404, "Not found: " + path)

    # ---- endpoints ----------------------------------------------------

    def root(self, params, body, headers):
        return 200, "Welcome to vectordb-tpu (Epsilla-compatible VectorDB)."

    def state(self, params, body, headers):
        return _status(200, "Server is online!")

    def load_db(self, params, body, headers):
        if body is None:
            return _status(400, "Invalid payload.")
        name = body.get("name", "")
        path = body.get("path", "")
        scale = int(body.get("vectorScale", InitTableScale))
        wal = bool(body.get("walEnabled", True))
        status = self.db.load_db(name, path, scale, wal, headers)
        if status.code == DB_ALREADY_EXIST:
            return _status(409, status.message)
        if not status.ok():
            return _status(500, status.message)
        return _status(200, f"Load/Create {name} successfully.")

    def unload_db(self, params, body, headers):
        status = self.db.unload_db(params["db"])
        if not status.ok():
            return _status(500, status.message)
        return _status(200, f"Unload {params['db']} successfully.")

    def release_db(self, params, body, headers):
        status = self.db.release_db(params["db"])
        if not status.ok():
            return _status(500, status.message)
        return _status(200, f"Release {params['db']} successfully.")

    def drop_db(self, params, body, headers):
        status = self.db.unload_db(params["db"])
        if not status.ok():
            return _status(500, status.message)
        return _status(200, f"Drop {params['db']} successfully.")

    def dump_db(self, params, body, headers):
        if body is None:
            return _status(400, "Invalid payload.")
        name = body.get("name", "")
        status = self.db.dump_db(name, body.get("path", ""))
        if status.code == DB_NOT_FOUND:
            return _status(404, status.message)
        if not status.ok():
            return _status(500, status.message)
        return _status(200, f"Dump {name} successfully.")

    def export_reference(self, params, body, headers):
        if body is None:
            return _status(400, "Invalid payload.")
        name = body.get("name", "")
        status = self.db.export_reference_format(name)
        if status.code == DB_NOT_FOUND:
            return _status(404, status.message)
        if not status.ok():
            return _status(500, status.message)
        return _status(200, f"Export {name} in reference format "
                            "successfully.")

    def tune_search(self, params, body, headers):
        if body is None or "table" not in body:
            return _status(400, "table is missing in your payload.")
        status, report = self.db.tune_search(
            params["db"], body["table"], body.get("queryField", ""),
            float(body.get("targetRecall", 0.99)),
            int(body.get("sample", 256)), int(body.get("limit", 10)))
        if status.code == DB_NOT_FOUND:
            return _status(404, status.message)
        if not status.ok():
            return _status(500, status.message)
        return 200, {"statusCode": 200, "message": "Tuned successfully.",
                     "result": report}

    def create_table(self, params, body, headers):
        if body is None:
            return _status(400, "Invalid payload.")
        status, table_id = self.db.create_table(params["db"], body)
        if not status.ok():
            return _status(500 if status.code >= 50000 else 400,
                           status.message)
        resp = {"statusCode": 200,
                "message": f"Create {body.get('name', '')} successfully."}
        if body.get("returnTableId"):
            resp["result"] = {"tableId": table_id}
        return 200, resp

    def drop_table(self, params, body, headers):
        status = self.db.drop_table(params["db"], params["table"])
        if not status.ok():
            return _status(500, status.message)
        return _status(200, f"Drop {params['table']} successfully.")

    def list_tables(self, params, body, headers):
        status, names = self.db.list_tables(params["db"])
        if not status.ok():
            return _status(500, status.message)
        return 200, {"statusCode": 200,
                     "message": f"Get all tables in {params['db']} "
                                "successfully.",
                     "result": names}

    def describe_table(self, params, body, headers):
        db = self.db.get_db(params["db"])
        if db is None:
            return _status(500, "DB not found: " + params["db"])
        table = db.get_table(params["table"])
        if table is None:
            return _status(500, "Table not found: " + params["table"])
        return 200, {"statusCode": 200,
                     "message": f"Get information of {params['table']} from "
                                f"{params['db']} successfully.",
                     "result": table.schema.to_json()}

    def insert(self, params, body, headers):
        if body is None:
            return _status(400, "Invalid payload.")
        if "table" not in body:
            return _status(400, "Missing table name in your payload.")
        if "data" not in body:
            return _status(400, "Missing data in your payload.")
        table = body["table"]
        upsert = bool(body.get("upsert", False))
        status = self.db.insert(params["db"], table, body["data"], headers,
                                upsert)
        if not status.ok():
            return _status(500, status.message)
        result = json.loads(status.message) if status.message else {}
        return 200, {"statusCode": 200,
                     "message": f"Insert data to {table} successfully.",
                     "result": result}

    def insert_prepare(self, params, body, headers):
        if body is None:
            return _status(400, "Invalid payload.")
        if "table" not in body:
            return _status(400, "table is missing in your payload.")
        status, result = self.db.insert_prepare(
            params["db"], body["table"], body.get("primaryKeys", []))
        if not status.ok():
            return _status(500, status.message)
        return 200, {"statusCode": 200, "message": "", "result": result}

    def delete(self, params, body, headers):
        if body is None:
            return _status(400, "Invalid payload.")
        if "table" not in body:
            return _status(400, "Missing table name in your payload.")
        if "primaryKeys" in body and len(body["primaryKeys"]) == 0:
            return _status(
                400, "If the primaryKeys field is provided, it cannot be "
                     "empty.")
        if "primaryKeys" not in body and "filter" not in body:
            return _status(
                400, "Must provide primary key list or filter in your "
                     "payload.")
        status = self.db.delete(params["db"], body["table"],
                                body.get("primaryKeys", []),
                                body.get("filter", ""))
        if not status.ok():
            return _status(400, status.message)
        result = json.loads(status.message) if status.message else {}
        return 200, {"statusCode": 200,
                     "message": f"Delete data from {body['table']} "
                                "successfully.",
                     "result": result}

    def _error_code(self, code: int) -> int:
        if code in (INVALID_EXPR, INVALID_PAYLOAD):
            return 400
        if code == NOT_IMPLEMENTED_ERROR:
            return 501
        return 500

    def query(self, params, body, headers):
        if body is None:
            return _status(400, "Invalid payload.")
        if "table" not in body:
            return _status(400, "table is missing in your payload.")
        if "limit" not in body:
            return _status(400, "limit is missing in your payload.")
        field = body.get("queryField", "")
        if "queryField" in body and "queryIndex" in body:
            return _status(400, "Can only specify either queryField or "
                                "queryIndex, but not both.")
        if "queryIndex" in body:
            field = body["queryIndex"]
        response_fields = body.get("response", [])
        facets_config = body.get("facets", [])

        if "queryVectors" in body:
            # Hybrid dense+sparse fusion (extension over the reference API):
            # queryVectors = [{"field", "vector", "weight"}].
            status, rows, facets = self.db.hybrid_search(
                params["db"], body["table"], body["queryVectors"],
                response_fields, int(body["limit"]), body.get("filter", ""),
                bool(body.get("withDistance", False)),
                body.get("rerank", "rrf"), facets_config)
        elif "queryVector" in body:
            qv = body["queryVector"]
            if isinstance(qv, dict):
                if "indices" not in qv:
                    return _status(400,
                                   "missing indices field for sparse vector")
                if "values" not in qv:
                    return _status(400,
                                   "missing values field for sparse vector")
                if len(qv["indices"]) != len(qv["values"]):
                    return _status(400, "sparse vector indices and values "
                                        "array are of different sizes.")
            status, rows, facets = self.db.search(
                params["db"], body["table"], field, response_fields, qv,
                int(body["limit"]), body.get("filter", ""),
                bool(body.get("withDistance", False)), facets_config,
                columnar=not facets_config)
        elif "query" in body:
            status, rows, facets = self.db.search_by_content(
                params["db"], body["table"], field, response_fields,
                body["query"], int(body["limit"]), body.get("filter", ""),
                bool(body.get("withDistance", False)), facets_config,
                headers)
        else:
            return _status(400, "query or queryVector must be provided.")

        if not status.ok():
            return _status(self._error_code(status.code), status.message)
        if hasattr(rows, "encode_json"):
            # Columnar hot path: the native encoder writes the row-objects
            # JSON straight from column buffers; the rest of the payload
            # is a constant frame. Falls back to dict rows when the
            # native encoder is unavailable or refuses a column.
            encoded = rows.encode_json()
            if encoded is not None:
                return 200, (b'{"statusCode": 200, "message": '
                             b'"Query search successfully.", "result": '
                             + encoded + b"}")
            rows = rows.to_rows()
        return 200, {"statusCode": 200,
                     "message": "Query search successfully.",
                     "result": self._project_result(rows, facets,
                                                    facets_config,
                                                    response_fields)}

    def _project_result(self, rows, facets, facets_config, response_fields):
        """Result shaping (web_controller.hpp:845-862): rows only, facets
        only, or {records, facets}."""
        if not facets_config:
            return rows
        if not response_fields:
            return facets
        return {"records": rows, "facets": facets}

    def get(self, params, body, headers):
        if body is None:
            return _status(400, "Invalid payload.")
        if "table" not in body:
            return _status(400, "table is missing in your payload.")
        response_fields = body.get("response", [])
        facets_config = body.get("facets", [])
        status, rows, facets = self.db.project(
            params["db"], body["table"], response_fields,
            body.get("primaryKeys", []), body.get("filter", ""),
            int(body.get("skip", 0)), int(body.get("limit", -1)),
            facets_config)
        if not status.ok():
            return _status(500, status.message)
        return 200, {"statusCode": 200,
                     "message": "Query get successfully.",
                     "result": self._project_result(rows, facets,
                                                    facets_config,
                                                    response_fields)}

    def load_csv(self, params, body, headers):
        return _status(200, f"Loading csv to {params['db']}.")

    def statistics(self, params, body, headers):
        status, result = self.db.get_statistics(params["db"])
        if not status.ok():
            return _status(500, status.message)
        return 200, {"statusCode": 200, "message": "", "result": result}

    def metrics(self, params, body, headers):
        from ..metrics import metrics as m

        return 200, {"statusCode": 200, "message": "",
                     "result": m.snapshot()}

    def rebuild(self, params, body, headers):
        status = self.db.rebuild()
        if not status.ok():
            return _status(500, status.message)
        return _status(200, "Rebuild finished!")

    def set_leader(self, params, body, headers):
        if body is None:
            return _status(400, "Invalid payload.")
        is_leader = bool(body.get("leader", True))
        self.db.set_leader(is_leader)
        return _status(200, "Set leader as "
                       + ("true" if is_leader else "false")
                       + " successfully.")

    def update_config(self, params, body, headers):
        if body is None:
            return _status(400, "Invalid payload.")
        try:
            ok, swap = global_config.update(body)
            if not ok:
                return _status(500, "Invalid config value.")
            if swap:
                self.db.swap_executors()
        except Exception as ex:
            return _status(500, str(ex))
        return _status(200, "Config updated successfully.")


def create_server(port: int = 8888, db_server: Optional[DBServer] = None,
                  host: str = "0.0.0.0") -> ThreadingHTTPServer:
    rest = RestServer(db_server)

    class Server(ThreadingHTTPServer):
        request_queue_size = 256  # survive large client fan-in
        daemon_threads = True
        # TCP_NODELAY: without it, the headers+body write pattern trips
        # the 40 ms Nagle/delayed-ACK interaction on every response.
        disable_nagle_algorithm = True

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # Buffer the response (status line + headers + body) and flush
        # once per request: the stdlib default wbufsize=0 issues one
        # send() per header line.
        wbufsize = 1 << 16

        def _handle(self, method: str):
            length = int(self.headers.get("Content-Length", 0) or 0)
            raw = self.rfile.read(length) if length else b""
            body = None
            if raw:
                try:
                    body = json.loads(raw.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    body = None
            fwd = {h: self.headers[h] for h in API_KEY_HEADERS
                   if self.headers.get(h)}
            try:
                code, payload = rest.dispatch(method, self.path, body, fwd)
            except Exception as e:  # engine errors must not kill the server
                logger.error(f"request failed: {e}")
                code, payload = _status(500, str(e))
            if isinstance(payload, (bytes, bytearray)):
                data = payload  # pre-encoded JSON (columnar hot path)
                ctype = "application/json"
            elif isinstance(payload, str):
                data = payload.encode("utf-8")
                ctype = "text/plain"
            else:
                # Native C encoder: stdlib float repr makes response
                # serialization a single-core hot path for vector rows.
                data = dumps_bytes(payload)
                ctype = "application/json"
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()
            self.wfile.write(data)
            self.wfile.flush()  # one buffered send per response

        def do_GET(self):
            self._handle("GET")

        def do_POST(self):
            self._handle("POST")

        def do_DELETE(self):
            self._handle("DELETE")

        def do_OPTIONS(self):
            self.send_response(204)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods",
                             "GET, POST, DELETE, OPTIONS")
            self.send_header("Access-Control-Allow-Headers",
                             ", ".join(["Content-Type"] + API_KEY_HEADERS))
            self.end_headers()

        def log_message(self, fmt, *args):  # request log via engine logger
            logger.info("%s - %s" % (self.address_string(), fmt % args))

    return Server((host, port), Handler)
