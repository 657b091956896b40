"""The REST server of vectordb_tpu_torch held against vectordb_tpu's.

Every endpoint case of tests/test_rest.py is dispatched with the same
payloads to both packages' RestServer, each over its own DBServer and data
directory; status codes, messages and results must be equal (floats
within rtol 1e-5: both report exact f32 re-ranked distances, summed in
different orders). Also: one round trip over a real socket, query by
content through a mock embedding sidecar, and hybrid and sparse queries.
"""
import glob
import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from vectordb_tpu.config import global_config as jax_config
from vectordb_tpu.db_server import DBServer as JaxDBServer
from vectordb_tpu.rest.server import RestServer as JaxRest
from vectordb_tpu.services import EmbeddingService as JaxEmbedding
import vectordb_tpu_torch as tvdb
from vectordb_tpu_torch.config import global_config as torch_config
from vectordb_tpu_torch.db_server import DBServer
from vectordb_tpu_torch.rest.server import RestServer, create_server
from vectordb_tpu_torch.services import EmbeddingService

RECORDS = [
    {"ID": 1, "Doc": "Berlin", "Embedding": [0.05, 0.61, 0.76, 0.74]},
    {"ID": 2, "Doc": "London", "Embedding": [0.19, 0.81, 0.75, 0.11]},
    {"ID": 3, "Doc": "Moscow", "Embedding": [0.36, 0.55, 0.47, 0.94]},
]

SCHEMA = {
    "name": "t",
    "fields": [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "Doc", "dataType": "STRING"},
        {"name": "Embedding", "dataType": "VECTOR_FLOAT", "dimensions": 4,
         "metricType": "EUCLIDEAN"},
    ],
}

MIX_SCHEMA = {
    "name": "mix",
    "fields": [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "Doc", "dataType": "STRING"},
        {"name": "Score", "dataType": "DOUBLE"},
        {"name": "Flag", "dataType": "BOOL"},
        {"name": "Meta", "dataType": "JSON"},
        {"name": "Embedding", "dataType": "VECTOR_FLOAT",
         "dimensions": 4, "metricType": "EUCLIDEAN"},
    ],
}

MIX_RECORDS = [
    {"ID": i, "Doc": f"doc-{i}" if i != 2 else 'q"uo\\te',
     "Score": 0.1 * i, "Flag": i % 2 == 0,
     "Meta": {"k": i, "tags": ["a", "b"]} if i != 3 else None,
     "Embedding": [0.1 * i, 0.2, 0.3, 0.4 + 0.01 * i]}
    for i in range(1, 6)
]


def _decode(payload):
    if isinstance(payload, (bytes, bytearray)):
        return json.loads(payload)
    return payload


def _same(a, b, where="payload"):
    if isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-5, abs=1e-6), where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, a, b)
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


class Both:
    """One RestServer per package, each with db1 loaded in its own dir."""

    def __init__(self, tmp_path):
        self.tmp = tmp_path
        self.jax = JaxRest(JaxDBServer())
        self.port = RestServer(DBServer())
        for rest, sub in ((self.jax, "j"), (self.port, "t")):
            code, resp = rest.dispatch(
                "POST", "/api/load",
                {"name": "db1", "path": str(tmp_path / sub / "db1")}, {})
            assert code == 200, resp

    def call(self, method, path, body=None, compare=True):
        """Dispatch to both; returns the port's (code, decoded payload)
        after checking it equals the JAX package's."""
        jc, jp = self.jax.dispatch(method, path, body, {})
        tc, tp = self.port.dispatch(method, path, body, {})
        jp, tp = _decode(jp), _decode(tp)
        assert tc == jc, (path, tc, tp, jc, jp)
        if compare:
            _same(tp, jp, path)
        return tc, tp

    def close(self):
        self.jax.db.stop()
        self.port.db.stop()


@pytest.fixture(autouse=True)
def _cpu_port():
    tvdb.set_device("cpu")  # the CPU run of the port: plain versions
    yield
    tvdb._reset_for_tests()


@pytest.fixture
def both(tmp_path):
    saved_t, saved_j = dict(vars(torch_config)), dict(vars(jax_config))
    b = Both(tmp_path)
    yield b
    b.close()
    vars(torch_config).update(saved_t)
    vars(jax_config).update(saved_j)


def _table(both, schema=SCHEMA, records=RECORDS):
    code, _ = both.call("POST", "/api/db1/schema/tables", schema)
    assert code == 200
    code, resp = both.call("POST", "/api/db1/data/insert",
                           {"table": schema["name"], "data": records})
    assert code == 200
    return resp


class TestEndpoints:
    def test_state_and_root(self, both):
        code, resp = both.call("GET", "/state")
        assert code == 200 and resp["message"] == "Server is online!"
        code, resp = both.call("GET", "/")
        assert code == 200 and isinstance(resp, str)
        code, _ = both.call("GET", "/no/such/route")
        assert code == 404

    def test_load_conflict(self, both, tmp_path):
        code, resp = both.call("POST", "/api/load",
                               {"name": "db1", "path": str(tmp_path / "x")})
        assert code == 409

    def test_crud_flow(self, both):
        resp = _table(both)
        assert resp["result"]["inserted"] == 3
        code, resp = both.call("POST", "/api/db1/data/query",
                               {"table": "t", "queryField": "Embedding",
                                "queryVector": [0.36, 0.55, 0.47, 0.94],
                                "limit": 2, "response": ["Doc"],
                                "withDistance": True})
        assert code == 200
        assert resp["message"] == "Query search successfully."
        assert resp["result"][0]["Doc"] == "Moscow"
        assert "@distance" in resp["result"][0]
        code, resp = both.call("GET", "/api/db1/schema/tables/show")
        assert resp["result"] == ["t"]
        code, resp = both.call("GET", "/api/db1/statistics")
        assert resp["result"]["tables"][0]["totalRecordCount"] == 3
        code, resp = both.call("POST", "/api/db1/data/delete",
                               {"table": "t", "primaryKeys": [2]})
        assert code == 200 and resp["result"]["deleted"] == 1
        code, resp = both.call("POST", "/api/db1/data/get",
                               {"table": "t", "response": ["ID"]})
        assert sorted(r["ID"] for r in resp["result"]) == [1, 3]
        code, _ = both.call("DELETE", "/api/db1/schema/tables/t")
        assert code == 200

    def test_filtered_query_and_get(self, both):
        _table(both)
        for flt in ("ID > 1", "Doc = 'London'", "ID > 1 AND ID < 3"):
            code, resp = both.call("POST", "/api/db1/data/query",
                                   {"table": "t", "limit": 3,
                                    "queryVector": [0.1] * 4,
                                    "response": ["ID", "Doc"],
                                    "filter": flt, "withDistance": True})
            assert code == 200 and resp["result"], flt
            code, resp = both.call("POST", "/api/db1/data/get",
                                   {"table": "t", "filter": flt})
            assert code == 200 and resp["result"], flt

    def test_insertprepare(self, both):
        _table(both)
        code, resp = both.call("POST", "/api/db1/data/insertprepare",
                               {"table": "t", "primaryKeys": [1, 99]})
        assert code == 200
        assert resp["result"]["recordNumber"] == 3
        # bit i clear => pk exists (reference mask semantics)
        assert resp["result"]["masks"][0] & 1 == 0
        assert resp["result"]["masks"][0] & 2 == 2
        code, _ = both.call("POST", "/api/db1/data/insertprepare", {})
        assert code == 400

    def test_query_validation(self, both):
        both.call("POST", "/api/db1/schema/tables", SCHEMA)
        for body, want in (
                ({"table": "t"}, 400),              # missing limit
                ({"limit": 5}, 400),                # missing table
                ({"table": "t", "limit": 5}, 400),  # no query
                ({"table": "t", "limit": 5, "queryVector": [0.0] * 4,
                  "filter": "Bogus < 3"}, 400),     # invalid filter
                ({"table": "t", "limit": 5, "queryField": "Embedding",
                  "queryIndex": "x", "queryVector": [0.0] * 4}, 400),
                ({"table": "t", "limit": 5, "queryVector": [0.0] * 3},
                 500),                              # dimension mismatch
                ({"table": "nosuch", "limit": 5,
                  "queryVector": [0.0] * 4}, 500),
                ({"table": "t", "limit": 5,
                  "queryVector": {"values": [1.0]}}, 400),
                ({"table": "t", "limit": 5,
                  "queryVector": {"indices": [1], "values": []}}, 400)):
            code, _ = both.call("POST", "/api/db1/data/query", body)
            assert code == want, body
        code, _ = both.call("POST", "/api/db1/data/query", None)
        assert code == 400

    def test_delete_validation(self, both):
        both.call("POST", "/api/db1/schema/tables", SCHEMA)
        for body in ({"table": "t"}, {"table": "t", "primaryKeys": []},
                     {"primaryKeys": [1]}, None):
            code, _ = both.call("POST", "/api/db1/data/delete", body)
            assert code == 400

    def test_facets_via_rest(self, both):
        _table(both)
        code, resp = both.call("POST", "/api/db1/data/query",
                               {"table": "t", "queryVector": [0.0] * 4,
                                "limit": 3, "response": [],
                                "facets": [{"group": [],
                                            "aggregate": ["COUNT(*)"]}]})
        assert code == 200
        assert resp["result"][0][0]["COUNT(*)"] == 3
        code, resp = both.call("POST", "/api/db1/data/get",
                               {"table": "t", "response": ["ID"],
                                "facets": [{"group": ["Doc"],
                                            "aggregate": ["COUNT(*)"]}]})
        assert code == 200 and set(resp["result"]) == {"records", "facets"}

    def test_config_endpoint(self, both):
        code, _ = both.call("POST", "/api/config", {"SearchEf": 96})
        assert code == 200
        assert torch_config.search_ef == jax_config.search_ef == 96
        code, _ = both.call("POST", "/api/config", {"NoSuchKey": 1})
        code, _ = both.call("POST", "/api/config", None)
        assert code == 400

    def test_config_build_search_params(self, both):
        code, _ = both.call("POST", "/api/config",
                            {"BuildSearchL": 48, "BuildSearchIters": 16})
        assert code == 200
        assert torch_config.build_search_l == 48
        assert torch_config.build_search_iters == 16
        # Out of range, and transactional over several keys.
        for body in ({"BuildSearchL": 4},
                     {"BuildSearchL": 96, "BuildSearchIters": 300},
                     {"BuildSearchIters": 300}):
            code, _ = both.call("POST", "/api/config", body)
            assert code == 500
            assert torch_config.build_search_l == 48
            assert torch_config.build_search_iters == 16
        code, _ = both.call("POST", "/api/config",
                            {"BuildSearchL": 0, "BuildSearchIters": 0})
        assert code == 200

    def test_setleader(self, both):
        code, resp = both.call("POST", "/api/setleader", {"leader": False})
        assert code == 200
        assert both.port.db.is_leader is False
        assert both.port.db.catalog.is_leader is False
        code, _ = both.call("POST", "/api/setleader", None)
        assert code == 400

    def test_rebuild_endpoint(self, both):
        _table(both)
        code, resp = both.call("POST", "/api/rebuild")
        assert code == 200 and resp["message"] == "Rebuild finished!"

    def test_describe(self, both):
        both.call("POST", "/api/db1/schema/tables", SCHEMA)
        code, resp = both.call("GET", "/api/db1/schema/tables/t/describe")
        assert code == 200
        names = [f["name"] for f in resp["result"]["fields"]]
        assert names == ["ID", "Doc", "Embedding"]
        code, _ = both.call("GET", "/api/db1/schema/tables/zz/describe")
        assert code == 500
        code, _ = both.call("GET", "/api/nodb/schema/tables/t/describe")
        assert code == 500

    def test_create_table_errors_and_table_id(self, both):
        code, resp = both.call("POST", "/api/db1/schema/tables",
                               dict(SCHEMA, returnTableId=True))
        assert code == 200 and "tableId" in resp["result"]
        code, _ = both.call("POST", "/api/db1/schema/tables", SCHEMA)
        assert code != 200
        code, _ = both.call("POST", "/api/db1/schema/tables",
                            {"name": "bad", "fields": [
                                {"name": "X", "dataType": "NOPE"}]})
        assert code == 500
        code, _ = both.call("POST", "/api/nodb/schema/tables", SCHEMA)
        assert code == 500

    def test_dump_unload_release_drop(self, both, tmp_path):
        _table(both)
        code, _ = both.call("POST", "/api/dump", {"name": "nosuch",
                                                  "path": "unused"})
        assert code == 404
        for rest, sub in ((both.jax, "j"), (both.port, "t")):
            code, resp = rest.dispatch(
                "POST", "/api/dump",
                {"name": "db1", "path": str(tmp_path / sub / "dump")}, {})
            assert code == 200, resp
        code, _ = both.call("POST", "/api/db1/unload")
        assert code == 200
        code, _ = both.call("POST", "/api/db1/unload")
        assert code == 500
        for rest, sub in ((both.jax, "j"), (both.port, "t")):
            code, _ = rest.dispatch(
                "POST", "/api/load",
                {"name": "db2", "path": str(tmp_path / sub / "dump")}, {})
            assert code == 200
        code, resp = both.call("GET", "/api/db2/statistics")
        assert resp["result"]["tables"][0]["totalRecordCount"] == 3
        code, _ = both.call("POST", "/api/db2/release")
        assert code == 200
        code, _ = both.call("DELETE", "/api/db2/drop")
        assert code == 500  # already released

    def test_export_reference_endpoint(self, both, tmp_path):
        _table(both)
        code, resp = both.call("POST", "/api/exportreference",
                               {"name": "db1"})
        assert code == 200, resp
        assert glob.glob(str(tmp_path / "t" / "db1" / "*" / "data_mvp.bin"))
        code, _ = both.call("POST", "/api/exportreference", {"name": "x"})
        assert code == 404

    def test_tune_search_and_metrics(self, both):
        _table(both)
        code, _ = both.call("POST", "/api/db1/data/tunesearch", {})
        assert code == 400
        code, resp = both.call("POST", "/api/db1/data/tunesearch",
                               {"table": "t"})
        assert code == 200 and resp["result"] == {}  # no graph: flat
        code, resp = both.call("GET", "/api/metrics", compare=False)
        assert code == 200 and "queries_total" in json.dumps(resp)
        code, resp = both.call("POST", "/api/db1/data/load", {})
        assert code == 200

    def test_columnar_query_payload_matches_dict_rows(self, both):
        """The columnar bytes decode to the rows the dict projection gives
        (floats at f32 precision: the native encoder writes %.9g)."""
        _table(both, MIX_SCHEMA, MIX_RECORDS)
        qv = [0.2, 0.2, 0.3, 0.44]
        code, got = both.call("POST", "/api/db1/data/query",
                              {"table": "mix", "queryField": "Embedding",
                               "queryVector": qv, "limit": 4,
                               "withDistance": True})
        assert code == 200
        status, rows, _ = both.port.db.search(
            "db1", "mix", "Embedding", [], np.asarray(qv, np.float32), 4,
            "", True, None, columnar=False)
        assert status.ok()
        _same(got["result"], rows)

    def test_columnar_falls_back_without_native(self, both, monkeypatch):
        from vectordb_tpu import fastjson as jfast
        from vectordb_tpu_torch import fastjson as tfast
        monkeypatch.setattr(jfast, "_native_dumps_rows", None)
        monkeypatch.setattr(tfast, "_native_dumps_rows", None)
        _table(both)
        code, resp = both.call("POST", "/api/db1/data/query",
                               {"table": "t", "queryField": "Embedding",
                                "queryVector": [0.36, 0.55, 0.47, 0.94],
                                "limit": 2, "response": ["Doc"],
                                "withDistance": True})
        assert code == 200 and resp["result"][0]["Doc"] == "Moscow"


def test_hybrid_and_sparse_queries_answer_501(tmp_path):
    """Sparse (`queryVector` as {indices, values}) and hybrid
    (`queryVectors`) bodies no longer answer 501: they answer 200 with the
    JAX package's results, filtered or not."""
    both = Both(tmp_path)
    try:
        code, _ = both.call("POST", "/api/db1/schema/tables", {
            "name": "t", "fields": [
                {"name": "ID", "dataType": "INT", "primaryKey": True},
                {"name": "D", "dataType": "VECTOR_FLOAT", "dimensions": 4},
                {"name": "S", "dataType": "SPARSE_VECTOR_FLOAT",
                 "dimensions": 100, "metricType": "DOT_PRODUCT"}]})
        assert code == 200
        rng = np.random.default_rng(3)
        data = [{"ID": i, "D": rng.normal(size=4).round(3).tolist(),
                 "S": {"indices": sorted(rng.choice(12, 4, replace=False)
                                         .tolist()),
                       "values": rng.uniform(0.1, 2.0, 4).round(3).tolist()}}
                for i in range(40)]
        code, _ = both.call("POST", "/api/db1/data/insert",
                            {"table": "t", "data": data})
        assert code == 200
        sparse = {"indices": data[7]["S"]["indices"],
                  "values": [1.0, 0.7, 0.4, 0.2]}
        for flt in ("", "ID < 20"):
            for body in ({"queryField": "S", "queryVector": sparse},
                         {"queryVectors": [
                             {"field": "D", "vector": data[7]["D"]},
                             {"field": "S", "vector": sparse,
                              "weight": 0.5}]},
                         {"queryVectors": [
                             {"field": "D", "vector": data[7]["D"]},
                             {"field": "S", "vector": sparse}],
                          "rerank": "weighted"}):
                code, resp = both.call("POST", "/api/db1/data/query", dict(
                    body, table="t", limit=5, response=["ID"],
                    withDistance=True, filter=flt))
                assert code == 200, resp
                assert len(resp["result"]) == 5
                if flt:
                    assert all(r["ID"] < 20 for r in resp["result"])
    finally:
        both.close()


def test_http_round_trip(tmp_path):
    """A real socket: create_server on port 0, load, create, insert, then
    concurrent queries (reference test/concurrency/test.py)."""
    httpd = create_server(0, DBServer(), host="127.0.0.1")
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        def post(path, body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=json.dumps(body).encode(), method="POST",
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        with urllib.request.urlopen(f"http://127.0.0.1:{port}/state",
                                    timeout=30) as r:
            assert json.loads(r.read())["message"] == "Server is online!"
        assert post("/api/load", {"name": "live",
                                  "path": str(tmp_path / "live")})[0] == 200
        assert post("/api/live/schema/tables", SCHEMA)[0] == 200
        assert post("/api/live/data/insert",
                    {"table": "t", "data": RECORDS})[0] == 200
        code, resp = post("/api/live/data/query",
                          {"table": "t", "queryVector": [0.36, 0.55, 0.47,
                                                         0.94],
                           "limit": 1, "response": ["Doc"],
                           "filter": "ID >= 2"})
        assert code == 200 and resp["result"][0]["Doc"] == "Moscow"
        assert post("/api/live/data/query", {"table": "t"})[0] == 400
        errors = []

        def worker():
            try:
                for _ in range(5):
                    c, rr = post("/api/live/data/query",
                                 {"table": "t", "queryVector": [0.1] * 4,
                                  "limit": 2, "response": ["ID"]})
                    assert c == 200 and len(rr["result"]) == 2
            except Exception as e:  # collected for the assert below
                errors.append(e)

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        assert not any(t.is_alive() for t in threads)
    finally:
        httpd.shutdown()
        httpd.server_close()


DIM = 4


def _embed(text):
    h = sum((i + 1) * ord(ch) for i, ch in enumerate(text))
    v = np.asarray([(h >> (3 * i)) % 251 + 1 for i in range(DIM)],
                   np.float32)
    return (v / np.linalg.norm(v)).tolist()


class _Sidecar(BaseHTTPRequestHandler):
    def _send(self, obj):
        data = json.dumps(obj).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        self._send({"statusCode": 200, "result": [
            {"model": "BAAI/bge-small-en-v1.5", "dim": DIM, "dense": True,
             "dimensionReduction": False}]})

    def do_POST(self):
        body = json.loads(self.rfile.read(
            int(self.headers["Content-Length"])))
        self._send({"statusCode": 200,
                    "result": [_embed(t) for t in body.get("documents", [])]})

    def log_message(self, *a):
        pass


def test_query_by_content_matches_jax(tmp_path):
    """`query` text routes through the embedding sidecar (reference
    SearchByContent) in both packages, with the same answers."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Sidecar)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    servers = []
    try:
        results = []
        for srv_cls, rest_cls, emb_cls, sub in (
                (JaxDBServer, JaxRest, JaxEmbedding, "j"),
                (DBServer, RestServer, EmbeddingService, "t")):
            eng = srv_cls()
            servers.append(eng)
            eng.inject_embedding_service(emb_cls(url))
            rest = rest_cls(eng)
            out = [rest.dispatch("POST", "/api/load",
                                 {"name": "cdb",
                                  "path": str(tmp_path / sub)}, {}),
                   rest.dispatch("POST", "/api/cdb/schema/tables", {
                       "name": "docs",
                       "fields": [
                           {"name": "ID", "dataType": "INT",
                            "primaryKey": True},
                           {"name": "Doc", "dataType": "STRING"}],
                       "indices": [{"name": "DocIdx", "field": "Doc",
                                    "model": "BAAI/bge-small-en-v1.5"}]},
                       {}),
                   rest.dispatch("POST", "/api/cdb/data/insert", {
                       "table": "docs", "data": [
                           {"ID": 1, "Doc": "alpha"},
                           {"ID": 2, "Doc": "beta"},
                           {"ID": 3, "Doc": "gamma"}]}, {})]
            for word in ("beta", "gamma"):
                out.append(rest.dispatch(
                    "POST", "/api/cdb/data/query",
                    {"table": "docs", "query": word, "limit": 1,
                     "response": ["ID", "Doc"], "withDistance": True}, {}))
            out.append(rest.dispatch(
                "POST", "/api/cdb/data/query",
                {"table": "docs", "query": "beta", "limit": 1,
                 "queryIndex": "NoIdx"}, {}))
            results.append([(c, _decode(p)) for c, p in out])
        jres, tres = results
        assert [c for c, _ in tres] == [200, 200, 200, 200, 200, 400]
        assert tres[3][1]["result"][0]["ID"] == 2
        assert tres[4][1]["result"][0]["ID"] == 3
        for (tc, tp), (jc, jp) in zip(tres, jres):
            assert tc == jc
            _same(tp, jp)
    finally:
        for eng in servers:
            eng.stop()
        httpd.shutdown()
