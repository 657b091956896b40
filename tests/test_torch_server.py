"""The server side of vectordb_tpu_torch held against vectordb_tpu: the CLI
(`python -m vectordb_tpu_torch`), the periodic rebuild thread, the
leader/follower cases of tests/test_leader_follower.py and the embedding
cases of tests/test_embedding.py (both packages against one mock
sidecar)."""
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

import vectordb_tpu as jvdb
import vectordb_tpu_torch as tvdb
from vectordb_tpu.db_server import DBServer as JaxDBServer
from vectordb_tpu.errors import VectorDBError as JaxVectorDBError
from vectordb_tpu.services import EmbeddingService as JaxEmbedding
from vectordb_tpu_torch.__main__ import parse_args, str2bool
from vectordb_tpu_torch.config import global_config as torch_config
from vectordb_tpu_torch.db_server import DBServer
from vectordb_tpu_torch.errors import VectorDBError
from vectordb_tpu_torch.services import EmbeddingService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCHEMA = {
    "name": "t",
    "fields": [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "V", "dataType": "VECTOR_FLOAT", "dimensions": 8,
         "metricType": "EUCLIDEAN"},
    ],
}


@pytest.fixture(autouse=True)
def _reset_port():
    saved = dict(vars(torch_config))
    tvdb.set_device("cpu")  # the CPU run of the port: plain versions
    yield
    tvdb._reset_for_tests()
    vars(torch_config).update(saved)


def records(lo, hi, rng):
    return [{"ID": i, "V": rng.normal(size=8).astype(float).tolist()}
            for i in range(lo, hi)]


# ---------------------------------------------------------------------------
# CLI.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv,want", [
    ([], (8888, True, True, "http://localhost:8889", "cuda")),
    (["-p", "1234", "-r", "false", "-l", "0"],
     (1234, False, False, "http://localhost:8889", "cuda")),
    (["--port", "9", "--rebuild", "true", "--leader", "no",
      "--embedding_baseurl", "http://side:1"],
     (9, True, False, "http://side:1", "cuda")),
    (["-e", "http://x:2", "-l", "TRUE", "-r", "False"],
     (8888, False, True, "http://x:2", "cuda")),
    (["--device", "cpu"], (8888, True, True, "http://localhost:8889", "cpu")),
])
def test_cli_flags(argv, want):
    a = parse_args(argv)
    assert (a.port, a.rebuild, a.leader, a.embedding_baseurl,
            a.device) == want


def test_cli_rejects_bad_port():
    with pytest.raises(SystemExit):
        parse_args(["-p", "eighty"])
    with pytest.raises(SystemExit):
        parse_args(["--device", "tpu"])
    assert [str2bool(v) for v in ("false", "0", "no", "1", "yes")] == [
        False, False, False, True, True]


@pytest.mark.parametrize("sig", [signal.SIGINT, signal.SIGTERM])
def test_cli_serves_and_stops_on_signal(tmp_path, sig):
    """`python -m vectordb_tpu_torch` as users start it: it answers over
    HTTP, names its device in the log, and exits 0 on SIGINT or SIGTERM."""
    log = tmp_path / "server.log"
    env = dict(os.environ, PYTHONPATH=REPO)
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "vectordb_tpu_torch", "-p", "0",
             "-r", "false", "--device", "cpu"], stdout=f,
            stderr=subprocess.STDOUT, env=env, cwd=str(tmp_path))
    try:
        port = None
        deadline = time.time() + 120
        while port is None and time.time() < deadline:
            m = re.search(r"listening on port (\d+)", log.read_text())
            port = int(m.group(1)) if m else None
            if proc.poll() is not None:
                break
            time.sleep(0.2)
        assert port, log.read_text()
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/state", timeout=30) as r:
            assert json.loads(r.read())["message"] == "Server is online!"
        req = urllib.request.Request(
            base + "/api/load", method="POST",
            data=json.dumps({"name": "c",
                             "path": str(tmp_path / "c")}).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
        proc.send_signal(sig)
        assert proc.wait(timeout=60) == 0, log.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    text = log.read_text()
    assert "serving device: cpu" in text
    assert "server stopped" in text


def test_cli_refuses_to_start_without_a_card(tmp_path):
    """Without a CUDA device and without --device cpu the server does not
    fall back to the CPU: it exits 2 and names the flag. CUDA_VISIBLE_DEVICES
    is emptied so that this holds on a machine with a card too."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "vectordb_tpu_torch", "-p", "0", "-r",
         "false"], capture_output=True, text=True, env=env,
        cwd=str(tmp_path), timeout=120)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "--device cpu" in proc.stderr
    assert "listening" not in proc.stdout + proc.stderr


def test_library_refuses_to_run_without_a_card(tmp_path, monkeypatch):
    """The library raises without a CUDA device unless the CPU was asked
    for with set_device("cpu"); it never picks the CPU by itself."""
    tvdb._reset_for_tests()  # back to the default request: cuda
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="set_device"):
        tvdb.load_db("x", str(tmp_path / "x"))
    with pytest.raises(RuntimeError, match="set_device"):
        DBServer()
    with pytest.raises(ValueError):
        tvdb.set_device("tpu")
    tvdb.set_device("cpu")
    assert tvdb.load_db("x", str(tmp_path / "x")) == 0


# ---------------------------------------------------------------------------
# The rebuild thread.
# ---------------------------------------------------------------------------


def _graph_table(eng, path, n=6000):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    assert eng.load_db("db", str(path)).ok()
    assert eng.create_table("db", SCHEMA)[0].ok()
    assert eng.insert_columns("db", "t", {"ID": np.arange(n), "V": x}).ok()
    return eng.get_db("db").get_table("t"), x


def _wait_for(cond, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


def test_rebuild_thread_builds_graph_and_stop_joins(tmp_path):
    torch_config.rebuild_interval_s = 0.2
    eng = DBServer()
    table, x = _graph_table(eng, tmp_path / "db")
    assert table.graphs["V"] is None
    eng.start_rebuild()
    thread = eng._rebuild_thread
    assert thread is not None and thread.is_alive()
    eng.start_rebuild()  # idempotent
    assert eng._rebuild_thread is thread
    assert _wait_for(lambda: table.graphs["V"] is not None), \
        "the rebuild thread built no graph"
    assert table.graphs["V"].num_rows == 6000
    _, rows, _ = eng.search("db", "t", "V", ["ID"], x[42], 1)
    assert rows[0]["ID"] == 42
    eng.stop()
    assert not thread.is_alive() and eng._rebuild_thread is None


def test_rebuild_thread_survives_failed_cycles(tmp_path, monkeypatch):
    """A cycle that raises and one that returns an error are logged; the
    thread goes on and a later cycle builds the graph."""
    torch_config.rebuild_interval_s = 0.05
    eng = DBServer()
    table, _ = _graph_table(eng, tmp_path / "db", n=1000)
    outcomes = []
    real = DBServer.rebuild

    def flaky(self):
        outcomes.append(len(outcomes))
        if len(outcomes) == 1:
            raise RuntimeError("transient device fault")
        if len(outcomes) == 2:
            from vectordb_tpu_torch.errors import DB_UNEXPECTED_ERROR, Status
            return Status(DB_UNEXPECTED_ERROR, "cycle failed")
        return real(self)

    monkeypatch.setattr(DBServer, "rebuild", flaky)
    lines = []
    from vectordb_tpu_torch import db_server as dbs
    monkeypatch.setattr(dbs.logger, "error", lines.append)
    eng.start_rebuild()
    assert _wait_for(lambda: table.graphs["V"] is not None)
    eng.stop()
    assert eng._rebuild_thread is None
    assert any("transient device fault" in ln for ln in lines), lines
    assert any("cycle failed" in ln for ln in lines), lines


def test_executor_stop_cancels_queued_work():
    """Work still queued when the executor loop ends is cancelled, so a
    waiter (a rebuild cycle, a request) raises instead of hanging."""
    from concurrent.futures import CancelledError

    from vectordb_tpu_torch.executor import DeviceExecutor

    ex = DeviceExecutor()
    loop = threading.Thread(target=ex.run_loop)
    loop.start()
    assert _wait_for(lambda: ex.loop_active, timeout=30)
    started, release = threading.Event(), threading.Event()

    def block():
        started.set()
        release.wait(30)
        return "done"

    first = ex.submit(block)
    assert started.wait(30)
    queued = ex.submit(lambda: "never")
    ex.stop()
    release.set()
    loop.join(timeout=30)
    assert not loop.is_alive()
    assert first.result(timeout=30) == "done"
    with pytest.raises(CancelledError):
        queued.result(timeout=30)
    assert ex.run(lambda: 7) == 7  # no loop: runs inline


def test_reset_for_tests_stops_rebuild_thread(tmp_path):
    torch_config.rebuild_interval_s = 3600
    eng = DBServer()
    eng.start_rebuild()
    thread = eng._rebuild_thread
    assert thread.is_alive()
    tvdb._db = eng
    tvdb._reset_for_tests()
    assert not thread.is_alive()


# ---------------------------------------------------------------------------
# Leader / follower (tests/test_leader_follower.py, both packages).
# ---------------------------------------------------------------------------

SERVERS = [pytest.param(JaxDBServer, id="jax"),
           pytest.param(DBServer, id="torch")]


@pytest.mark.parametrize("server_cls", SERVERS)
def test_follower_never_writes(tmp_path, server_cls):
    eng = server_cls()
    eng.set_leader(False)
    path = str(tmp_path / "fdb")
    assert eng.load_db("fdb", path).ok()
    st, _ = eng.create_table("fdb", SCHEMA)
    assert st.ok()
    rng = np.random.default_rng(0)
    assert eng.insert("fdb", "t", records(0, 50, rng)).ok()
    eng.rebuild()
    eng.dump_db("fdb", path)
    assert not os.path.exists(os.path.join(path, "catalog"))
    wal_dir = os.path.join(path, "0", "wal")
    if os.path.isdir(wal_dir):
        assert all(os.path.getsize(os.path.join(wal_dir, f)) <= 8
                   for f in os.listdir(wal_dir)
                   if f.endswith((".log", ".blog")))
    assert not os.path.exists(os.path.join(path, "0", "data.vdb"))
    eng.stop()


@pytest.mark.parametrize("leader_cls", SERVERS)
@pytest.mark.parametrize("follower_cls", SERVERS)
def test_follower_reloads_leader_state(tmp_path, leader_cls, follower_cls):
    """Either package's follower reads either package's leader."""
    path = str(tmp_path / "shared")
    rng = np.random.default_rng(1)
    leader = leader_cls()
    leader.load_db("db", path)
    leader.create_table("db", SCHEMA)
    leader.insert("db", "t", records(0, 200, rng))
    leader.dump_db("db", path)
    leader.stop()
    follower = follower_cls()
    follower.set_leader(False)
    assert follower.load_db("db", path).ok()
    st, rows, _ = follower.project("db", "t", ["ID"], [], "", 0, -1)
    assert st.ok() and sorted(r["ID"] for r in rows) == list(range(200))
    follower.stop()


@pytest.mark.parametrize("server_cls", SERVERS)
def test_follower_reloads_graph_built_by_leader(tmp_path, server_cls):
    path = str(tmp_path / "gshared")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(300, 8)).astype(np.float32)
    leader = server_cls()
    leader.load_db("db", path)
    leader.create_table("db", SCHEMA)
    leader.insert("db", "t",
                  [{"ID": i, "V": x[i].tolist()} for i in range(300)])
    assert leader.rebuild().ok()
    leader.dump_db("db", path)
    assert os.path.exists(os.path.join(path, "0", "ann_graph_1.npz"))
    leader.stop()
    follower = DBServer()
    follower.set_leader(False)
    follower.load_db("db", path)
    table = follower.get_db("db").get_table("t")
    assert table.graphs["V"] is not None and table.graphs["V"].num_rows == 300
    assert not table.is_leader and not table.wal.is_leader
    _, rows, _ = follower.search("db", "t", "V", ["ID"], x[7], 1)
    assert rows[0]["ID"] == 7
    follower.stop()


def test_set_leader_reaches_tables(tmp_path):
    eng = DBServer()
    eng.load_db("db", str(tmp_path / "db"))
    eng.create_table("db", SCHEMA)
    table = eng.get_db("db").get_table("t")
    eng.set_leader(False)
    assert not (eng.catalog.is_leader or table.is_leader
                or table.wal.is_leader or eng.get_db("db").is_leader)
    eng.set_leader(True)
    assert eng.catalog.is_leader and table.is_leader and table.wal.is_leader


def test_insert_and_query_during_rebuild(tmp_path):
    """Queries and inserts stay correct while rebuild() runs (reference
    InsertAndQueryDenseVectorDuringRebuild)."""
    tvdb.load_db("cdb", str(tmp_path / "cdb"))
    tvdb.use_db("cdb")
    tvdb.create_table("t", SCHEMA["fields"])
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2000, 8)).astype(np.float32)
    tvdb.insert("t", [{"ID": i, "V": x[i].tolist()} for i in range(500)])
    errors = []
    stop = threading.Event()

    def rebuild_loop():
        try:
            for _ in range(3):
                assert tvdb.rebuild() == 0
        except Exception as e:  # collected for the assert below
            errors.append(e)
        finally:
            stop.set()

    def insert_loop():
        i = 500
        try:
            while not stop.is_set() and i < 2000:
                tvdb.insert("t", [{"ID": j, "V": x[j].tolist()}
                                  for j in range(i, i + 100)])
                i += 100
        except Exception as e:
            errors.append(e)

    def query_loop():
        try:
            while not stop.is_set():
                _, res = tvdb.query("t", "V", x[42].tolist(), ["ID"], 1)
                assert res[0]["ID"] == 42, res
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=f)
               for f in (rebuild_loop, insert_loop, query_loop)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    _, res = tvdb.query("t", "V", x[42].tolist(), ["ID"], 1)
    assert res[0]["ID"] == 42
    assert tvdb.statistics()[1]["tables"][0]["totalRecordCount"] >= 500


# ---------------------------------------------------------------------------
# Embedding service (tests/test_embedding.py, both packages).
# ---------------------------------------------------------------------------

DIM = 4


def _embed(text):
    h = sum((i + 1) * ord(ch) for i, ch in enumerate(text))
    v = np.asarray([(h >> (3 * i)) % 251 + 1 for i in range(DIM)],
                   np.float32)
    return (v / np.linalg.norm(v)).tolist()


class MockSidecar(BaseHTTPRequestHandler):
    fail_next = 0

    def _send(self, obj, code=200):
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        self._send({"statusCode": 200, "result": [
            {"model": "BAAI/bge-small-en-v1.5", "dim": DIM, "dense": True,
             "dimensionReduction": False}]})

    def do_POST(self):
        if MockSidecar.fail_next > 0:
            MockSidecar.fail_next -= 1
            self._send({"statusCode": 500, "message": "transient"}, 200)
            return
        body = json.loads(self.rfile.read(
            int(self.headers["Content-Length"])))
        self._send({"statusCode": 200,
                    "result": [_embed(d) for d in body.get("documents", [])]})

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def sidecar():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), MockSidecar)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()


CLIENTS = [pytest.param((JaxEmbedding, JaxVectorDBError), id="jax"),
           pytest.param((EmbeddingService, VectorDBError), id="torch")]


@pytest.mark.parametrize("cls", CLIENTS)
def test_embedding_models(sidecar, cls):
    models = cls[0](sidecar).get_supported_models()
    assert models[0].model == "BAAI/bge-small-en-v1.5"
    assert models[0].dim == DIM


def test_embed_documents_matches_jax(sidecar):
    out = [c(sidecar).dense_embed_documents("BAAI/bge-small-en-v1.5",
                                            ["hello", "world"], DIM, {})
           for c in (JaxEmbedding, EmbeddingService)]
    assert out[0] == out[1] == [_embed("hello"), _embed("world")]


def test_embed_query_retries_transient_failure(sidecar):
    MockSidecar.fail_next = 1
    out = EmbeddingService(sidecar).dense_embed_query(
        "BAAI/bge-small-en-v1.5", "hi", DIM, {})
    assert out == _embed("hi") and MockSidecar.fail_next == 0


@pytest.mark.parametrize("cls", CLIENTS)
def test_missing_provider_key(sidecar, cls):
    with pytest.raises(cls[1], match="OpenAI API key"):
        cls[0](sidecar).dense_embed_documents(
            "openai/text-embedding-3-small", ["x"], DIM, {})


@pytest.mark.parametrize("pkg", [pytest.param(jvdb, id="jax"),
                                 pytest.param(tvdb, id="torch")])
def test_index_field_and_search_by_content(sidecar, tmp_path, pkg):
    """Content index: the hidden vector field is embedded at insert and
    searched through query text (reference db_server.cpp:512-600)."""
    svc = JaxEmbedding if pkg is jvdb else EmbeddingService
    eng = pkg._engine()
    eng.inject_embedding_service(svc(sidecar))
    assert pkg.load_db("edb", str(tmp_path / "edb")) == 0
    pkg.use_db("edb")
    pkg.create_table("docs", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "Doc", "dataType": "STRING"},
    ], indices=[{"name": "DocIdx", "field": "Doc",
                 "model": "BAAI/bge-small-en-v1.5"}])
    table = eng.get_db("edb").get_table("docs")
    hidden = table.schema.fields[-1]
    assert hidden.is_index_field and hidden.name == "DocIdx"
    assert hidden.vector_dimension == DIM
    assert pkg.insert("docs", [{"ID": 1, "Doc": "alpha"},
                               {"ID": 2, "Doc": "beta"},
                               {"ID": 3, "Doc": "gamma"}]) == 0
    np.testing.assert_allclose(table.segment.dense_host["DocIdx"][1],
                               _embed("beta"), rtol=1e-6)
    status, rows, _ = eng.search_by_content(
        "edb", "docs", "", ["ID", "Doc"], "beta", 1, "", True, [], {})
    assert status.ok(), status.message
    assert rows[0]["ID"] == 2
    # A model the sidecar does not serve is refused at create_table.
    with pytest.raises(Exception):
        pkg.create_table("bad", [
            {"name": "ID", "dataType": "INT", "primaryKey": True},
            {"name": "Doc", "dataType": "STRING"},
        ], indices=[{"name": "I", "field": "Doc", "model": "no/such"}])
