"""The spans of vectordb_tpu_torch's query path (metrics.span, and "vdb.gc"
around each garbage collection): ranges on the torch.profiler clock while
a profiler records, and no record_function entered while none does."""
import contextlib
import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import vectordb_tpu_torch as tvdb
from vectordb_tpu_torch import metrics
from vectordb_tpu_torch.config import global_config as torch_config
from vectordb_tpu_torch.db_server import DBServer
from vectordb_tpu_torch.rest.server import RestServer

DENSE_ROWS, DIM, SPARSE_ROWS, VOCAB = 1000, 16, 300, 200
STAGES = ["vdb.table.mask", "vdb.table.dispatch", "vdb.table.fetch",
          "vdb.table.rerank", "vdb.table.project"]


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    saved = dict(vars(torch_config))
    tvdb.set_device("cpu")  # the CPU run of the port: plain versions
    yield
    tvdb._reset_for_tests()
    vars(torch_config).update(saved)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """One database: a graph-indexed dense table above BruteForceThreshold
    and a sparse one."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(DENSE_ROWS, DIM)).astype(np.float32)
    tvdb.update_config({"AutoTuneSearch": False})
    path = tmp_path_factory.mktemp("tracing") / "db"
    assert tvdb.load_db("db", str(path), vector_scale=DENSE_ROWS) == 0
    tvdb.use_db("db")
    tvdb.create_table("dense", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "Emb", "dataType": "VECTOR_FLOAT", "dimensions": DIM,
         "metricType": "EUCLIDEAN"}])
    tvdb.create_table("sparse", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "Sp", "dataType": "SPARSE_VECTOR_FLOAT",
         "dimensions": VOCAB, "metricType": "DOT_PRODUCT"}])
    code, _ = tvdb.insert_columns("dense", {"ID": np.arange(DENSE_ROWS),
                                            "Emb": x})
    assert code == 0
    rows = []
    for i in range(SPARSE_ROWS):
        idx = np.sort(rng.choice(VOCAB, 12, replace=False))
        rows.append({"ID": i, "Sp": {"indices": idx.tolist(),
                                     "values": rng.random(12).tolist()}})
    assert tvdb.insert("sparse", rows) == 0
    assert tvdb.rebuild() == 0
    table = tvdb._db.databases["db"].tables["dense"]
    assert table.graphs.get("Emb") is not None
    assert DENSE_ROWS >= torch_config.brute_force_threshold
    return {"dense": ("Emb", x[3].tolist()), "sparse": ("Sp", rows[5]["Sp"])}


def query(tables, kind):
    field, vec = tables[kind]
    code, rows = tvdb.query(kind, field, vec, ["ID"], 5, "", True)
    assert code == 0 and len(rows) == 5
    return rows


@pytest.fixture
def entered(monkeypatch):
    """Names given to torch.profiler.record_function."""
    names = []

    def record(name, *args):
        names.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.profiler, "record_function", record)
    return names


def host_ranges(prof):
    """(name, start, end, thread) of the profile's vdb.* host ranges, in
    order of start."""
    out = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(),
            ev.start_thread_id())
           for ev in prof.profiler.kineto_results.events()
           if ev.name().startswith("vdb.")
           and ev.device_type() == torch.autograd.DeviceType.CPU]
    return sorted(out, key=lambda r: r[1])


def test_span_is_one_shared_no_op_without_a_profiler():
    assert metrics.span("vdb.a") is metrics.span("vdb.b") is metrics._NO_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        on = metrics.span("vdb.a")
    assert on is not metrics._NO_SPAN
    assert metrics.gc_span in gc.callbacks


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_no_record_function_without_a_profiler(tables, entered, kind):
    query(tables, kind)
    gc.collect()
    assert entered == []


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_query_stages_nest_in_one_search(tables, kind):
    query(tables, kind)  # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        query(tables, kind)
    ranges = [r for r in host_ranges(prof) if r[0] != "vdb.gc"]
    searches = [r for r in ranges if r[0] == "vdb.search"]
    assert len(searches) == 1, ranges
    _, s0, s1, tid = searches[0]
    stages = [r for r in ranges if r[0] != "vdb.search"]
    assert [r[0] for r in stages] == STAGES
    assert all(s0 <= a <= b <= s1 and t == tid for _, a, b, t in stages)
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))


def test_collection_is_a_range_only_under_a_profiler(entered):
    gc.collect()
    assert entered == []
    entered.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        gc.collect()
    assert entered and set(entered) == {"vdb.gc"}


def test_collection_range_lands_in_the_profile():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gc.collect()
    names = [r[0] for r in host_ranges(prof)]
    assert names.count("vdb.gc") >= 1


def test_rest_query_counts_queries_total(tmp_path):
    rest = RestServer(DBServer())
    try:
        code, _ = rest.dispatch("POST", "/api/load",
                                {"name": "r", "path": str(tmp_path / "r")},
                                {})
        assert code == 200
        code, _ = rest.dispatch("POST", "/api/r/schema/tables", {
            "name": "t", "fields": [
                {"name": "ID", "dataType": "INT", "primaryKey": True},
                {"name": "E", "dataType": "VECTOR_FLOAT", "dimensions": 4,
                 "metricType": "EUCLIDEAN"}]}, {})
        assert code == 200
        code, _ = rest.dispatch("POST", "/api/r/data/insert", {
            "table": "t", "data": [{"ID": i, "E": [0.1 * i, 0.2, 0.3, 0.4]}
                                   for i in range(4)]}, {})
        assert code == 200

        def total():
            code, resp = rest.dispatch("GET", "/api/metrics", None, {})
            assert code == 200
            return resp["result"]["counters"].get("queries_total", 0.0)

        before = total()
        code, resp = rest.dispatch("POST", "/api/r/data/query", {
            "table": "t", "queryVector": [0.1, 0.2, 0.3, 0.4], "limit": 2},
            {})
        assert code == 200, resp
        assert total() == before + 1
        code, resp = rest.dispatch("GET", "/api/metrics", None, {})
        assert "search" not in resp["result"]["timers"]
    finally:
        rest.db.stop()
