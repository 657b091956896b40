"""The dense query slice end to end: vectordb_tpu and vectordb_tpu_torch
on the same table through the library API, both held to a numpy oracle.

Flat path: results must match as id sets per query, with distances within
rtol 1e-5 (both packages return exact f32 re-ranked distances; only
summation order differs). Graph path (after rebuild()): each package builds
its own graph, so top-10 id sets must agree on at least 99% of queries,
distances of the ids both return within rtol 1e-5, and the port's recall
against the oracle may be at most 0.005 below the JAX package's. Also: the
port never imports jax, and it opens data directories that vectordb_tpu
wrote (WAL only, and after dump_db).
"""
import subprocess
import sys

import numpy as np
import pytest

import vectordb_tpu as jvdb
import vectordb_tpu_torch as tvdb
from vectordb_tpu.table import Table as JaxTable
from vectordb_tpu.config import global_config as jax_config
from vectordb_tpu.schema import MetricType
from vectordb_tpu_torch.config import global_config as torch_config
from vectordb_tpu_torch.ops import beam as tbeam
from vectordb_tpu_torch.table import Table as TorchTable

METRICS = ["EUCLIDEAN", "COSINE", "DOT_PRODUCT"]


@pytest.fixture(autouse=True)
def _reset_port():
    saved_t, saved_j = dict(vars(torch_config)), dict(vars(jax_config))
    tvdb.set_device("cpu")  # the CPU run of the port: plain versions
    for cfg in (torch_config, jax_config):
        cfg.query_group_size = 4
        cfg.flat_serve = "auto"
        cfg.device_rerank = "auto"
    yield
    tvdb._reset_for_tests()
    vars(torch_config).update(saved_t)
    vars(jax_config).update(saved_j)


def _fields(dim, metric):
    return [{"name": "ID", "dataType": "INT", "primaryKey": True},
            {"name": "Doc", "dataType": "STRING"},
            {"name": "Emb", "dataType": "VECTOR_FLOAT", "dimensions": dim,
             "metricType": metric}]


def _columns(n, dim, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    return x, {"ID": np.arange(n), "Doc": [f"c{i % 7}" for i in range(n)],
               "Emb": x}


def _load(pkg, path, table, n, dim, metric, seed):
    x, cols = _columns(n, dim, seed)
    assert pkg.load_db("db", str(path)) == 0
    pkg.use_db("db")
    pkg.create_table(table, _fields(dim, metric))
    pkg.insert_columns(table, cols)
    return x


def _oracle(x, q, metric, k, keep=None):
    if metric == "COSINE":
        xn = x / np.linalg.norm(x, axis=1, keepdims=True)
        d = 1.0 - xn.astype(np.float64) @ (q / np.linalg.norm(q))
    elif metric == "DOT_PRODUCT":
        d = -(x.astype(np.float64) @ q)
    else:
        d = ((x.astype(np.float64) - q) ** 2).sum(1)
    if keep is not None:
        d = np.where(keep, d, np.inf)
    return set(np.argsort(d, kind="stable")[:k].tolist())


def _rows(res):
    return ([r["ID"] for r in res],
            np.asarray([r["@distance"] for r in res], np.float64))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dim", [32, 128])
def test_query_matches_jax_and_oracle(tmp_path, metric, dim):
    n = 6000
    x = _load(jvdb, tmp_path / "j", "t", n, dim, metric, seed=dim)
    _load(tvdb, tmp_path / "t", "t", n, dim, metric, seed=dim)
    rng = np.random.default_rng(1)
    for qi in rng.integers(0, n, 4):
        q = (x[qi] + 0.05 * rng.normal(size=dim)).astype(np.float32)
        for flt, keep in (("", None),
                          ("Doc = 'c3'", np.arange(n) % 7 == 3)):
            _, jres = jvdb.query("t", "Emb", q.tolist(), ["ID"], 10, flt,
                                 True)
            _, tres = tvdb.query("t", "Emb", q.tolist(), ["ID"], 10, flt,
                                 True)
            jid, jd = _rows(jres)
            tid, td = _rows(tres)
            assert set(tid) == set(jid) == _oracle(x, q, metric, 10, keep)
            np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
            if keep is not None:
                assert all(i % 7 == 3 for i in tid)


@pytest.mark.parametrize("metric", METRICS)
def test_grouped_flat_serve_matches_jax(tmp_path, monkeypatch, metric):
    n, dim, nq = 12000, 128, 300
    x = _load(jvdb, tmp_path / "j", "t", n, dim, metric, seed=3)
    _load(tvdb, tmp_path / "t", "t", n, dim, metric, seed=3)
    from vectordb_tpu_torch.ops import flat as tflat
    calls = []
    orig = tflat.flat_serve_grouped
    monkeypatch.setattr(tflat, "flat_serve_grouped",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    rng = np.random.default_rng(4)
    queries = (x[rng.integers(0, n, nq)]
               + 0.05 * rng.normal(size=(nq, dim))).astype(np.float32)
    if metric == "COSINE":
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    jt = jvdb._db.databases["db"].tables["t"]
    tt = tvdb._db.databases["db"].tables["t"]
    m = MetricType[metric]
    jids, jd = jt.grouped_dense_search("Emb", queries, jt.segment.valid_mask(),
                                       m, 10, batch=128, mask_cacheable=True)
    tids, td = tt.grouped_dense_search("Emb", queries, tt.segment.valid_mask(),
                                       m, 10, batch=128, mask_cacheable=True)
    assert calls, "the port did not route through flat-serve"
    assert tids.shape == jids.shape == (nq, 10)
    for i in range(nq):
        assert set(tids[i]) == set(jids[i])
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
    for i in range(0, nq, 15):
        assert set(tids[i]) == _oracle(x, queries[i], metric, 10)


def test_delete_then_query_matches_jax(tmp_path):
    n, dim = 5000, 32
    x = _load(jvdb, tmp_path / "j", "t", n, dim, "EUCLIDEAN", seed=5)
    _load(tvdb, tmp_path / "t", "t", n, dim, "EUCLIDEAN", seed=5)
    doomed = list(range(0, n, 3))
    assert jvdb.delete_by_pk("t", doomed) == 0
    assert tvdb.delete_by_pk("t", doomed) == 0
    keep = np.arange(n) % 3 != 0
    for qi in (0, 3, 10, 999):
        _, jres = jvdb.query("t", "Emb", x[qi].tolist(), ["ID"], 10, "", True)
        _, tres = tvdb.query("t", "Emb", x[qi].tolist(), ["ID"], 10, "", True)
        jid, jd = _rows(jres)
        tid, td = _rows(tres)
        assert set(tid) == set(jid) == _oracle(x, x[qi], "EUCLIDEAN", 10,
                                               keep)
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
    assert tvdb.statistics()[1] == jvdb.statistics()[1]


def test_not_ported_paths_raise(tmp_path):
    """Paths that once raised NOT_IMPLEMENTED_ERROR are honoured now: the
    bf16 and int8 query wires (ops/qwire) serve grouped queries with exact
    distances, and ShardCount 2 shards a new table (parallel/)."""
    n = 10_000
    x = _load(tvdb, tmp_path / "t", "t", n, 8, "EUCLIDEAN", seed=0)
    t = tvdb._db.databases["db"].tables["t"]
    for wire in ("bf16", "int8"):
        assert tvdb.update_config({"QueryDtype": wire}) == 0
        assert t._query_wire("Emb") == wire
        ids, d = t.grouped_dense_search("Emb", x[:256], t.segment.valid_mask(),
                                        MetricType.EUCLIDEAN, 5, batch=128)
        assert (ids[:, 0] == np.arange(256)).all()
        np.testing.assert_allclose(
            d, ((x[ids] - x[:256, None, :]) ** 2).sum(2), rtol=1e-5,
            atol=1e-6)
    assert tvdb.update_config({"ShardCount": 2}) == 0
    tvdb.create_table("s", _fields(8, "EUCLIDEAN"))
    s = tvdb._db.databases["db"].tables["s"]
    assert s.mesh is not None and s.mesh.size == 2
    assert set(s.sharded_fields) == {"Emb"}
    assert not t.sharded_fields  # created before ShardCount changed


def test_import_leaves_jax_out():
    code = ("import sys, vectordb_tpu_torch, vectordb_tpu_torch.parallel, "
            "vectordb_tpu_torch.ops.qwire; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'ml_dtypes' not in sys.modules, 'ml_dtypes imported'; "
            "assert not any(m == 'vectordb_tpu' or m.startswith("
            "'vectordb_tpu.') for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize("state", ["wal_only", "dumped"])
def test_port_opens_directory_written_by_jax(tmp_path, state):
    n, dim = 4000, 32
    path = tmp_path / "db"
    x = _load(jvdb, path, "t", n, dim, "EUCLIDEAN", seed=8)
    assert jvdb.delete_by_pk("t", [1, 2, 3]) == 0
    assert jvdb.delete("t", filter="Doc = 'c5'") == 0
    rng = np.random.default_rng(9)
    queries = (x[rng.integers(0, n, 5)]
               + 0.05 * rng.normal(size=(5, dim))).astype(np.float32)
    want = [jvdb.query("t", "Emb", q.tolist(), ["ID", "Doc"], 10, "", True)[1]
            for q in queries]
    if state == "dumped":
        assert jvdb.dump_db("db", str(path)) == 0
    jvdb.unload_db("db")
    assert tvdb.load_db("db", str(path)) == 0
    tvdb.use_db("db")
    assert (tvdb.statistics()[1]["tables"][0]["totalRecordCount"]
            == n - 3 - len([i for i in range(4, n) if i % 7 == 5]))
    for q, w in zip(queries, want):
        got = tvdb.query("t", "Emb", q.tolist(), ["ID", "Doc"], 10, "",
                         True)[1]
        assert [r["ID"] for r in got] == [r["ID"] for r in w]
        assert [r["Doc"] for r in got] == [r["Doc"] for r in w]
        np.testing.assert_allclose([r["@distance"] for r in got],
                                   [r["@distance"] for r in w], rtol=1e-5)


def test_insert_records_get_and_drop_match_jax(tmp_path):
    rng = np.random.default_rng(12)
    recs = [{"ID": i, "Doc": f"d{i}", "Emb": rng.normal(size=8).tolist()}
            for i in range(50)]
    for pkg, sub in ((jvdb, "j"), (tvdb, "t")):
        assert pkg.load_db("db", str(tmp_path / sub)) == 0
        pkg.use_db("db")
        pkg.create_table("t", _fields(8, "EUCLIDEAN"))
        assert pkg.insert("t", recs) == 0
        assert pkg.insert("t", recs[:5], upsert=True) == 0
    for args in ((["ID", "Doc"], [3, 7, 49]), (["Doc"], None, "ID >= 45")):
        assert tvdb.get("t", *args) == jvdb.get("t", *args)
    q = recs[7]["Emb"]
    assert (tvdb.query("t", "Emb", q, ["ID"], 3, "", True)[1][0]["ID"]
            == jvdb.query("t", "Emb", q, ["ID"], 3, "", True)[1][0]["ID"]
            == 7)
    assert tvdb.drop_table("t") == jvdb.drop_table("t") == 0
    assert tvdb.statistics()[1] == jvdb.statistics()[1]


# ---------------------------------------------------------------------------
# Graph path: rebuild(), then single, batched and grouped queries.
# ---------------------------------------------------------------------------


def _clustered_columns(n, dim, seed, metric):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(30, dim)) * 3
    x = (centers[rng.integers(0, 30, n)]
         + rng.normal(size=(n, dim))).astype(np.float32)
    if metric == "COSINE":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x, {"ID": np.arange(n), "Doc": [f"c{i % 7}" for i in range(n)],
               "Emb": x}


def _build_both(tmp_path, n, dim, metric, seed, cfg=None):
    x, cols = _clustered_columns(n, dim, seed, metric)
    tables = []
    for pkg, sub in ((jvdb, "j"), (tvdb, "t")):
        assert pkg.load_db("db", str(tmp_path / sub), vector_scale=2 * n) == 0
        pkg.use_db("db")
        pkg.create_table("t", _fields(dim, metric))
        pkg.insert_columns("t", cols)
        if cfg:
            assert pkg.update_config(cfg) == 0
        assert pkg.rebuild() == 0
        t = pkg._db.databases["db"].tables["t"]
        assert t.graphs["Emb"] is not None and t.graphs["Emb"].num_rows == n
        tables.append(t)
    return x, tables[0], tables[1]


def _oracle_ids(x, q, metric, k, keep=None):
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    if metric == "COSINE":
        q64 = q64 / np.linalg.norm(q64, axis=1, keepdims=True)
    ip = q64 @ x64.T
    if metric == "EUCLIDEAN":
        d = (q64 ** 2).sum(1)[:, None] - 2 * ip + (x64 ** 2).sum(1)[None]
    else:
        d = (1.0 - ip) if metric == "COSINE" else -ip
    if keep is not None:
        d[:, ~keep] = np.inf
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def _assert_graph_results_agree(tid, td, jid, jd, want):
    agree = np.mean([set(a[a >= 0]) == set(b[b >= 0])
                     for a, b in zip(tid, jid)])
    assert agree >= 0.99, agree
    for a_i, a_d, b_i, b_d in zip(tid, td, jid, jd):
        both = np.intersect1d(a_i[a_i >= 0], b_i[b_i >= 0])
        sa, sb = np.isin(a_i, both), np.isin(b_i, both)
        np.testing.assert_allclose(a_d[sa][np.argsort(a_i[sa])],
                                   b_d[sb][np.argsort(b_i[sb])],
                                   rtol=1e-5, atol=1e-5)

    def recall(ids):
        return np.mean([len(set(a) & set(b)) / len(b)
                        for a, b in zip(ids, want)])

    assert recall(tid) >= recall(jid) - 0.005


@pytest.mark.parametrize("metric", METRICS)
def test_graph_queries_match_jax(tmp_path, metric):
    n, dim = 6000, 32
    x, jt, tt = _build_both(tmp_path, n, dim, metric, seed=21)
    rng = np.random.default_rng(22)
    queries = (x[rng.integers(0, n, 200)]
               + 0.05 * rng.normal(size=(200, dim))).astype(np.float32)
    if metric == "COSINE":
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    m = MetricType[metric]
    jid, jd = jt.batch_dense_search("Emb", queries, jt.segment.valid_mask(),
                                    m, 10, mask_cacheable=True)
    tid, td = tt.batch_dense_search("Emb", queries, tt.segment.valid_mask(),
                                    m, 10, mask_cacheable=True)
    _assert_graph_results_agree(tid, td, jid, jd,
                                _oracle_ids(x, queries, metric, 10))
    # Single queries through the API; for L2 also with a host-folded
    # filter (1 row in 7: the beam widens 16-fold by the selectivity).
    cases = [("", None, 8)]
    if metric == "EUCLIDEAN":
        cases.append(("Doc = 'c3'", np.arange(n) % 7 == 3, 1))
    for flt, kp, nq in cases:
        res = [[_rows(pkg.query("t", "Emb", q.tolist(), ["ID"], 10, flt,
                                True)[1]) for q in queries[:nq]]
               for pkg in (tvdb, jvdb)]
        (tid1, td1), (jid1, jd1) = (
            (np.array([r[0] for r in rs]), np.array([r[1] for r in rs]))
            for rs in res)
        _assert_graph_results_agree(
            tid1, td1, jid1, jd1, _oracle_ids(x, queries[:nq], metric, 10,
                                              kp))
        if kp is not None:
            assert kp[tid1].all()


@pytest.mark.parametrize("fused", ["auto", "off"])
def test_grouped_graph_matches_jax(tmp_path, monkeypatch, fused):
    n, dim, nq = 6000, 32, 600
    cfg = {"FlatServe": "off", "FusedTraversal": fused}
    x, jt, tt = _build_both(tmp_path, n, dim, "EUCLIDEAN", seed=23, cfg=cfg)
    calls = []
    orig = tbeam.beam_search_grouped
    monkeypatch.setattr(tbeam, "beam_search_grouped",
                        lambda *a, **k: calls.append(k["fused"]) or orig(
                            *a, **k))
    rng = np.random.default_rng(24)
    queries = (x[rng.integers(0, n, nq)]
               + 0.05 * rng.normal(size=(nq, dim))).astype(np.float32)
    out = [t.grouped_dense_search("Emb", queries, t.segment.valid_mask(),
                                  MetricType.EUCLIDEAN, 10, batch=128,
                                  mask_cacheable=True) for t in (jt, tt)]
    (jid, jd), (tid, td) = out
    assert calls and all((f is not None) == (fused == "auto") for f in calls)
    assert tid.shape == jid.shape == (nq, 10)
    _assert_graph_results_agree(tid, td, jid, jd,
                                _oracle_ids(x, queries, "EUCLIDEAN", 10))


def test_graph_delete_full_k_and_tail_match_jax(tmp_path, monkeypatch):
    """Deleted rows never come back; when the beam surfaces fewer than k
    filtered rows, the exact masked scan tops the result up to k; rows
    inserted after the build come from the flat tail."""
    n, dim = 6000, 32
    x, jt, tt = _build_both(tmp_path, n, dim, "EUCLIDEAN", seed=25)
    doomed = list(range(0, n, 11))
    for pkg in (jvdb, tvdb):
        assert pkg.delete_by_pk("t", doomed) == 0
    alive = np.ones(n, bool)
    alive[doomed] = False
    # A narrow beam without selectivity widening: the filtered walk finds
    # fewer than k matches and the top-up completes them, exactly.
    for cls in (JaxTable, TorchTable):
        monkeypatch.setattr(cls, "_sel_boost", classmethod(lambda c, a, m: 1))
    for pkg in (jvdb, tvdb):
        assert pkg.update_config({"SearchEf": 16}) == 0
    scans = []
    orig = TorchTable._flat_candidates
    monkeypatch.setattr(
        TorchTable, "_flat_candidates",
        lambda self, *a, **k: scans.append(k.get("row_start", 0))
        or orig(self, *a, **k))
    keep = alive & (np.arange(n) % 7 == 3)
    for q in x[1:4]:
        jid, jd = _rows(jvdb.query("t", "Emb", q.tolist(), ["ID"], 10,
                                   "Doc = 'c3'", True)[1])
        tid, td = _rows(tvdb.query("t", "Emb", q.tolist(), ["ID"], 10,
                                   "Doc = 'c3'", True)[1])
        assert len(tid) == 10
        assert set(tid) == set(jid) == set(
            _oracle_ids(x, q[None], "EUCLIDEAN", 10, keep)[0].tolist())
        np.testing.assert_allclose(sorted(td), sorted(jd), rtol=1e-5)
    assert scans and set(scans) == {0}  # the top-up ran, on the graph path
    # Rows inserted after the build: the flat tail finds them.
    rng = np.random.default_rng(26)
    extra = (x[rng.integers(0, n, 300)]
             + 0.01 * rng.normal(size=(300, dim))).astype(np.float32)
    cols = {"ID": np.arange(n, n + 300),
            "Doc": [f"c{i % 7}" for i in range(n, n + 300)], "Emb": extra}
    for pkg in (jvdb, tvdb):
        pkg.insert_columns("t", cols)
        assert pkg.update_config({"SearchEf": 64}) == 0
    x_all = np.concatenate([x, extra])
    alive = np.concatenate([alive, np.ones(300, bool)])
    res = [[_rows(pkg.query("t", "Emb", q.tolist(), ["ID"], 10, "",
                            True)[1]) for q in extra[:8]]
           for pkg in (tvdb, jvdb)]
    (tid, td), (jid, jd) = ((np.array([r[0] for r in rs]),
                             np.array([r[1] for r in rs])) for rs in res)
    assert (tid >= n).any() and alive[tid].all()
    assert n in scans  # the tail scan starts at the graph's row count
    _assert_graph_results_agree(
        tid, td, jid, jd, _oracle_ids(x_all, extra[:8], "EUCLIDEAN", 10,
                                      alive))


def test_tune_search_matches_jax_and_sidecar_loads_in_jax(tmp_path):
    n, dim = 6000, 32
    _, jt, tt = _build_both(tmp_path, n, dim, "EUCLIDEAN", seed=27)
    jcode, jrep = jvdb.tune_search("t", "Emb")
    tcode, trep = tvdb.tune_search("t", "Emb")
    assert tcode == jcode == 0
    assert (trep["Emb"]["ef"], trep["Emb"]["iters"]) == (
        jrep["Emb"]["ef"], jrep["Emb"]["iters"])
    assert trep["Emb"]["recall"] >= 0.99
    assert abs(trep["Emb"]["recall"] - jrep["Emb"]["recall"]) <= 0.005
    assert tt.search_ef_override["Emb"] == trep["Emb"]["ef"]
    tvdb.unload_db("db")
    jvdb.unload_db("db")
    assert jvdb.load_db("db2", str(tmp_path / "t"), vector_scale=2 * n) == 0
    j2 = jvdb._db.databases["db2"].tables["t"]
    assert j2.graphs["Emb"] is not None
    assert j2.search_ef_override["Emb"] == trep["Emb"]["ef"]
    assert j2.search_iters_override.get("Emb", 0) == trep["Emb"]["iters"]
