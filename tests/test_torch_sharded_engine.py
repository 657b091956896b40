"""The sharded data plane of vectordb_tpu_torch through the engine, on 8
shards on the CPU: the port's counterparts of tests/test_sharded_engine.py,
at its sizes, held to the exact numpy oracle.

DBServer -> Table -> parallel/engine with ShardCount=8: flat scans, the
per-shard graph build, the flat tail for rows inserted after it, deletes,
device filters (float64 columns on each shard), rebuild while querying,
persistence of sharded graphs, tuning, the fused traversal and its memory
gate, and grouped queries. Where the JAX test checks a mechanism the port
dropped on purpose (the DeviceHbmBytes estimate, the upload and drain
thread pools, the packed int8 query buffer), its counterpart checks the
answers and the rule the port has instead.
"""
import threading

import numpy as np
import pytest
import torch

import vectordb_tpu_torch as vdb
from vectordb_tpu_torch.config import global_config
from vectordb_tpu_torch.parallel import engine, make_mesh, set_engine_mesh
from vectordb_tpu_torch.schema import MetricType


@pytest.fixture(autouse=True)
def _sharded_mode():
    saved = dict(vars(global_config))
    threads = torch.get_num_threads()
    # Eight CPU shards launch many small ops in turn: with every core's
    # thread on each of them, parallel test workers spin against each
    # other (10x slower than two threads under pytest-xdist).
    torch.set_num_threads(min(threads, 2))
    vdb.set_device("cpu")  # the CPU run of the port: plain versions
    engine._reset_for_tests()
    global_config.shard_count = 8
    global_config.minimal_graph_size = 100
    yield
    vdb._reset_for_tests()
    vars(global_config).update(saved)
    torch.set_num_threads(threads)


def _mk_table(tmp_path, dim=32, name="t"):
    vdb.load_db("sdb", str(tmp_path / "sdb"))
    vdb.use_db("sdb")
    vdb.create_table(name, [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "V", "dataType": "VECTOR_FLOAT", "dimensions": dim,
         "metricType": "EUCLIDEAN"}])


def _insert(name, x, start=0):
    vdb.insert_columns(name, {"ID": np.arange(start, start + len(x)),
                              "V": x})


def _table(db="sdb"):
    return vdb._db.databases[db].tables["t"]


def _oracle(x, q, k):
    d = ((x - q) ** 2).sum(1)
    return np.argsort(d, kind="stable")[:k]


def _recall(x, queries, k=10):
    hits = 0
    for q in queries:
        _, res = vdb.query("t", "V", q.tolist(), ["ID"], k, "", True)
        hits += len({r["ID"] for r in res} & set(_oracle(x, q, k).tolist()))
    return hits / (len(queries) * k)


def test_sharded_flat_exact(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3000, 32)).astype(np.float32)
    _mk_table(tmp_path)
    _insert("t", x)
    table = _table()
    assert table.mesh is not None and table.mesh.size == 8
    assert "V" in table.sharded_fields
    for qi in [0, 17, 999, 2999]:
        _, res = vdb.query("t", "V", x[qi].tolist(), ["ID"], 10, "", True)
        assert [r["ID"] for r in res] == _oracle(x, x[qi], 10).tolist(), qi
    # The sharded store holds the rows, interleaved; no single-device copy.
    st = table.sharded_fields["V"].store
    assert st.length == 3000 and len(st.buf) == 8
    assert table.segment.dense_device["V"].buf is None


def test_sharded_graph_recall_and_tail(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4000, 32)).astype(np.float32)
    _mk_table(tmp_path)
    _insert("t", x)
    assert vdb.rebuild() == 0
    sf = _table().sharded_fields["V"]
    assert sf.graph is not None and sf.graph.num_rows == 4000
    assert _table().graphs["V"] is None  # graphs live on the sharded plane
    queries = x[rng.integers(0, 4000, 64)] + 0.01 * rng.normal(
        size=(64, 32)).astype(np.float32)
    assert _recall(x, queries) >= 0.95
    # Rows inserted after the build are found through the sharded tail.
    x2 = rng.normal(size=(500, 32)).astype(np.float32) + 5.0
    _insert("t", x2, start=4000)
    for j in [0, 123, 499]:
        _, res = vdb.query("t", "V", x2[j].tolist(), ["ID"], 5, "", True)
        assert res[0]["ID"] == 4000 + j


def test_sharded_delete_and_filter(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2000, 32)).astype(np.float32)
    _mk_table(tmp_path)
    _insert("t", x)
    vdb.rebuild()
    q = x[50]
    _, res = vdb.query("t", "V", q.tolist(), ["ID"], 5, "", True)
    assert res[0]["ID"] == 50
    vdb.delete_by_pk("t", [50])
    _, res = vdb.query("t", "V", q.tolist(), ["ID"], 5, "", True)
    assert 50 not in [r["ID"] for r in res]
    # Selective filter: the exact sharded flat scan returns full k.
    _, res = vdb.query("t", "V", q.tolist(), ["ID"], 10, "ID < 100")
    ids = [r["ID"] for r in res]
    oracle = [i for i in _oracle(x, q, 2000).tolist()
              if i < 100 and i != 50][:10]
    assert ids == oracle


def test_sharded_concurrent_insert_query(tmp_path):
    """Inserts from another thread while queries run, then a rebuild."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3000, 32)).astype(np.float32)
    _mk_table(tmp_path)
    _insert("t", x[:1500])
    vdb.rebuild()
    errors = []

    def writer():
        try:
            for s in range(1500, 3000, 250):
                _insert("t", x[s:s + 250], start=s)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    th = threading.Thread(target=writer)
    th.start()
    for _ in range(20):
        qi = int(rng.integers(0, 1500))
        _, res = vdb.query("t", "V", x[qi].tolist(), ["ID"], 5, "", True)
        assert res[0]["ID"] == qi
    th.join(timeout=120)
    assert not th.is_alive() and not errors
    vdb.rebuild()
    for qi in [1500, 2200, 2999]:
        _, res = vdb.query("t", "V", x[qi].tolist(), ["ID"], 5, "", True)
        assert res[0]["ID"] == qi


def test_sharded_graph_persistence(tmp_path):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1500, 32)).astype(np.float32)
    _mk_table(tmp_path)
    _insert("t", x)
    vdb.rebuild()
    vdb.dump_db("sdb", str(tmp_path / "sdb"))
    vdb.unload_db("sdb")
    vdb.load_db("sdb", str(tmp_path / "sdb"))
    vdb.use_db("sdb")
    g = _table().sharded_fields["V"].graph
    assert g is not None and g.num_rows == 1500
    for qi in [3, 700, 1499]:
        _, res = vdb.query("t", "V", x[qi].tolist(), ["ID"], 5, "", True)
        assert res[0]["ID"] == qi


def test_mask_cache_not_poisoned_by_stale_valid_snapshot(tmp_path):
    """A query's validity snapshot taken before a concurrent insert must
    not be cached under the insert's mutation version."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(1200, 32)).astype(np.float32)
    _mk_table(tmp_path)
    _insert("t", x[:1000])
    vdb.rebuild()
    tbl = _table()
    stale_valid = tbl.segment.valid_mask().copy()  # before the insert
    _insert("t", x[1000:], start=1000)             # bumps the version
    ids, _ = tbl.batch_dense_search("V", x[1100:1101], stale_valid,
                                    MetricType.EUCLIDEAN, 5,
                                    mask_cacheable=True)
    assert 1100 in ids[0].tolist()
    sf = tbl.sharded_fields["V"]
    _, masks = sf._mask_cache
    s = sf.store.n_shards
    for r in (1000, 1100, 1199):
        assert bool(masks[r % s][r // s]), r


def test_sharded_ivf_build_path(tmp_path, monkeypatch):
    """Shards of IvfKnnThreshold rows and more take their KNN lists from
    ops/ivf.ivf_knn over the shard's own rows."""
    from vectordb_tpu_torch.ops import ivf

    calls = []
    orig = ivf.ivf_knn
    monkeypatch.setattr(ivf, "ivf_knn",
                        lambda *a, **k: calls.append(a[1]) or orig(*a, **k))
    global_config.ivf_knn_threshold = 400  # 4,000 rows / 8 shards = 500
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4000, 32)).astype(np.float32)
    _mk_table(tmp_path)
    _insert("t", x)
    assert vdb.rebuild() == 0
    assert calls == [500] * 8
    assert _table().sharded_fields["V"].graph is not None
    queries = x[rng.integers(0, 4000, 64)] + 0.01 * rng.normal(
        size=(64, 32)).astype(np.float32)
    assert _recall(x, queries) >= 0.95


def test_sharded_tune_search_ef(tmp_path, monkeypatch):
    """tune_search_ef finds the field on the sharded plane and takes its
    oracle from the sharded flat scan, never a single-device copy."""
    from vectordb_tpu_torch.table import Table

    rng = np.random.default_rng(7)
    x = rng.normal(size=(3000, 32)).astype(np.float32)
    _mk_table(tmp_path)
    _insert("t", x)
    assert vdb.rebuild() == 0
    table = _table()
    monkeypatch.setattr(Table, "_flat_candidates", None)  # never called
    report = table.tune_search_ef(sample=32, k=5, target_recall=0.95)
    assert "V" in report, report
    assert report["V"]["recall"] >= 0.95
    assert table.search_ef_override["V"] == report["V"]["ef"]
    assert table.segment.dense_device["V"].buf is None


def test_sharded_device_filter_zero_host_work(tmp_path, monkeypatch):
    """After a warm filtered query has cached the shards' columns and
    validity masks, a repeated one evaluates no host mask, interleaves
    nothing and uploads nothing, and still matches the host oracle."""
    rng = np.random.default_rng(11)
    n, dim = 2500, 32
    x = rng.normal(size=(n, dim)).astype(np.float32)
    price = rng.uniform(0, 100, n)
    vdb.load_db("sdb", str(tmp_path / "sdb"))
    vdb.use_db("sdb")
    vdb.create_table("t", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "price", "dataType": "DOUBLE"},
        {"name": "V", "dataType": "VECTOR_FLOAT", "dimensions": dim,
         "metricType": "EUCLIDEAN"}])
    vdb.insert_columns("t", {"ID": np.arange(n), "price": price, "V": x})
    assert vdb.rebuild() == 0
    from vectordb_tpu_torch.expr.evaluator import FilterCompiler

    q = x[40]
    flt = "price > 25.0 AND price < 75.0"
    keep = (price > 25.0) & (price < 75.0)
    oracle = [i for i in _oracle(x, q, n).tolist() if keep[i]][:10]
    _, res = vdb.query("t", "V", q.tolist(), ["ID"], 10, flt)
    assert [r["ID"] for r in res] == oracle
    host_folds, interleaves = [], []
    orig_mask = FilterCompiler.mask
    monkeypatch.setattr(
        FilterCompiler, "mask",
        lambda self, *a, **k: (host_folds.append(k),
                               orig_mask(self, *a, **k))[1])
    orig_il = engine._interleave
    monkeypatch.setattr(
        engine, "_interleave",
        lambda *a, **k: (interleaves.append(a), orig_il(*a, **k))[1])
    _, res = vdb.query("t", "V", q.tolist(), ["ID"], 10, flt)
    assert [r["ID"] for r in res] == oracle
    assert host_folds == [] and interleaves == []


def test_sharded_float64_filter_keeps_the_host_rows(tmp_path):
    """The float32 filter fault of the JAX plane, repaired on each shard:
    prices of 10.5 +- 1e-9 under `price > 10.5` keep exactly the rows the
    host evaluator keeps (float32 columns keep none)."""
    n = 40
    rng = np.random.default_rng(15)
    price = np.where(np.arange(n) % 2 == 0, 10.5 + 1e-9, 10.5 - 1e-9)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    vdb.load_db("sdb", str(tmp_path / "sdb"))
    vdb.use_db("sdb")
    vdb.create_table("t", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "price", "dataType": "DOUBLE"},
        {"name": "V", "dataType": "VECTOR_FLOAT", "dimensions": 8,
         "metricType": "EUCLIDEAN"}])
    vdb.insert_columns("t", {"ID": np.arange(n), "price": price, "V": x})
    table = _table()
    sf = table.sharded_fields["V"]
    want = set(np.nonzero(price > 10.5)[0].tolist())
    assert len(want) == 20
    _, res = vdb.query("t", "V", x[0].tolist(), ["ID"], n, "price > 10.5")
    assert {r["ID"] for r in res} == want
    cols = sf._col_cache["price"][2]
    assert len(cols) == 8 and all(c.dtype == torch.float64 for c in cols)


def test_sharded_device_filter_selective_topup(tmp_path):
    """A filter keeping fewer rows than k: the sharded flat scan under the
    same device filter fills what exists."""
    rng = np.random.default_rng(12)
    n, dim = 2000, 32
    x = rng.normal(size=(n, dim)).astype(np.float32)
    _mk_table(tmp_path)
    _insert("t", x)
    assert vdb.rebuild() == 0
    q = x[1500]
    _, res = vdb.query("t", "V", q.tolist(), ["ID"], 10, "ID < 6")
    assert [r["ID"] for r in res] == [i for i in _oracle(x, q, n).tolist()
                                      if i < 6]


def test_sharded_fused_traversal(tmp_path):
    """The fused int8 traversal: active and shaped per shard, results as
    good as the split path's, and gated off cleanly by a zero budget."""
    global_config.fused_traversal = "on"
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4000, 32)).astype(np.float32)
    _mk_table(tmp_path)
    _insert("t", x)
    assert vdb.rebuild() == 0
    sf = _table().sharded_fields["V"]
    queries = x[rng.integers(0, 4000, 32)] + 0.01 * rng.normal(
        size=(32, 32)).astype(np.float32)
    r_fused = _recall(x, queries)
    fused, scale = sf.graph._fused_cache
    assert fused is not None and float(scale) > 0
    s, cap_s, r_total = sf.graph.adjacency_host.shape
    assert len(fused) == s
    assert all(f.shape == (cap_s, r_total * sf.store.dim_padded)
               and f.dtype == torch.int8 for f in fused)
    global_config.fused_traversal = "off"
    r_split = _recall(x, queries)
    assert r_fused >= r_split - 0.02, (r_fused, r_split)
    global_config.fused_traversal = "auto"
    global_config.fused_max_bytes = 0
    sf.graph._fused_cache = None
    _, res = vdb.query("t", "V", x[7].tolist(), ["ID"], 10, "", True)
    assert sf.graph._fused_cache == (None, None)
    assert res[0]["ID"] == 7


def test_sharded_fused_memory_gate_counts_shards_a_device(tmp_path,
                                                          monkeypatch):
    """The fused tables' memory gate reads each device's free memory
    (torch.cuda.mem_get_info on a card; stubbed here) and sums the shards
    that share it: 8 shards on one device need 8 tables' room there. The
    JAX plane's DeviceHbmBytes estimate is gone."""
    import vectordb_tpu_torch.utils as utils_mod

    rng = np.random.default_rng(13)
    x = rng.normal(size=(3000, 32)).astype(np.float32)
    _mk_table(tmp_path)
    _insert("t", x)
    assert vdb.rebuild() == 0
    table = _table()
    sf = table.sharded_fields["V"]
    s, cap_s, r_total = sf.graph.adjacency_host.shape
    one = cap_s * r_total * sf.store.dim_padded  # one shard's table
    host = table.segment.dense_host["V"]
    for free, admitted in ((2 * one / 0.55, False), (9 * one / 0.55, True)):
        monkeypatch.setattr(utils_mod, "device_hbm_stats",
                            lambda *a, f=free: (0, int(f)))
        sf.graph._fused_cache = None
        fused, _ = sf.graph.fused_traversal(sf.store, host, 12 << 30)
        assert (fused is not None) == admitted, free
    _, res = vdb.query("t", "V", x[7].tolist(), ["ID"], 10, "", True)
    assert res[0]["ID"] == 7


def test_sharded_fused_deny_reevaluated_at_higher_budget(tmp_path):
    global_config.fused_traversal = "auto"
    rng = np.random.default_rng(14)
    x = rng.normal(size=(3000, 32)).astype(np.float32)
    _mk_table(tmp_path)
    _insert("t", x)
    assert vdb.rebuild() == 0
    table = _table()
    sf = table.sharded_fields["V"]
    sf.graph._fused_cache = None
    host = table.segment.dense_host["V"]
    assert sf.graph.fused_traversal(sf.store, host, 0) == (None, None)
    assert sf.graph.fused_traversal(sf.store, host, 0) == (None, None)
    fused, scale = sf.graph.fused_traversal(sf.store, host, 1 << 40)
    assert fused is not None and float(scale) > 0
    # A built table keeps serving under a later tight budget.
    fused2, _ = sf.graph.fused_traversal(sf.store, host, 0)
    assert fused2 is not None


def test_sharded_fused_with_tail_and_filter(tmp_path):
    global_config.fused_traversal = "on"
    rng = np.random.default_rng(12)
    x = rng.normal(size=(3000, 32)).astype(np.float32)
    vdb.load_db("sdb2", str(tmp_path / "sdb2"))
    vdb.use_db("sdb2")
    vdb.create_table("t", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "Tag", "dataType": "INT", "primaryKey": False},
        {"name": "V", "dataType": "VECTOR_FLOAT", "dimensions": 32,
         "metricType": "EUCLIDEAN"}])
    vdb.insert_columns("t", {"ID": np.arange(3000),
                             "Tag": np.arange(3000) % 4, "V": x})
    assert vdb.rebuild() == 0
    x2 = rng.normal(size=(200, 32)).astype(np.float32) + 5.0
    vdb.insert_columns("t", {"ID": np.arange(3000, 3200),
                             "Tag": np.zeros(200, np.int64), "V": x2})
    _, res = vdb.query("t", "V", x2[9].tolist(), ["ID"], 5, "", True)
    assert res[0]["ID"] == 3009
    _, res = vdb.query("t", "V", x[70].tolist(), ["ID"], 10, "Tag < 2")
    ids = [r["ID"] for r in res]
    assert len(ids) == 10 and all(i % 4 < 2 or i >= 3000 for i in ids)


def test_sharded_grouped_one_launch_per_super_chunk(tmp_path, monkeypatch):
    """Grouped queries: one launch_grouped (every shard's traversal and one
    merge a batch) per batch * G super-chunk, oracle recall, exact
    distances from the host re-rank."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4000, 32)).astype(np.float32)
    _mk_table(tmp_path)
    _insert("t", x)
    assert vdb.rebuild() == 0
    table = _table()
    sf = table.sharded_fields["V"]
    calls = []
    orig = type(sf).launch_grouped
    monkeypatch.setattr(type(sf), "launch_grouped",
                        lambda self, qg, *a, **k: calls.append(qg.shape)
                        or orig(self, qg, *a, **k))
    global_config.query_group_size = 2
    queries = x[rng.integers(0, len(x), 512)] + 0.01 * rng.normal(
        size=(512, 32)).astype(np.float32)
    ids, d = table.grouped_dense_search(
        "V", queries, table.segment.valid_mask(), MetricType.EUCLIDEAN, 10,
        batch=128, mask_cacheable=True)
    assert [c[:2] for c in calls] == [(2, 128), (2, 128)], calls
    assert ids.shape == (512, 10)
    hits = sum(len(set(ids[i][ids[i] >= 0].tolist())
                   & set(_oracle(x, q, 10).tolist()))
               for i, q in enumerate(queries))
    assert hits / (512 * 10) >= 0.97
    want = np.sort(((x[ids[0][ids[0] >= 0]] - queries[0]) ** 2).sum(1))
    np.testing.assert_allclose(d[0][: len(want)], want, rtol=1e-5)


@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_sharded_grouped_reduced_query_wires_raise(tmp_path, monkeypatch,
                                                   wire):
    """The bf16 and int8 query wires no longer raise on the sharded plane.
    The JAX plane's rule holds: int8 reaches the shards' traversal, a bf16
    override uploads f32 there. The exact re-rank on the host keeps the
    f32 queries, so distances stay exact."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(3000, 32)).astype(np.float32)
    _mk_table(tmp_path)
    _insert("t", x)
    assert vdb.rebuild() == 0
    table = _table()
    global_config.query_group_size = 2
    global_config.query_dtype = wire
    wires = []
    orig = engine.ShardedDenseField.launch_grouped
    monkeypatch.setattr(engine.ShardedDenseField, "launch_grouped",
                        lambda self, *a, **k: wires.append(k["wire"])
                        or orig(self, *a, **k))
    queries = x[:512] + 0.01 * rng.normal(size=(512, 32)).astype(np.float32)
    ids, d = table.grouped_dense_search(
        "V", queries, table.segment.valid_mask(), MetricType.EUCLIDEAN, 10,
        batch=128, mask_cacheable=True)
    assert wires == ["int8" if wire == "int8" else "f32"] * 2
    hits = sum(len(set(ids[i].tolist()) & set(_oracle(x, q, 10).tolist()))
               for i, q in enumerate(queries))
    assert hits / (512 * 10) >= 0.97
    np.testing.assert_allclose(
        d, ((x[ids] - queries[:, None, :]) ** 2).sum(2), rtol=1e-5)


def test_sharded_tuned_iters_ladder_applies(tmp_path):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3000, 32)).astype(np.float32)
    _mk_table(tmp_path)
    _insert("t", x)
    assert vdb.rebuild() == 0
    report = _table().tune_search_ef(target_recall=0.9, sample=32, k=5)
    assert report["V"]["iters"] > 0
    assert report["V"]["recall"] >= 0.9


@pytest.mark.parametrize("knob", ["UploadThreads", "DrainThreads"])
def test_sharded_grouped_thread_knobs_accepted_answers_equal(tmp_path,
                                                            knob):
    """UploadThreads and DrainThreads (the JAX package's relay pools) are
    accepted; the port's grouped loop is plain and in order, so answers are
    identical whatever they say."""
    rng = np.random.default_rng(11 if knob == "UploadThreads" else 12)
    x = rng.normal(size=(3000, 32)).astype(np.float32)
    _mk_table(tmp_path)
    _insert("t", x)
    assert vdb.rebuild() == 0
    table = _table()
    queries = x[rng.integers(0, len(x), 264)]
    global_config.query_group_size = 2
    outs = []
    for n_threads in (0, 2):
        assert vdb.update_config({knob: n_threads}) == 0
        outs.append(table.grouped_dense_search(
            "V", queries, table.segment.valid_mask(), MetricType.EUCLIDEAN,
            5, batch=64, mask_cacheable=True))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    assert (outs[0][0][:, 0] == np.asarray(
        [_oracle(x, q, 1)[0] for q in queries])).mean() >= 0.99


def test_engine_mesh_on_the_cpu_and_set_engine_mesh(tmp_path):
    """ShardCount shards on the CPU; one shard is no sharding; an installed
    mesh wins over ShardCount."""
    assert engine.get_engine_mesh(1) is None
    assert engine.get_engine_mesh(4).devices == (torch.device("cpu"),) * 4
    engine._reset_for_tests()
    set_engine_mesh(make_mesh(["cpu"] * 3))
    global_config.shard_count = 2
    rng = np.random.default_rng(16)
    x = rng.normal(size=(900, 32)).astype(np.float32)
    _mk_table(tmp_path)
    _insert("t", x)
    assert _table().mesh.size == 3
    assert vdb.rebuild() == 0
    assert _table().sharded_fields["V"].graph.adjacency_host.shape[0] == 3
    _, res = vdb.query("t", "V", x[5].tolist(), ["ID"], 5, "", True)
    assert res[0]["ID"] == 5


def test_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: a CUDA mesh is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh([torch.device("cuda", 0)] * 4)


def test_release_drops_every_shard_buffer(tmp_path):
    rng = np.random.default_rng(17)
    x = rng.normal(size=(1000, 32)).astype(np.float32)
    _mk_table(tmp_path)
    _insert("t", x)
    assert vdb.rebuild() == 0
    _, res = vdb.query("t", "V", x[3].tolist(), ["ID"], 5, "", True)
    assert res[0]["ID"] == 3
    table = _table()
    sf = table.sharded_fields["V"]
    assert sf.store.buf is not None and sf._mask_cache is not None
    table.release()
    assert sf.store.buf is None and sf.graph is None
    assert sf._mask_cache is None and sf._col_cache == {}
