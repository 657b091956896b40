"""The sharded data plane of vectordb_tpu_torch (parallel/) against
vectordb_tpu's, on the same numpy inputs: the JAX package on the 8 virtual
CPU devices tests/conftest.py forces, the port on 8 shards on `cpu`.

Tolerances:
  - `_interleave`, `shard_mask` and the store's slots after a sync and two
    appends (and a growth): bit-equal (the store as f32 of its bf16);
  - `sharded_flat_topk`, `sharded_flat_query`, `sharded_knn_round`: the same
    ids, except where the k-th and (k+1)-th distances of a row tie within
    1e-5 relative (both add exact products in f32 in different orders, so
    only such near-ties may swap); distances within rtol 1e-5 and atol
    1e-5 x max(|q|^2 + |x|^2) (a sum of exact products in another order
    moves by a few ulps of the sum of magnitudes, which bounds a small
    L2 distance's cancellation);
  - `sharded_beam_search` over the same graphs: recall within 0.01 of
    JAX's;
  - `ShardedGraphIndex.build` (random reps): equal rep ids, and at least
    99% of each shard's adjacency rows equal;
  - the sharded `.npz` of either package loads in the other and answers the
    same top-1;
  - `vdb.query` through both packages on a ShardCount=8 table: the same
    ids, flat and after rebuild(), with and without a filter.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vectordb_tpu as jvdb
import vectordb_tpu_torch as tvdb
from vectordb_tpu.config import global_config as jax_config
from vectordb_tpu.parallel import engine as jengine
from vectordb_tpu.parallel import sharded as jsharded
from vectordb_tpu.schema import MetricType
from vectordb_tpu_torch.config import global_config as torch_config
from vectordb_tpu_torch.parallel import engine as tengine
from vectordb_tpu_torch.parallel import sharded as tsharded

S = 8
METRICS = [MetricType.EUCLIDEAN, MetricType.COSINE, MetricType.DOT_PRODUCT]


@pytest.fixture(autouse=True)
def _reset_port():
    saved_t, saved_j = dict(vars(torch_config)), dict(vars(jax_config))
    threads = torch.get_num_threads()
    # Eight CPU shards launch many small ops in turn: with every core's
    # thread on each of them, parallel test workers spin against each
    # other (10x slower than two threads under pytest-xdist).
    torch.set_num_threads(min(threads, 2))
    tvdb.set_device("cpu")  # the CPU run of the port: plain versions
    yield
    tvdb._reset_for_tests()
    jengine._reset_for_tests()
    vars(torch_config).update(saved_t)
    vars(jax_config).update(saved_j)
    torch.set_num_threads(threads)


def _meshes():
    return jsharded.make_mesh(), tsharded.make_mesh(["cpu"] * S)


def _data(n, d, seed, normalize=False):
    """Clustered rows rounded to bf16 (the bf16 stores hold them exactly)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(32, d)) * 3
    x = centers[rng.integers(0, 32, n)] + rng.normal(size=(n, d))
    if normalize:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()


def _near_tie(d_sorted: np.ndarray, k: int) -> np.ndarray:
    """Rows whose k-th and (k+1)-th distances tie within 1e-5 relative."""
    a, b = d_sorted[:, k - 1], d_sorted[:, k]
    return np.abs(b - a) <= 1e-5 * np.abs(b) + 1e-5


def _assert_ids_up_to_ties(t_ids, j_ids, full_d, k):
    tie = _near_tie(np.sort(full_d, axis=1), k)
    for i in np.nonzero(~tie)[0]:
        assert set(t_ids[i].tolist()) == set(j_ids[i].tolist()), i


def _atol(q, x):
    return 1e-5 * float((q.astype(np.float64) ** 2).sum(1).max()
                        + (x.astype(np.float64) ** 2).sum(1).max())


def _distances(q, x, metric):
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    ip = q64 @ x64.T
    if metric == MetricType.EUCLIDEAN:
        return (q64 ** 2).sum(1)[:, None] - 2 * ip + (x64 ** 2).sum(1)[None]
    return (1.0 - ip) if metric == MetricType.COSINE else -ip


def test_interleave_and_shard_mask_match_jax():
    rng = np.random.default_rng(0)
    host = rng.normal(size=(1001, 5)).astype(np.float32)
    valid = rng.random(1001) > 0.3
    np.testing.assert_array_equal(tengine._interleave(host, S, 128),
                                  jengine._interleave(host, S, 128))
    np.testing.assert_array_equal(tengine.shard_mask(valid, S, 128),
                                  jengine.shard_mask(valid, S, 128))
    assert tengine.shard_mask(valid, S, 128)[1000 % S, 1000 // S] == valid[
        1000]


def test_store_layout_after_sync_appends_and_growth_matches_jax():
    jmesh, tmesh = _meshes()
    rng = np.random.default_rng(1)
    host = rng.normal(size=(4500, 40)).astype(np.float32)
    norms = (host ** 2).sum(1).astype(np.float32)
    js = jengine.ShardedVectorStore(jmesh, 40)
    ts = tengine.ShardedVectorStore(tmesh, 40)
    for n in (600, 750, 1000, 4500):  # grow, append, append, grow
        js.sync(host, norms, n)
        ts.sync(host, norms, n)
        assert (ts.cap_s, ts.length) == (js.cap_s, js.length)
        got = torch.stack([b.float() for b in ts.buf]).numpy()
        want = np.asarray(js.buf).astype(np.float32)
        assert got.shape == want.shape == (S, js.cap_s, 128)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(torch.stack(ts.norms).numpy(),
                                      np.asarray(js.norms))


@pytest.mark.parametrize("metric", METRICS)
def test_sharded_flat_topk_matches_jax(metric):
    jmesh, tmesh = _meshes()
    x = _data(2048, 32, seed=2, normalize=metric == MetricType.COSINE)
    q = x[:16] + 0.01
    mask = np.random.default_rng(3).random(2048) > 0.2
    jst = jsharded.ShardedTable(jmesh, x)
    tst = tsharded.ShardedTable(tmesh, x)
    jd, ji = jsharded.sharded_flat_topk(jmesh, jnp.asarray(q), jst.table,
                                        jst.norms, jnp.asarray(mask), metric,
                                        10)
    td, ti = tsharded.sharded_flat_topk(tmesh, torch.from_numpy(q),
                                        tst.table, tst.norms,
                                        torch.from_numpy(mask), metric, 10)
    full = np.where(mask[None], _distances(q, x, metric), np.inf)
    _assert_ids_up_to_ties(ti.numpy(), np.asarray(ji), full, 10)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=_atol(q, x))


@pytest.mark.parametrize("metric", METRICS)
def test_sharded_flat_query_matches_jax(metric):
    """The engine's flat scan over the interleaved layout (bf16 store,
    device mask), global ids r = slot * S + shard."""
    jmesh, tmesh = _meshes()
    n = 3000
    x = _data(n, 32, seed=4, normalize=metric == MetricType.COSINE)
    norms = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    js = jengine.ShardedVectorStore(jmesh, 32)
    ts = tengine.ShardedVectorStore(tmesh, 32)
    js.sync(x, norms, n)
    ts.sync(x, norms, n)
    valid = np.random.default_rng(5).random(n) > 0.25
    m = jengine.shard_mask(valid, S, js.cap_s)
    q = np.zeros((16, 128), np.float32)
    q[:, :32] = x[100:116] + 0.05
    jd, ji = jengine.sharded_flat_query(
        jnp.asarray(q), js.buf, js.norms, jnp.asarray(m), mesh=jmesh,
        metric=int(metric), k=12)
    td, ti = tengine.sharded_flat_query(
        torch.from_numpy(q), ts.buf, ts.norms,
        [torch.from_numpy(m[i]) for i in range(S)], mesh=tmesh,
        metric=int(metric), k=12)
    assert ti.shape == (16, 12)
    xb = torch.from_numpy(x).bfloat16().float().numpy()
    qb = torch.from_numpy(q[:, :32]).bfloat16().float().numpy()
    full = np.where(valid[None], _distances(qb, xb, metric), np.inf)
    _assert_ids_up_to_ties(ti.numpy(), np.asarray(ji), full, 12)
    assert valid[ti.numpy()].all()
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=_atol(q, x))


def test_sharded_knn_round_matches_jax():
    jmesh, tmesh = _meshes()
    n, k = 512, 5
    x = _data(n, 16, seed=6)
    jst = jsharded.ShardedTable(jmesh, x)
    tst = tsharded.ShardedTable(tmesh, x)
    ji = np.asarray(jsharded.sharded_knn_round(
        jmesh, jst.table, jst.norms, n - 7, MetricType.EUCLIDEAN, k))
    ti = torch.cat(tsharded.sharded_knn_round(
        tmesh, tst.table, tst.norms, n - 7, MetricType.EUCLIDEAN, k)).numpy()
    full = _distances(x, x, MetricType.EUCLIDEAN)
    np.fill_diagonal(full, np.inf)
    full[:, n - 7:] = np.inf
    _assert_ids_up_to_ties(ti, ji, full, k)
    assert not (ti == np.arange(n)[:, None]).any()
    assert (ti < n - 7).all()


def test_sharded_beam_search_recall_matches_jax():
    """Both packages walk the same per-shard graphs (each shard's exact
    16-NN lists, local ids) from the same random reps."""
    jmesh, tmesh = _meshes()
    n, d = 4096, 32
    x = _data(n, d, seed=7)
    ns = n // S
    adj, reps = [], []
    rng = np.random.default_rng(8)
    for s in range(S):
        rows = x[s * ns:(s + 1) * ns]
        dd = _distances(rows, rows, MetricType.EUCLIDEAN)
        np.fill_diagonal(dd, np.inf)
        adj.append(np.argsort(dd, axis=1)[:, :16].astype(np.int32))
        reps.append(rng.choice(ns, 64, replace=False).astype(np.int32))
    adj, reps = np.concatenate(adj), np.concatenate(reps)
    jst = jsharded.ShardedTable(jmesh, x)
    tst = tsharded.ShardedTable(tmesh, x)
    q = x[rng.integers(0, n, 64)] + 0.05 * rng.normal(size=(64, d)).astype(
        np.float32)
    _, ji = jsharded.sharded_beam_search(
        jmesh, jnp.asarray(q), jst.table, jst.norms, jst.put_adjacency(adj),
        jnp.asarray(reps), MetricType.EUCLIDEAN, beam_width=32)
    _, ti = tsharded.sharded_beam_search(
        tmesh, torch.from_numpy(q), tst.table, tst.norms,
        tst.put_adjacency(adj), torch.from_numpy(reps),
        MetricType.EUCLIDEAN, beam_width=32)
    want = np.argsort(_distances(q, x, MetricType.EUCLIDEAN), axis=1)[:, :10]

    def recall(ids):
        return np.mean([len(set(a[:10].tolist()) & set(b.tolist())) / 10
                        for a, b in zip(ids, want)])

    r_t, r_j = recall(ti.numpy()), recall(np.asarray(ji))
    assert r_t >= 0.95 and abs(r_t - r_j) <= 0.01, (r_t, r_j)


def test_sharded_graph_build_matches_jax():
    """4,000 rows over 8 shards: cap_s 512, so 128 random reps a shard (no
    cover): the same reps, and the same pruned graphs up to KNN near-ties."""
    jmesh, tmesh = _meshes()
    n = 4000
    x = _data(n, 32, seed=9)
    norms = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    js = jengine.ShardedVectorStore(jmesh, 32)
    ts = tengine.ShardedVectorStore(tmesh, 32)
    jg = jengine.ShardedGraphIndex.build(js, x, norms, n,
                                         MetricType.EUCLIDEAN, knn_k=32,
                                         degree=16)
    tg = tengine.ShardedGraphIndex.build(ts, x, norms, n,
                                         MetricType.EUCLIDEAN, knn_k=32,
                                         degree=16)
    assert tg.adjacency_host.shape == jg.adjacency_host.shape == (S, 512, 32)
    np.testing.assert_array_equal(tg.rep_ids_host, jg.rep_ids_host)
    assert set(tg.build_seconds) == {"sync", "reps", "knn", "prune",
                                     "finalize"}
    for s in range(S):
        ln = len(range(s, n, S))
        same = (tg.adjacency_host[s, :ln] == jg.adjacency_host[s, :ln]).all(1)
        assert same.mean() >= 0.99, (s, same.mean())
        assert (tg.adjacency_host[s, ln:] == -1).all()


def _fields():
    return [{"name": "ID", "dataType": "INT", "primaryKey": True},
            {"name": "cat", "dataType": "INT"},
            {"name": "V", "dataType": "VECTOR_FLOAT", "dimensions": 32,
             "metricType": "EUCLIDEAN"}]


def _sharded_table(pkg, path, x, cat):
    # SearchEf 32: a filter keeping half the rows widens the beam 4-fold,
    # and eight CPU shards walk it in turn.
    assert pkg.update_config({"ShardCount": S, "MinimalGraphSize": 100,
                              "SearchEf": 32}) == 0
    assert pkg.load_db("db", str(path), vector_scale=len(x)) == 0
    pkg.use_db("db")
    pkg.create_table("t", _fields())
    pkg.insert_columns("t", {"ID": np.arange(len(x)), "cat": cat, "V": x})
    return pkg._db.databases["db"].tables["t"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sharded_npz_loads_in_the_other_package(tmp_path, writer):
    n = 2000
    x = _data(n, 32, seed=10)
    cat = np.arange(n) % 10
    src, dst = (jvdb, tvdb) if writer == "jax" else (tvdb, jvdb)
    path = tmp_path / "db"
    t = _sharded_table(src, path, x, cat)
    assert src.rebuild() == 0
    g_src = t.sharded_fields["V"].graph
    assert src.unload_db("db") == 0
    assert dst.update_config({"ShardCount": S}) == 0
    assert dst.load_db("db", str(path), vector_scale=n) == 0
    dst.use_db("db")
    g = dst._db.databases["db"].tables["t"].sharded_fields["V"].graph
    assert g is not None and g.num_rows == n and g.n_shards == S
    np.testing.assert_array_equal(g.adjacency_host, g_src.adjacency_host)
    np.testing.assert_array_equal(g.rep_ids_host, g_src.rep_ids_host)
    for i in (3, 700, 1999):
        _, res = dst.query("t", "V", x[i].tolist(), ["ID"], 1)
        assert res[0]["ID"] == i
    dst.unload_db("db")


def test_engine_query_matches_jax(tmp_path):
    """vdb.query on a ShardCount=8 table, flat and after rebuild(), without
    and with a device filter: the same ids in the same order."""
    n = 3000
    x = _data(n, 32, seed=11)
    cat = np.random.default_rng(12).integers(0, 10, n)
    rng = np.random.default_rng(13)
    queries = x[rng.integers(0, n, 24)] + 0.05 * rng.normal(
        size=(24, 32)).astype(np.float32)
    tables = [_sharded_table(pkg, tmp_path / name, x, cat)
              for pkg, name in ((jvdb, "j"), (tvdb, "t"))]
    assert tables[1].mesh.size == S and "V" in tables[1].sharded_fields
    for stage in ("flat", "graph"):
        if stage == "graph":
            assert jvdb.rebuild() == 0 and tvdb.rebuild() == 0
            assert tables[1].sharded_fields["V"].graph is not None
        for flt in ("", "cat < 5"):
            # A filtered graph query widens each shard's beam 4-fold, and
            # the CPU shards walk in turn: a few of them suffice.
            qs = queries[:4] if stage == "graph" and flt else queries
            got = [[[r["ID"] for r in pkg.query("t", "V", q.tolist(), ["ID"],
                                                10, flt)[1]]
                    for q in qs] for pkg in (jvdb, tvdb)]
            assert got[1] == got[0], (stage, flt)
            if flt:
                assert all(cat[i] < 5 for row in got[1] for i in row)
