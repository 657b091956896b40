"""The IVF-partitioned KNN of vectordb_tpu_torch (ops/ivf.ivf_knn) held
against vectordb_tpu's on the same seeded tables, mirroring
tests/test_ivf_knn.py.

Both packages train k-means in f32 with different summation orders and
break top-k ties differently (sibling tiles share a centroid), so a few
rows may be assigned or probed differently: neighbour lists are compared
by recall (>= 0.9 against the port's exact KNN, as the JAX test holds) and
by overlap with the JAX package's lists (>= 0.95), not bit for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vectordb_tpu as jvdb
import vectordb_tpu_torch as tvdb
from vectordb_tpu.config import global_config as jax_config
from vectordb_tpu.ops import ivf as jivf
from vectordb_tpu_torch.config import global_config as torch_config
from vectordb_tpu_torch.ops import ivf as tivf
from vectordb_tpu_torch.ops import knn as tknn
from vectordb_tpu_torch.schema import MetricType

METRICS = ["EUCLIDEAN", "COSINE", "DOT_PRODUCT"]


@pytest.fixture(autouse=True)
def _cpu_port():
    saved_t, saved_j = dict(vars(torch_config)), dict(vars(jax_config))
    tvdb.set_device("cpu")  # the CPU run of the port: plain versions
    yield
    tvdb._reset_for_tests()
    vars(torch_config).update(saved_t)
    vars(jax_config).update(saved_j)


def _table(n, dim, seed=0, clusters=50, metric="EUCLIDEAN"):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, dim)) * 3
    x = (centers[rng.integers(0, clusters, n)]
         + rng.normal(size=(n, dim))).astype(np.float32)
    if metric == "COSINE":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    xp = np.zeros((-(-n // 1024) * 1024, dim), np.float32)
    xp[:n] = x
    return x, xp, (xp ** 2).sum(1)


def _overlap(a, b, rows):
    hits = sum(len(set(a[i][a[i] >= 0].tolist()) & set(b[i].tolist()))
               for i in rows)
    return hits / (len(rows) * a.shape[1])


@pytest.mark.parametrize("n", [1_000_000, 4_000_000, 16_000_000,
                               100_000_000])
def test_auto_max_clusters_matches_jax(n):
    assert tivf._auto_max_clusters(n) == jivf._auto_max_clusters(n)


@pytest.mark.parametrize("metric", METRICS)
def test_ivf_knn_matches_exact_and_jax(metric):
    n, dim, k = 6000, 32, 16
    _, xp, norms = _table(n, dim, metric=metric)
    m = MetricType[metric]
    tab = torch.from_numpy(xp)
    stats = {}
    ids, d = tivf.ivf_knn(tab, n, k, m, cluster_rows=512, n_probe=4,
                          stats=stats)
    assert ids.shape == (n, k) and ids.dtype == np.int32
    assert d.shape == (n, k) and d.dtype == np.float32
    assert stats["probe"] == 4 and stats["cap"] == 512 and stats["tiles"] > 0
    e_ids, _ = tknn.exact_knn(tab, torch.from_numpy(norms), n, k, m)
    e_ids = e_ids.numpy()[:n]
    j_ids, _ = jivf.ivf_knn(jnp.asarray(xp), jnp.asarray(norms), n, k, m,
                            cluster_rows=512, n_probe=4, block=1024)
    sample = np.arange(0, n, 7)
    assert _overlap(ids, e_ids, sample) >= 0.9
    assert _overlap(ids, j_ids, np.arange(n)) >= 0.95
    # Self never appears; pads are -1 with inf distance; rows ascend.
    assert not (ids == np.arange(n)[:, None]).any()
    assert np.isinf(d[ids == -1]).all()
    fin = np.where(np.isfinite(d), d, np.inf)
    assert (np.diff(fin, axis=1) >= 0).all()


def test_kmeans_of_ivf_knn_matches_jax():
    """ivf_knn's k-means (8 Lloyd iterations on a strided sample, centroids
    padded to 128 with 1e15 dummies) and its assignment of every row: f32
    sums in another order, so centroids within rtol 1e-4 and at least 99%
    of the rows assigned alike, not bit for bit."""
    n, dim, c_real = 6000, 32, 50
    _, xp, norms = _table(n, dim, seed=6)
    cent0 = np.full((128, dim), 1e15, np.float32)
    cent0[:c_real] = xp[np.linspace(0, n - 1, c_real).astype(int)]
    jc = np.asarray(jivf._kmeans_iters(jnp.asarray(xp), jnp.asarray(norms),
                                       jnp.asarray(cent0), n, 1024, 8))
    tc = tivf._kmeans_iters(torch.from_numpy(xp), torch.from_numpy(cent0),
                            n, 1024, tivf.KMEANS_ITERS)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-4, atol=1e-4)
    ja = np.asarray(jivf._assign_all(jnp.asarray(xp), jnp.asarray(jc), n,
                                     1024))[:n]
    ta = tivf._assign_all(torch.from_numpy(xp), tc, n, 1024).numpy()[:n]
    assert (ta == ja).mean() >= 0.99


def test_ivf_knn_skewed_clusters():
    """Heavily skewed assignment: half the rows collapse into one tight
    blob, which is cut into sibling tiles."""
    rng = np.random.default_rng(3)
    n, dim = 4000, 16
    x = rng.normal(size=(n, dim)).astype(np.float32)
    x[: n // 2] *= 0.01
    xp = np.zeros((4096, dim), np.float32)
    xp[:n] = x
    stats = {}
    ids, d = tivf.ivf_knn(torch.from_numpy(xp), n, 8, MetricType.EUCLIDEAN,
                          cluster_rows=256, n_probe=4, stats=stats)
    assert stats["tiles"] > stats["clusters"]  # the blob split into tiles
    assert (ids >= 0).any(axis=1).mean() > 0.99
    j_ids, _ = jivf.ivf_knn(jnp.asarray(xp), jnp.asarray((xp ** 2).sum(1)),
                            n, 8, MetricType.EUCLIDEAN, cluster_rows=256,
                            n_probe=4, block=1024)
    assert _overlap(ids, j_ids, np.arange(n)) >= 0.95


def test_ivf_knn_groups_of_tiles_agree_with_one_group(monkeypatch):
    """Tiles scored in groups of 3 (a ragged last group) give what one
    group of every tile gives; need_dists=False returns no distances."""
    n, dim, k = 5000, 24, 12
    _, xp, _ = _table(n, dim, seed=4)
    args = (torch.from_numpy(xp), n, k, MetricType.EUCLIDEAN)
    kw = dict(cluster_rows=256, n_probe=3)
    one, d_one = tivf.ivf_knn(*args, **kw)
    monkeypatch.setattr(tivf, "GROUP_BLOCK_BYTES", 3 * 256 * 3 * 256 * 4)
    stats = {}
    grouped, d_none = tivf.ivf_knn(*args, need_dists=False, stats=stats,
                                   **kw)
    assert stats["group"] == 3 and stats["tiles"] % 3 != 0
    assert d_none is None
    np.testing.assert_array_equal(grouped, one)


def _graph_db(pkg, path, x):
    assert pkg.load_db("ivfdb", str(path)) == 0
    pkg.use_db("ivfdb")
    pkg.create_table("t", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "V", "dataType": "VECTOR_FLOAT", "dimensions": 32,
         "metricType": "EUCLIDEAN"}])
    pkg.insert_columns("t", {"ID": np.arange(len(x)), "V": x})


def test_graph_build_via_ivf_matches_jax(tmp_path):
    """IvfKnnThreshold 2,000 on 5,000 rows: rebuild() builds the KNN graph
    through ivf_knn and serves it; at least 28 of 30 oracle hits, as the
    JAX test holds, and as many hits as the JAX package's build less 2."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5000, 32)).astype(np.float32)
    hits = {}
    for name, pkg, cfg in (("jax", jvdb, jax_config),
                           ("port", tvdb, torch_config)):
        cfg.ivf_knn_threshold = 2000
        _graph_db(pkg, tmp_path / name, x)
        assert pkg.rebuild() == 0
        hits[name] = 0
        for qi in (5, 777, 4321):
            code, res = pkg.query("t", "V", x[qi].tolist(), ["ID"], 10)
            d = ((x - x[qi]) ** 2).sum(1)
            oracle = set(np.argsort(d, kind="stable")[:10].tolist())
            hits[name] += len(set(r["ID"] for r in res) & oracle)
    graph = tvdb._db.databases["ivfdb"].tables["t"].graphs["V"]
    assert graph is not None and graph.num_rows == 5000
    assert graph.ivf_stats["n"] == 5000 and graph.ivf_stats["tiles"] > 0
    assert hits["port"] >= 28, hits
    assert hits["port"] >= hits["jax"] - 2, hits


def test_graph_build_below_threshold_stays_exact(tmp_path):
    """Below IvfKnnThreshold the exact KNN builds the graph (no ivf_stats)."""
    x = np.random.default_rng(2).normal(size=(3000, 32)).astype(np.float32)
    torch_config.ivf_knn_threshold = 3001
    _graph_db(tvdb, tmp_path / "t", x)
    assert tvdb.rebuild() == 0
    graph = tvdb._db.databases["ivfdb"].tables["t"].graphs["V"]
    assert graph is not None and graph.ivf_stats == {}


def test_single_queries_through_ivf_graph_match_jax(tmp_path):
    """Single queries (vdb.query) on a graph built through ivf_knn return
    the JAX package's rows query for query, misses against the exact
    oracle included: bench.py's clustered generator, 30,000 x 128, 30
    centres, near-duplicate queries."""
    rng = np.random.default_rng(2)
    n, dim = 30000, 128
    centers = (rng.normal(size=(30, dim)) * 2).astype(np.float32)
    x = (centers[rng.integers(0, 30, n)]
         + rng.normal(size=(n, dim)).astype(np.float32))
    q = (x[rng.integers(0, n, 64)]
         + 0.1 * rng.normal(size=(64, dim)).astype(np.float32))
    oracle = np.argsort((x ** 2).sum(1)[None, :] - 2.0 * q @ x.T,
                        axis=1)[:, :10]
    got = {}
    for name, pkg, cfg in (("jax", jvdb, jax_config),
                           ("port", tvdb, torch_config)):
        cfg.ivf_knn_threshold = 20000
        assert pkg.load_db("ivfq", str(tmp_path / name)) == 0
        pkg.use_db("ivfq")
        pkg.create_table("t", [
            {"name": "ID", "dataType": "INT", "primaryKey": True},
            {"name": "V", "dataType": "VECTOR_FLOAT", "dimensions": dim,
             "metricType": "EUCLIDEAN"}])
        pkg.insert_columns("t", {"ID": np.arange(n), "V": x})
        assert pkg.rebuild() == 0
        got[name] = [set(r["ID"] for r in pkg.query("t", "V", v.tolist(),
                                                    ["ID"], 10)[1])
                     for v in q]
    assert tvdb._db.databases["ivfq"].tables["t"].graphs["V"].ivf_stats
    assert got["port"] == got["jax"]
    hits = sum(len(g & set(o.tolist())) for g, o in zip(got["port"], oracle))
    assert hits / (10.0 * len(q)) >= 0.98
