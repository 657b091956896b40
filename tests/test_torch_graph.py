"""The graph build of vectordb_tpu_torch against vectordb_tpu's, stage by
stage on the same inputs: exact KNN (both routes), k-means assignment,
occlusion pruning, forward-edge extraction and the host build tail; and
the `.npz` graph artifact written by either package loading in the other.

Tolerances:
  - exact KNN: id sets per row are equal, except where the k-th and
    (k+1)-th distances of a row tie within 1e-5 relative (both packages add
    exact bf16 products in f32, in different orders, so only such near-ties
    may swap);
  - the partial-min route against the Pallas kernel (interpret mode) at
    128-query blocks, where the TPU kernel's self mask is right: ids equal
    position by position, distances within rtol 1e-5;
  - `_assign_all`, one Lloyd step, `_prune_batch_kernel`, `_extract_fwd`,
    `_knn_prune_batch_kernel`, `finalize_adjacency`: exactly equal. Their
    inputs are quarter-integers, so every sum is exact in f32 in any order.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vectordb_tpu as jvdb
import vectordb_tpu_torch as tvdb
from vectordb_tpu.config import global_config as jax_config
from vectordb_tpu.index import graph as jgraph
from vectordb_tpu.ops import ivf as jivf
from vectordb_tpu.ops import knn as jknn
from vectordb_tpu.ops import pallas_topk
from vectordb_tpu.schema import MetricType
from vectordb_tpu_torch.config import global_config as torch_config
from vectordb_tpu_torch.index import graph as tgraph
from vectordb_tpu_torch.ops import ivf as tivf
from vectordb_tpu_torch.ops import knn as tknn

METRICS = [MetricType.EUCLIDEAN, MetricType.COSINE, MetricType.DOT_PRODUCT]


@pytest.fixture(autouse=True)
def _reset_port():
    saved_t, saved_j = dict(vars(torch_config)), dict(vars(jax_config))
    tvdb.set_device("cpu")  # the CPU run of the port: plain versions
    yield
    tvdb._reset_for_tests()
    vars(torch_config).update(saved_t)
    vars(jax_config).update(saved_j)


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Force pallas interpret mode so the TPU kernel runs on the CPU."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pallas_topk.pl, "pallas_call", patched)


def _clustered(n, d, seed, n_pad=None, normalize=False):
    """Clustered rows, rounded to bf16 (so the bf16 store holds them
    exactly), zero-padded to n_pad rows."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(20, d)) * 3
    x = (centers[rng.integers(0, 20, n)] + rng.normal(size=(n, d)))
    if normalize:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    x = torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()
    out = np.zeros((n_pad or n, d), np.float32)
    out[:n] = x
    return out


def _quarter(rng, shape, lim=4):
    return (np.clip(np.round(rng.normal(size=shape) * 2), -lim, lim)
            / 4).astype(np.float32)


def _both_tables(x):
    norms = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    return ((jnp.asarray(x, jnp.bfloat16), jnp.asarray(norms)),
            (torch.from_numpy(x).bfloat16(), torch.from_numpy(norms)))


@pytest.mark.parametrize("metric", METRICS)
def test_exact_knn_matches_jax(metric):
    n, n_pad, d, k = 3000, 4096, 32, 16
    x = _clustered(n, d, seed=int(metric), n_pad=n_pad,
                   normalize=metric == MetricType.COSINE)
    (jt, jn), (tt, tn) = _both_tables(x)
    ji, jd = jknn.exact_knn(jt, jn, n, k, metric)
    ti, td = tknn.exact_knn(tt, tn, n, k, metric)
    ji, ti = np.asarray(ji)[:n], ti.numpy()[:n]
    assert ti.shape == ji.shape == (n, k)
    assert not (ti == np.arange(n)[:, None]).any()
    np.testing.assert_allclose(td.numpy()[:n], np.asarray(jd)[:n],
                               rtol=1e-5, atol=1e-4)
    xs = x[:n].astype(np.float64)
    if metric == MetricType.EUCLIDEAN:
        full = (xs ** 2).sum(1)[:, None] - 2 * xs @ xs.T + (xs ** 2).sum(1)
    else:
        full = (1.0 if metric == MetricType.COSINE else 0.0) - xs @ xs.T
    np.fill_diagonal(full, np.inf)
    srt = np.sort(full, axis=1)
    tie = np.abs(srt[:, k] - srt[:, k - 1]) <= 1e-5 * np.abs(srt[:, k]) + 1e-5
    for i in np.nonzero(~tie)[0]:
        assert set(ti[i]) == set(ji[i]), i


@pytest.mark.parametrize("metric", METRICS)
def test_partial_min_knn_route_matches_pallas(interpret_kernels, monkeypatch,
                                              metric):
    """exact_knn's partial-min route (taken on a CUDA table; forced here on
    CPU tensors, where it runs the kernel's plain version) against the
    Pallas fused_topk with exclude_self, block by block."""
    n, n_pad, d, k, block = 300, 8192, 128, 8, 128
    rng = np.random.default_rng(int(metric))
    x = np.zeros((n_pad, d), np.float32)
    x[:n] = rng.normal(size=(n, d))
    if metric == MetricType.COSINE:
        x[:n] /= np.linalg.norm(x[:n], axis=1, keepdims=True)
    (jt, jn), (tt, tn) = _both_tables(x)
    monkeypatch.setattr(tknn, "uses_partial_min", lambda *a: True)
    ti, td = tknn.exact_knn(tt, tn, n, k, metric, query_block=block)
    assert ti.shape == (3 * block, k)
    for s in range(0, n, block):
        jd, ji = pallas_topk.fused_topk(
            jt[s:s + block], jn[s:s + block], jnp.int32(s), jt, jn,
            int(metric), k, n_valid=n, exclude_self=True)
        e = min(s + block, n)  # rows past n are padding: callers drop them
        np.testing.assert_array_equal(ti.numpy()[s:e],
                                      np.asarray(ji)[:e - s])
        np.testing.assert_allclose(td.numpy()[s:e], np.asarray(jd)[:e - s],
                                   rtol=1e-5, atol=1e-4)
    assert not (ti.numpy()[:n] == np.arange(n)[:, None]).any()


def test_assign_all_and_lloyd_step_match_jax():
    rng = np.random.default_rng(0)
    n_pad, d, c = 4096, 16, 128
    x = _quarter(rng, (n_pad, d))
    cent = _quarter(rng, (c, d))
    ja = jivf._assign_all(jnp.asarray(x, jnp.bfloat16), jnp.asarray(cent),
                          3000, 1024)
    ta = tivf._assign_all(torch.from_numpy(x).bfloat16(),
                          torch.from_numpy(cent), 3000, 1024)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    norms = (x ** 2).sum(1)
    jc = jivf._kmeans_iters(jnp.asarray(x, jnp.bfloat16), jnp.asarray(norms),
                            jnp.asarray(cent), 3000, 1024, 1)
    tc = tivf._kmeans_iters(torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(cent), 3000, 1024, 1)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("metric", METRICS)
def test_prune_and_extract_match_jax(metric):
    rng = np.random.default_rng(int(metric) + 5)
    b, p, d, degree = 16, 48, 16, 12
    vecs = _quarter(rng, (b, p, d))
    pool_d = np.sort(rng.integers(0, 40, (b, p)) / 4.0, axis=1).astype(
        np.float32)
    valid = rng.random((b, p)) > 0.1
    jk = jgraph._prune_batch_kernel(jnp.asarray(vecs, jnp.bfloat16),
                                    jnp.asarray(pool_d), jnp.asarray(valid),
                                    int(metric), degree, 1.2)
    tk = tgraph._prune_batch_kernel(torch.from_numpy(vecs).bfloat16(),
                                    torch.from_numpy(pool_d),
                                    torch.from_numpy(valid), int(metric),
                                    degree, 1.2)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert tk.numpy().sum(axis=1).max() <= degree
    ids = rng.integers(0, 1000, (b, p)).astype(np.int32)
    jf = jgraph._extract_fwd(jnp.asarray(ids), jk, degree)
    tf = tgraph._extract_fwd(torch.from_numpy(ids), tk, degree)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


@pytest.mark.parametrize("metric", METRICS)
def test_knn_prune_batch_matches_jax(metric):
    rng = np.random.default_rng(int(metric) + 9)
    n_pad, d, k, degree, batch = 4096, 32, 24, 8, 256
    x = _quarter(rng, (n_pad, d))
    knn_ids = rng.integers(-1, n_pad, (n_pad, k)).astype(np.int32)
    (jt, jn), (tt, tn) = _both_tables(x)
    for start in (0, 1024, n_pad - batch):
        jf = jgraph._knn_prune_batch_kernel(
            jnp.int32(start), jt, jn, jnp.asarray(knn_ids), 1.2, int(metric),
            degree, batch, 1)
        tf = tgraph._knn_prune_batch_kernel(
            start, tt, tn, torch.from_numpy(knn_ids), 1.2, int(metric),
            degree, batch)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_finalize_adjacency_matches_jax():
    rng = np.random.default_rng(4)
    n, d, degree = 600, 8, 6
    host = _quarter(rng, (n, d))
    norms = (host ** 2).sum(1).astype(np.float32)
    fwd = rng.integers(0, n, (n, degree)).astype(np.int32)
    fwd[rng.random((n, degree)) < 0.3] = -1
    fwd[500:] = -1                       # an unreached tail: repair bridges
    fwd[:500][np.isin(fwd[:500], np.arange(500, n))] = -1
    reps = rng.choice(500, 20, replace=False).astype(np.int32)
    ja, jc = jgraph.finalize_adjacency(fwd.copy(), host, norms, n, degree,
                                       2 * degree, reps)
    ta, tc = tgraph.finalize_adjacency(fwd.copy(), host, norms, n, degree,
                                       2 * degree, reps)
    np.testing.assert_array_equal(ta, ja)
    assert tc == jc > 0


def test_rep_counts_and_random_reps_match_jax():
    for n in (100, 5000, 300_000, 1_000_000, 20_000_000):
        assert tgraph._rep_count(n) == jgraph._rep_count(n)
    np.testing.assert_array_equal(tgraph._make_rep_ids(3000, 17),
                                  jgraph._make_rep_ids(3000, 17))


def _fields(dim):
    return [{"name": "ID", "dataType": "INT", "primaryKey": True},
            {"name": "Emb", "dataType": "VECTOR_FLOAT", "dimensions": dim,
             "metricType": "EUCLIDEAN"}]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_graph_npz_loads_in_the_other_package(tmp_path, writer):
    n, dim = 3000, 16
    x = _clustered(n, dim, seed=11)
    src, dst = (jvdb, tvdb) if writer == "jax" else (tvdb, jvdb)
    path = str(tmp_path / "db")
    assert src.load_db("db", path, vector_scale=n) == 0
    src.use_db("db")
    src.create_table("t", _fields(dim))
    src.insert_columns("t", {"ID": np.arange(n), "Emb": x})
    assert src.rebuild() == 0
    g_src = src._db.databases["db"].tables["t"].graphs["Emb"]
    assert src.unload_db("db") == 0
    assert dst.load_db("db", path, vector_scale=n) == 0
    dst.use_db("db")
    g = dst._db.databases["db"].tables["t"].graphs["Emb"]
    assert g is not None and g.num_rows == n
    np.testing.assert_array_equal(g.adjacency_host, g_src.adjacency_host)
    np.testing.assert_array_equal(g.rep_ids_host, g_src.rep_ids_host)
    assert g.nav_point == g_src.nav_point
    for i in (5, 700, 2999):
        _, res = dst.query("t", "Emb", x[i].tolist(), ["ID"], 1)
        assert res[0]["ID"] == i
    dst.unload_db("db")
