"""Sparse and hybrid (dense + sparse) search of vectordb_tpu_torch held
against vectordb_tpu on the same seeded inputs.

ops/sparse.SparseColumnIndex: the port's scores (the row gather on the
query scatter and a per-row segmented sum; plain versions on the CPU) and
scores_host against the JAX package's scores (its gather + cumsum program
on the JAX CPU backend), rtol 1e-5, atol 1e-4. The JAX package sums a
row's products as a difference of one f32 prefix sum over the column, the
port sums each row's own products: on a column whose prefix grows large,
the port's sums are the closer to a float64 sum.

Table search: both packages re-rank a sparse query's candidates exactly on
the host, so ids must agree as sets (ties may be ordered differently, and
rows tied at the limit cut differently) and distances within rtol 1e-5.
Hybrid search fuses those results and the dense ones (exact f32 re-ranked
distances, summed in different orders): ids equal, fused scores within
rtol 1e-5.
"""
import numpy as np
import pytest

import vectordb_tpu as jvdb
import vectordb_tpu_torch as tvdb
from vectordb_tpu.ops import sparse as jsparse
from vectordb_tpu.rest.server import RestServer as JaxRest
from vectordb_tpu_torch.ops import sparse as tsparse
from vectordb_tpu_torch.rest.server import RestServer
from vectordb_tpu_torch.schema import MetricType

METRICS = ["EUCLIDEAN", "COSINE", "DOT_PRODUCT"]
RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _cpu_port():
    tvdb.set_device("cpu")  # the CPU run of the port: plain versions
    yield
    tvdb._reset_for_tests()


def _random_column(rng, n_rows, dim, nnz_max, none_every=7, empty_every=11):
    """Rows as (indices, values) numpy pairs: every none_every-th row has no
    vector, every empty_every-th an empty one (0 turns either off)."""
    rows = []
    for r in range(n_rows):
        if none_every and r % none_every == 3:
            rows.append(None)
        elif empty_every and r % empty_every == 5:
            rows.append((np.zeros(0, np.int64), np.zeros(0, np.float32)))
        else:
            m = int(rng.integers(1, nnz_max + 1))
            idx = np.sort(rng.choice(dim, size=m, replace=False))
            rows.append((idx.astype(np.int64),
                         rng.gamma(1.0, 1.0, m).astype(np.float32)))
    return rows


def _vectors(pkg, rows):
    return [None if r is None else pkg.SparseVector(r[0].copy(), r[1].copy())
            for r in rows]


QUERY_CASES = {
    "random": (np.array([0, 3, 17, 40, 88], np.int64),
               np.array([0.5, 1.5, -2.0, 0.25, 3.0], np.float32)),
    "empty": (np.zeros(0, np.int64), np.zeros(0, np.float32)),
    # Indices past every stored index: they match nothing.
    "past_every_index": (np.array([2, 150, 400], np.int64),
                         np.array([1.0, 2.0, 3.0], np.float32)),
    "one_term": (np.array([99], np.int64), np.array([2.0], np.float32)),
    # Terms no stored vector holds, and an unsorted query: the scatter
    # leaves out a negative or far term, and order does not matter.
    "negative_term": (np.array([-1, 3, 17], np.int64),
                      np.array([5.0, 1.0, 1.0], np.float32)),
    "unsorted": (np.array([17, 3], np.int64),
                 np.array([1.0, 2.0], np.float32)),
    "far_above": (np.array([3, 1_000_000], np.int64),
                  np.array([1.0, 4.0], np.float32)),
}


def _oracle64(rows, qi, qv, metric):
    """float64 distances of the query (as given) to every row: the inner
    product over the shared terms, |q|^2 + |x|^2 - 2 ip, 1 - ip or -ip."""
    q = dict(zip(qi.tolist(), qv.astype(np.float64).tolist()))
    qn = float(np.dot(qv.astype(np.float64), qv.astype(np.float64)))
    out = []
    for r in rows:
        idx, val = r if r is not None else ((), ())
        ip = sum(q.get(int(i), 0.0) * float(v) for i, v in zip(idx, val))
        xn = float(np.dot(np.asarray(val, np.float64),
                          np.asarray(val, np.float64)))
        out.append(qn + xn - 2 * ip if metric == MetricType.EUCLIDEAN
                   else 1.0 - ip if metric == MetricType.COSINE else -ip)
    return np.asarray(out)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("case", sorted(QUERY_CASES))
def test_column_scores_match_jax(metric, case):
    rng = np.random.default_rng(0)
    rows = _random_column(rng, 300, 100, 12)
    m = MetricType[metric]
    qi, qv = QUERY_CASES[case]
    jidx = jsparse.SparseColumnIndex(_vectors(jsparse, rows), len(rows))
    tidx = tsparse.SparseColumnIndex(_vectors(tsparse, rows), len(rows))
    want = jidx.scores(jsparse.SparseVector(qi, qv), m)
    tq = tsparse.SparseVector(qi, qv)
    got = tidx.scores(tq, m)
    assert got.dtype == np.float32 and got.shape == (len(rows),)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tidx.scores_host(tq, m), want, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(
        tsparse.batch_distances(tq, _vectors(tsparse, rows),
                                np.arange(5, 50), m),
        want[5:50], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _oracle64(rows, qi, qv, m), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("metric", METRICS)
def test_column_scores_of_a_huge_term_id_match_float64(metric):
    """A term id of 2^40 would size a 4 TiB scatter; it matches no row and
    is left out (the JAX package cannot score it: its scatter is sized by
    the last term). Held against the float64 oracle."""
    rows = _random_column(np.random.default_rng(0), 300, 100, 12)
    m = MetricType[metric]
    qi = np.array([3, 17, 1 << 40], np.int64)
    qv = np.array([1.0, 2.0, 3.0], np.float32)
    tidx = tsparse.SparseColumnIndex(_vectors(tsparse, rows), len(rows))
    want = _oracle64(rows, qi, qv, m)
    for got in (tidx.scores(tsparse.SparseVector(qi, qv), m),
                tidx.scores_host(tsparse.SparseVector(qi, qv), m)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", METRICS)
def test_column_without_nnz_scores_like_jax(metric):
    """Only None and empty vectors: every inner product is 0."""
    rows = [None, (np.zeros(0, np.int64), np.zeros(0, np.float32)), None]
    m = MetricType[metric]
    qi, qv = QUERY_CASES["random"]
    want = jsparse.SparseColumnIndex(_vectors(jsparse, rows), 3).scores(
        jsparse.SparseVector(qi, qv), m)
    got = tsparse.SparseColumnIndex(_vectors(tsparse, rows), 3).scores(
        tsparse.SparseVector(qi, qv), m)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_row_sums_are_closer_to_float64_than_the_prefix_difference():
    """20,000 rows of 50 products near 100 each: the column's prefix sum
    reaches 1e8, where an f32 ulp is 8, so the JAX package's boundary
    differences carry errors of several units; the port adds each row's 50
    products alone."""
    rng = np.random.default_rng(5)
    n_rows, per_row, dim = 20_000, 50, 64
    idx = np.sort(rng.permuted(np.tile(np.arange(dim), (n_rows, 1)),
                               axis=1)[:, :per_row], axis=1).astype(np.int64)
    val = rng.uniform(9.0, 11.0, (n_rows, per_row)).astype(np.float32)
    rows = list(zip(idx, val))
    q = np.arange(dim, dtype=np.int64)
    qv = rng.uniform(9.0, 11.0, dim).astype(np.float32)
    exact = np.array([np.dot(qv[i].astype(np.float64), v.astype(np.float64))
                      for i, v in rows])
    m = MetricType.DOT_PRODUCT
    j = -jsparse.SparseColumnIndex(_vectors(jsparse, rows), n_rows).scores(
        jsparse.SparseVector(q, qv), m).astype(np.float64)
    t = -tsparse.SparseColumnIndex(_vectors(tsparse, rows), n_rows).scores(
        tsparse.SparseVector(q, qv), m).astype(np.float64)
    err_j, err_t = np.abs(j - exact).max(), np.abs(t - exact).max()
    assert err_t < 0.05 < err_j, (err_t, err_j)


# --- Table sparse search --------------------------------------------------

def _sparse_table(pkg, path, metric, rows, cats=None):
    assert pkg.load_db("sdb", str(path)) == 0
    pkg.use_db("sdb")
    pkg.create_table("s", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "Cat", "dataType": "STRING"},
        {"name": "Vec", "dataType": "SPARSE_VECTOR_FLOAT",
         "dimensions": 500, "metricType": metric}])
    records = []
    for i, r in enumerate(rows):
        rec = {"ID": i, "Cat": "a" if cats is None else cats[i]}
        if r is not None:
            rec["Vec"] = {"indices": r[0].tolist(), "values": r[1].tolist()}
        else:
            rec["Vec"] = {"indices": [], "values": []}
        records.append(rec)
    assert pkg.insert("s", records) == 0


def _ids_d(res):
    return ([r["ID"] for r in res],
            np.asarray([r["@distance"] for r in res], np.float64))


def _same_results(tid, td, jid, jd):
    """Distances within RTOL, and ids equal as sets except among rows tied
    with the last distance (rows of equal distance may be cut differently
    at the limit)."""
    np.testing.assert_allclose(td, jd, rtol=RTOL, atol=1e-6)
    if len(jd):
        cut = jd[-1] - 1e-6 - RTOL * abs(jd[-1])
        assert ({i for i, d in zip(tid, td) if d < cut}
                == {i for i, d in zip(jid, jd) if d < cut})


@pytest.mark.parametrize("metric", METRICS)
def test_sparse_search_matches_jax(tmp_path, metric):
    rng = np.random.default_rng(1)
    rows = _random_column(rng, 2000, 500, 30, none_every=0)
    cats = ["a" if i % 3 else "b" for i in range(2000)]
    _sparse_table(jvdb, tmp_path / "j", metric, rows, cats)
    _sparse_table(tvdb, tmp_path / "t", metric, rows, cats)
    sources = [r for r in rows if len(r[0]) >= 4]
    for qn in range(6):
        src = sources[int(rng.integers(0, len(sources)))]
        keep = rng.random(len(src[0])) < 0.6
        keep[0] = True  # a query of at least one term (no tie of every row)
        q = {"indices": src[0][keep].tolist(),
             "values": rng.gamma(1.0, 1.0, int(keep.sum())).tolist()}
        for flt in ("", "Cat = 'b'", "ID < 700"):
            _, jres = jvdb.query("s", "Vec", q, ["ID", "Cat"], 10, flt, True)
            _, tres = tvdb.query("s", "Vec", q, ["ID", "Cat"], 10, flt, True)
            _same_results(*_ids_d(tres), *_ids_d(jres))
            if flt == "Cat = 'b'":
                assert all(r["Cat"] == "b" for r in tres)
            if flt == "ID < 700":
                assert all(r["ID"] < 700 for r in tres)


# The sparse-query probes over 2,000 rows of 1-30 sorted terms below 500
# (gamma values, seed 1): a negative term, an unsorted query, a term far
# above `dimensions` (JAX scores it, sizing its scatter by it) and one the
# JAX package cannot allocate a scatter for. `jax_right`: the JAX package
# answers it with the oracle's ids and distances (it re-ranks an unsorted
# query with a binary search that assumes sorted terms).
SPARSE_PROBES = {
    "negative_term": ([-1, 3, 17], [5.0, 1.0, 1.0], True),
    "unsorted": ([17, 3], [1.0, 2.0], False),
    "far_above": ([3, 17, 1_000_000], [1.0, 2.0, 7.0], True),
    "huge_term": ([17, 3, 1 << 40], [1.0, 2.0, 7.0], False),
}


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("probe", sorted(SPARSE_PROBES))
def test_sparse_query_probes_match_float64_oracle(tmp_path, metric, probe):
    """recall@10 1.0 against the float64 oracle of the query as given,
    @distance within rtol 1e-5; the same ids and distances as the JAX
    package where it is right."""
    rng = np.random.default_rng(1)
    rows = _random_column(rng, 2000, 500, 30, none_every=0)
    qi, qv, jax_right = SPARSE_PROBES[probe]
    m = MetricType[metric]
    qi64, qv32 = np.asarray(qi, np.int64), np.asarray(qv, np.float32)
    stored = rows
    if m == MetricType.COSINE:  # the engine normalises query and rows
        unit = lambda v: v / np.float32(np.sqrt(float(np.dot(v, v))))
        qv32 = unit(qv32)
        stored = [(i, unit(v)) for i, v in rows]
    want_d = _oracle64(stored, qi64, qv32, m)
    _sparse_table(tvdb, tmp_path / "t", metric, rows)
    q = {"indices": qi, "values": qv}
    _, tres = tvdb.query("s", "Vec", q, ["ID"], 10, "", True)
    tid, td = _ids_d(tres)
    assert len(tid) == 10
    want = np.argsort(want_d, kind="stable")
    kth = want_d[want[9]]
    strict = {int(i) for i in want[:10] if want_d[i] < kth - 1e-6}
    tied = {int(i) for i in np.flatnonzero(np.abs(want_d - kth) <= 1e-6)}
    assert strict <= set(tid) <= strict | tied  # recall@10 1.0
    np.testing.assert_allclose(td, want_d[tid], rtol=RTOL, atol=1e-6)
    if jax_right:
        _sparse_table(jvdb, tmp_path / "j", metric, rows)
        _, jres = jvdb.query("s", "Vec", q, ["ID"], 10, "", True)
        _same_results(tid, td, *_ids_d(jres))


def test_sparse_field_past_int32_term_ids_is_refused(tmp_path):
    """A sparse field of more than 2^31 - 1 dimensions is refused at
    create_table (its term ids would wrap in the int32 CSR); the JAX package
    accepts it. 2^31 - 1 itself is accepted."""
    assert tvdb.load_db("big", str(tmp_path / "big")) == 0
    tvdb.use_db("big")
    fields = lambda dims: [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "Vec", "dataType": "SPARSE_VECTOR_FLOAT",
         "dimensions": dims, "metricType": "DOT_PRODUCT"}]
    with pytest.raises(Exception, match="at most 2147483647"):
        tvdb.create_table("wide", fields(2**31))
    assert tvdb.create_table("ok", fields(2**31 - 1)) == 0
    assert tvdb.insert("ok", [{"ID": 1, "Vec": {
        "indices": [5, 2**31 - 2], "values": [1.0, 2.0]}}]) == 0
    _, res = tvdb.query("ok", "Vec", {"indices": [2**31 - 2],
                                      "values": [1.0]}, ["ID"], 1, "", True)
    assert [r["ID"] for r in res] == [1] and res[0]["@distance"] == -2.0


def _engine_sparse_table(pkg, tmp_path, metric):
    """tests/test_engine.py's TestSparse table."""
    assert pkg.load_db("e", str(tmp_path / "e")) == 0
    pkg.use_db("e")
    pkg.create_table("s", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "Vec", "dataType": "SPARSE_VECTOR_FLOAT",
         "dimensions": 100, "metricType": metric}])
    pkg.insert("s", [
        {"ID": 1, "Vec": {"indices": [0, 5], "values": [1.0, 2.0]}},
        {"ID": 2, "Vec": {"indices": [5, 7], "values": [3.0, 1.0]}},
        {"ID": 3, "Vec": {"indices": [1], "values": [4.0]}},
    ])


@pytest.mark.parametrize("metric,query,limit", [
    ("DOT_PRODUCT", {"indices": [5], "values": [1.0]}, 3),
    ("EUCLIDEAN", {"indices": [0, 5], "values": [1.0, 2.0]}, 1),
    ("COSINE", {"indices": [5, 7], "values": [1.0, 1.0]}, 3),
])
def test_engine_sparse_cases_match_jax(tmp_path, metric, query, limit):
    """tests/test_engine.py TestSparse: the same rows in the same order."""
    results = []
    for pkg, sub in ((jvdb, "j"), (tvdb, "t")):
        _engine_sparse_table(pkg, tmp_path / sub, metric)
        _, res = pkg.query("s", "Vec", query, ["ID"], limit, "", True)
        results.append(_ids_d(res))
    (jid, jd), (tid, td) = results
    assert tid == jid
    np.testing.assert_allclose(td, jd, rtol=RTOL, atol=1e-6)
    if metric == "DOT_PRODUCT":
        assert tid == [2, 1, 3]
    if metric == "EUCLIDEAN":
        assert tid == [1] and abs(td[0]) < 1e-6


def test_sparse_filter_case_matches_jax(tmp_path):
    """tests/test_engine.py TestSparseFilter: a string filter folds on the
    host; row 5 (Cat 'b', index 5 value 6.0) ranks first."""
    out = []
    for pkg, sub in ((jvdb, "j"), (tvdb, "t")):
        assert pkg.load_db("f", str(tmp_path / sub / "f")) == 0
        pkg.use_db("f")
        pkg.create_table("sf", [
            {"name": "ID", "dataType": "INT", "primaryKey": True},
            {"name": "Cat", "dataType": "STRING"},
            {"name": "Vec", "dataType": "SPARSE_VECTOR_FLOAT",
             "dimensions": 50, "metricType": "DOT_PRODUCT"}])
        pkg.insert("sf", [
            {"ID": i, "Cat": "a" if i % 2 == 0 else "b",
             "Vec": {"indices": [i % 50], "values": [float(i + 1)]}}
            for i in range(20)])
        _, res = pkg.query("sf", "Vec", {"indices": [5], "values": [1.0]},
                           ["ID", "Cat"], 5, "Cat = 'b'", True)
        assert all(r["Cat"] == "b" for r in res)
        assert res[0]["ID"] == 5
        out.append(_ids_d(res))
    assert set(out[0][0]) == set(out[1][0])
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=RTOL, atol=1e-6)


def test_empty_sparse_vector_survives_replay_like_jax(tmp_path):
    """tests/test_review_regressions.py: an empty sparse vector stays
    searchable across a WAL-only restart, in both packages alike."""
    got = []
    for pkg, sub in ((jvdb, "j"), (tvdb, "t")):
        path = str(tmp_path / sub / "es")
        pkg.load_db("es", path)
        pkg.use_db("es")
        pkg.create_table("t", [
            {"name": "ID", "dataType": "INT", "primaryKey": True},
            {"name": "Vec", "dataType": "SPARSE_VECTOR_FLOAT",
             "dimensions": 10, "metricType": "COSINE"}])
        pkg.insert("t", [
            {"ID": 1, "Vec": {"indices": [], "values": []}},
            {"ID": 2, "Vec": {"indices": [3], "values": [1.0]}}])
        q = {"indices": [3], "values": [1.0]}
        _, before = pkg.query("t", "Vec", q, ["ID"], 2, "", True)
        pkg.unload_db("es")
        pkg.load_db("es", path)
        pkg.use_db("es")
        _, after = pkg.query("t", "Vec", q, ["ID"], 2, "", True)
        assert [r["ID"] for r in before] == [r["ID"] for r in after]
        assert len(after) == 2
        got.append(_ids_d(after))
    assert got[0][0] == got[1][0]
    np.testing.assert_allclose(got[1][1], got[0][1], rtol=RTOL, atol=1e-6)


# --- Hybrid search ----------------------------------------------------------

HYBRID_ROWS = [
    {"ID": 1, "Dense": [1.0, 0.0, 0.0, 0.0],
     "Sparse": {"indices": [9], "values": [0.1]}},
    {"ID": 2, "Dense": [0.0, 1.0, 0.0, 0.0],
     "Sparse": {"indices": [5], "values": [5.0]}},
    {"ID": 3, "Dense": [0.9, 0.1, 0.0, 0.0],
     "Sparse": {"indices": [5], "values": [4.0]}},
    {"ID": 4, "Dense": [0.0, 0.0, 1.0, 0.0],
     "Sparse": {"indices": [7], "values": [1.0]}},
]
HYBRID_QUERIES = [
    {"field": "Dense", "vector": [1.0, 0.0, 0.0, 0.0], "weight": 1.0},
    {"field": "Sparse", "vector": {"indices": [5], "values": [1.0]},
     "weight": 1.0},
]
HEAVY_DENSE = [dict(HYBRID_QUERIES[0], weight=10.0),
               dict(HYBRID_QUERIES[1], weight=0.1)]


def _hybrid_table(pkg, path):
    """tests/test_hybrid.py's table: row 1 the best dense match, row 2 the
    best sparse one, row 3 decent in both, row 4 weak in both."""
    assert pkg.load_db("hdb", str(path)) == 0
    pkg.use_db("hdb")
    pkg.create_table("h", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "Dense", "dataType": "VECTOR_FLOAT", "dimensions": 4,
         "metricType": "EUCLIDEAN"},
        {"name": "Sparse", "dataType": "SPARSE_VECTOR_FLOAT",
         "dimensions": 100, "metricType": "DOT_PRODUCT"}])
    assert pkg.insert("h", HYBRID_ROWS) == 0


@pytest.mark.parametrize("queries,limit,flt,rerank", [
    (HYBRID_QUERIES, 4, "", "rrf"),
    (HYBRID_QUERIES, 4, "", "weighted"),
    (HEAVY_DENSE, 1, "", "weighted"),
    (HEAVY_DENSE, 3, "", "rrf"),
    (HYBRID_QUERIES, 4, "ID <> 3", "rrf"),
    (HYBRID_QUERIES, 4, "ID <> 3", "weighted"),
], ids=["rrf", "weighted", "weights_weighted", "weights_rrf",
        "filter_rrf", "filter_weighted"])
def test_hybrid_matches_jax(tmp_path, queries, limit, flt, rerank):
    out = []
    for pkg, sub in ((jvdb, "j"), (tvdb, "t")):
        _hybrid_table(pkg, tmp_path / sub)
        code, rows = pkg.hybrid_query("h", queries, ["ID"], limit, flt, True,
                                      rerank=rerank)
        assert code == 0
        out.append(_ids_d(rows))
    (jid, jd), (tid, td) = out
    assert tid == jid
    np.testing.assert_allclose(td, jd, rtol=RTOL, atol=1e-7)
    if flt:
        assert 3 not in tid
    if rerank == "rrf" and queries is HYBRID_QUERIES and not flt:
        assert set(tid[:3]) == {1, 2, 3} and tid[3] == 4
        assert list(td) == sorted(td)
    if rerank == "weighted" and queries is HYBRID_QUERIES and not flt:
        assert tid[0] == 3
    if queries is HEAVY_DENSE and limit == 1:
        assert tid == [1]


def test_hybrid_via_rest_matches_jax(tmp_path):
    """tests/test_hybrid.py: the REST body {"queryVectors": ...}."""
    payloads = []
    for pkg, sub, rest_cls in ((jvdb, "j", JaxRest), (tvdb, "t", RestServer)):
        _hybrid_table(pkg, tmp_path / sub)
        rest = rest_cls(pkg._engine())
        code, resp = rest.dispatch(
            "POST", "/api/hdb/data/query",
            {"table": "h", "queryVectors": HYBRID_QUERIES, "limit": 2,
             "response": ["ID"], "withDistance": True}, {})
        assert code == 200
        assert {r["ID"] for r in resp["result"]} <= {1, 2, 3}
        assert len(resp["result"]) == 2
        payloads.append(resp["result"])
    assert [r["ID"] for r in payloads[1]] == [r["ID"] for r in payloads[0]]
    np.testing.assert_allclose([r["@distance"] for r in payloads[1]],
                               [r["@distance"] for r in payloads[0]],
                               rtol=RTOL, atol=1e-7)


def _random_hybrid_table(pkg, path, x, rows):
    assert pkg.load_db("rh", str(path)) == 0
    pkg.use_db("rh")
    pkg.create_table("h", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "Dense", "dataType": "VECTOR_FLOAT", "dimensions": 16,
         "metricType": "EUCLIDEAN"},
        {"name": "Sparse", "dataType": "SPARSE_VECTOR_FLOAT",
         "dimensions": 500, "metricType": "DOT_PRODUCT"}])
    assert pkg.insert("h", [
        {"ID": i, "Dense": x[i].tolist(),
         "Sparse": {"indices": rows[i][0].tolist(),
                    "values": rows[i][1].tolist()}}
        for i in range(len(rows))]) == 0


@pytest.mark.parametrize("rerank", ["rrf", "weighted"])
def test_random_hybrid_matches_jax(tmp_path, rerank):
    """2,000 rows, dense 16 plus sparse over 500 dimensions; each query a
    noisy copy of a row in both fields: the same fused ids and scores."""
    rng = np.random.default_rng(7)
    n = 2000
    x = rng.normal(size=(n, 16)).astype(np.float32)
    rows = _random_column(rng, n, 500, 40, none_every=0,
                          empty_every=0)
    _random_hybrid_table(jvdb, tmp_path / "j", x, rows)
    j_queries = []
    for _ in range(8):
        r = int(rng.integers(0, n))
        dq = (x[r] + 0.3 * rng.normal(size=16)).astype(np.float32)
        keep = rng.random(len(rows[r][0])) < 0.5
        keep[0] = True
        j_queries.append([
            {"field": "Dense", "vector": dq.tolist(), "weight": 1.0},
            {"field": "Sparse",
             "vector": {"indices": rows[r][0][keep].tolist(),
                        "values": rng.gamma(1, 1, int(keep.sum())).tolist()},
             "weight": 0.5}])
    want = [_ids_d(jvdb.hybrid_query("h", q, ["ID"], 10, "", True,
                                     rerank=rerank)[1]) for q in j_queries]
    _random_hybrid_table(tvdb, tmp_path / "t", x, rows)
    for q, (jid, jd) in zip(j_queries, want):
        tid, td = _ids_d(tvdb.hybrid_query("h", q, ["ID"], 10, "", True,
                                           rerank=rerank)[1])
        assert tid == jid
        np.testing.assert_allclose(td, jd, rtol=RTOL, atol=1e-7)
