"""The re-rank of a sparse query's candidates in one vectorised pass over
the column's CSR snapshot (SparseColumnIndex.candidate_distances), held
against the per-row merge-join it replaced (sparse_ops.distance, its plain
version, which sums a row's products in float32) within rtol 1e-6, atol
1e-7, and against a float64 oracle (Python sums over the shared terms)
within rtol 1e-12, atol 1e-12, which the pass, summing in float64, meets.

Then Table.search on the CPU: equal distances ordered by row id, and the
counter sparse_rerank_rows_total, which counts the rows re-ranked.
"""
import numpy as np
import pytest

import vectordb_tpu_torch as tvdb
from vectordb_tpu_torch.metrics import metrics
from vectordb_tpu_torch.ops import sparse as tsparse
from vectordb_tpu_torch.schema import MetricType

METRICS = [MetricType.EUCLIDEAN, MetricType.COSINE, MetricType.DOT_PRODUCT]
N_ROWS, DIM = 200, 100
NONE_ROWS = (4, 57, 120)    # no vector: +inf, and last
EMPTY_ROWS = (9, 88, 150)   # an empty vector: a finite distance


@pytest.fixture(autouse=True)
def _cpu_port():
    tvdb.set_device("cpu")
    yield
    tvdb._reset_for_tests()


def _column(metric):
    """N_ROWS rows of 1-12 sorted distinct terms below DIM, gamma(1, 1)
    values (COSINE rows at unit length, as ingest stores them); the last
    row holds the highest term, DIM - 1."""
    rng = np.random.default_rng(3)
    col = []
    for r in range(N_ROWS):
        if r in NONE_ROWS:
            col.append(None)
            continue
        m = 0 if r in EMPTY_ROWS else int(rng.integers(1, 13))
        idx = np.sort(rng.choice(DIM - 1, size=m, replace=False))
        if r == N_ROWS - 1:
            idx[-1] = DIM - 1
        v = tsparse.SparseVector(idx.astype(np.int64),
                                 rng.gamma(1.0, 1.0, m).astype(np.float32))
        col.append(v.normalized() if metric == MetricType.COSINE else v)
    return col


QUERIES = {
    "sorted": ([2, 5, 11, 40, 63, 97], [0.5, 1.5, 2.0, 0.25, 3.0, 1.0]),
    "unsorted": ([63, 2, 97, 11, 5, 40], [3.0, 0.5, 1.0, 2.0, 1.5, 0.25]),
    "negative_and_huge_terms": ([-7, 11, 40, 1 << 40, -1, 63],
                                [4.0, 2.0, 0.25, 5.0, 1.0, 3.0]),
    "past_every_stored_index": ([DIM + 3, 150, 400],
                                [1.0, 2.0, 3.0]),
    "empty": ([], []),
    "one_term": ([DIM - 1], [2.0]),
    # A repeated term counts once, with its first value (the merge-join's
    # binary search finds the first of a run of equal terms).
    "repeated_term": ([40, 11, 40, 63], [0.5, 2.0, 7.0, 1.0]),
}

CANDIDATES = {
    "one": lambda: np.array([N_ROWS - 1]),
    "one_without_vector": lambda: np.array([NONE_ROWS[0]]),
    "every_row": lambda: np.arange(N_ROWS),
    "some": lambda: np.array(sorted({0, *NONE_ROWS, *EMPTY_ROWS, 17, 33,
                                     N_ROWS - 2, N_ROWS - 1})),
}


def _query(metric, case):
    qi, qv = QUERIES[case]
    q = tsparse.SparseVector(np.asarray(qi, np.int64),
                             np.asarray(qv, np.float32))
    return q.normalized() if metric == MetricType.COSINE else q


def _oracle64(col, q, rows, metric):
    """float64 distances: the inner product over the shared terms (a
    repeated query term with its first value), the query's whole norm."""
    first = {}
    for i, v in zip(q.indices.tolist(), q.values.tolist()):
        first.setdefault(int(i), float(v))
    qn = sum(float(v) ** 2 for v in q.values.tolist())
    out = []
    for r in rows:
        x = col[r]
        if x is None:
            out.append(np.inf)
            continue
        ip = sum(first.get(int(i), 0.0) * float(v)
                 for i, v in zip(x.indices, x.values))
        xn = sum(float(v) ** 2 for v in x.values)
        out.append(qn + xn - 2.0 * ip if metric == MetricType.EUCLIDEAN
                   else 1.0 - ip if metric == MetricType.COSINE else -ip)
    return np.asarray(out)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
@pytest.mark.parametrize("case", sorted(QUERIES))
@pytest.mark.parametrize("cands", sorted(CANDIDATES))
def test_pass_matches_merge_join_and_float64(metric, case, cands):
    col = _column(metric)
    index = tsparse.SparseColumnIndex(col, N_ROWS)
    q = _query(metric, case)
    rows = CANDIDATES[cands]()
    got = index.candidate_distances(q, rows, metric)
    assert got.dtype == np.float64 and got.shape == (len(rows),)
    plain = np.asarray([tsparse.distance(q.sorted(), col[r], metric)
                        if col[r] is not None else np.inf for r in rows])
    np.testing.assert_allclose(got, plain, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, _oracle64(col, q, rows, metric),
                               rtol=1e-12, atol=1e-12)
    none = np.isin(rows, NONE_ROWS)
    assert np.isinf(got[none]).all() and np.isfinite(got[~none]).all()


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_rows_without_a_vector_rank_last(metric):
    """Every row a candidate: the stable order puts the rows without a
    vector last, in row order, and the empty rows among the finite ones."""
    col = _column(metric)
    index = tsparse.SparseColumnIndex(col, N_ROWS)
    d = index.candidate_distances(_query(metric, "sorted"),
                                  np.arange(N_ROWS), metric)
    order = np.argsort(d, kind="stable")
    assert order[-len(NONE_ROWS):].tolist() == list(NONE_ROWS)
    assert set(EMPTY_ROWS) <= set(order[:-len(NONE_ROWS)].tolist())
    assert index.has_vector.tolist() == [r not in NONE_ROWS
                                         for r in range(N_ROWS)]


def _tie_table(path, metric):
    """60 rows: rows 3, 8, 20 and 41 hold the same vector over terms 0-9,
    the others terms 100-499 only."""
    rng = np.random.default_rng(2)
    tie = rng.gamma(1.0, 1.0, 10).astype(np.float32)
    assert tvdb.load_db("rdb", str(path)) == 0
    tvdb.use_db("rdb")
    tvdb.create_table("s", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "Vec", "dataType": "SPARSE_VECTOR_FLOAT",
         "dimensions": 500, "metricType": metric.name}])
    records = []
    for i in range(60):
        if i in (3, 8, 20, 41):
            idx, val = np.arange(10), tie
        else:
            idx = np.sort(rng.choice(np.arange(100, 500), 8, replace=False))
            val = rng.gamma(1.0, 1.0, 8).astype(np.float32)
        records.append({"ID": i, "Vec": {"indices": idx.tolist(),
                                         "values": val.tolist()}})
    assert tvdb.insert("s", records) == 0
    return {"indices": list(range(10)), "values": tie.tolist()}


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_search_orders_equal_distances_by_row_id(tmp_path, metric):
    q = _tie_table(tmp_path / "db", metric)
    code, res = tvdb.query("s", "Vec", q, ["ID"], 10, "", True)
    assert code == 0 and len(res) == 10
    ids = [r["ID"] for r in res]
    d = [r["@distance"] for r in res]
    assert ids[:4] == [3, 8, 20, 41]
    assert d[0] == d[1] == d[2] == d[3] < d[4]
    assert sorted(zip(d, ids)) == list(zip(d, ids))


@pytest.mark.parametrize("limit", [1, 10, 60])
def test_search_counts_the_rows_it_reranks(tmp_path, limit):
    """sparse_rerank_rows_total grows by k + RERANK_SLACK a query, at most
    the table's rows."""
    q = _tie_table(tmp_path / "db", MetricType.DOT_PRODUCT)
    name = "sparse_rerank_rows_total"
    before = metrics.snapshot()["counters"].get(name, 0)
    code, res = tvdb.query("s", "Vec", q, ["ID"], limit, "", True)
    assert code == 0 and len(res) == limit
    after = metrics.snapshot()["counters"].get(name, 0)
    assert after - before == min(limit + 32, 60)
