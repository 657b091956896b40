"""A dense query under a device filter, through vdb.query, on the port's
CPU route: the selectivity gate's route by the share of rows the filter
keeps, the exact masked flat scan against a plain torch reference, the
walk under the device mask by its recall, and the filter's span and
counters.

The table is cohere-768-1m-filter99's shape at a CPU test's size: unit
rows of a clustered process, COSINE, a uniform INT doc_id (here a
permutation of the row numbers, so each share is exact), a graph built,
FlatServe off. A filter doc_id >= T keeps N - T rows; it takes the flat
scan when it keeps fewer than N / SELECTIVE_FLAT_RATIO of them.
"""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import vectordb_tpu_torch as vdb
from vectordb_tpu_torch.config import global_config
from vectordb_tpu_torch.metrics import metrics
from vectordb_tpu_torch.table import Table

N, DIM, K, QUERIES = 4000, 32, 10, 24
SHARES = (0.005, 0.01, 0.05, 0.125, 0.5, 0.99)
COUNTERS = ("filter_route_flat_total", "filter_route_walk_total",
            "filter_match_rows_total", "flat_scan_rows_total")
CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "perfbench", "configs",
    "cohere-768-1m-filter99.json")


# 40 Gaussian centres in 8 latent dimensions, carried into DIM columns.
_LATENT = np.random.default_rng(20)
BASIS = np.linalg.qr(_LATENT.normal(size=(DIM, DIM)))[0][:8]
CENTERS = 2.0 * _LATENT.normal(size=(40, 8))


def _clustered(rng, n):
    """n rows of the clustered process: a centre plus N(0, 1) in the
    latent dimensions, plus N(0, 0.05^2) a column."""
    z = CENTERS[rng.integers(0, len(CENTERS), n)] + rng.normal(size=(n, 8))
    return (z @ BASIS + 0.05 * rng.normal(size=(n, DIM))).astype(np.float32)


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    saved = dict(vars(global_config))
    vdb.set_device("cpu")
    rng = np.random.default_rng(5)
    x = _clustered(rng, N)
    queries = _clustered(rng, QUERIES)
    doc_id = rng.permutation(N).astype(np.int64)
    assert vdb.update_config({"AutoTuneSearch": False,
                              "FlatServe": "off"}) == 0
    assert vdb.load_db("filt", str(tmp_path_factory.mktemp("filt")),
                       vector_scale=N) == 0
    vdb.use_db("filt")
    vdb.create_table("t", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "doc_id", "dataType": "INT"},
        {"name": "Emb", "dataType": "VECTOR_FLOAT", "dimensions": DIM,
         "metricType": "COSINE"}])
    code, _ = vdb.insert_columns("t", {"ID": np.arange(N), "doc_id": doc_id,
                                       "Emb": x})
    assert code == 0
    assert vdb.rebuild() == 0
    t = vdb._db.databases["filt"].tables["t"]
    assert t.graphs.get("Emb") is not None
    yield t, x, queries, doc_id
    vdb._reset_for_tests()
    vars(global_config).update(saved)


def _counters():
    c = metrics.snapshot()["counters"]
    return np.array([c.get(name, 0.0) for name in COUNTERS])


def _query(q, flt):
    code, rows = vdb.query("t", "Emb", q.tolist(), ["ID"], K, flt, True)
    assert code == 0
    return (np.array([r["ID"] for r in rows], np.int64),
            np.array([r["@distance"] for r in rows]))


def reference(x, q, keep, k):
    """The k nearest kept rows by float64 cosine distance (1 - cos of the
    unit row and the unit query), ties to the lower id: (ids, distances)."""
    xs = torch.from_numpy(x).double()
    xs = xs / xs.norm(dim=1, keepdim=True)
    qs = torch.from_numpy(q).double()
    qs = qs / qs.norm()
    d = 1.0 - xs @ qs
    d[~torch.from_numpy(keep)] = float("inf")
    order = np.lexsort((np.arange(len(d)), d.numpy()))[:k]
    return order, d.numpy()[order]


def _recall_floor():
    with open(CONFIG) as f:
        return 1.0 - json.load(f)["limits"]["recall_miss"]


@pytest.mark.parametrize("share", SHARES)
def test_route_and_answers_by_kept_share(table, share):
    t, x, queries, doc_id = table
    threshold = N - int(round(share * N))
    keep = doc_id >= threshold
    kept = int(keep.sum())
    assert kept == round(share * N)
    flat = kept * Table.SELECTIVE_FLAT_RATIO < N
    flt = f"doc_id >= {threshold}"
    before = _counters()
    hits = 0
    for q in queries:
        ids, d = _query(q, flt)
        assert len(ids) == K and keep[ids].all()
        want, want_d = reference(x, q, keep, K)
        if flat:
            np.testing.assert_array_equal(ids, want)
            np.testing.assert_allclose(d, want_d, rtol=0, atol=1e-6)
        hits += len(np.intersect1d(ids, want))
    moved = _counters() - before
    assert moved[0] == (QUERIES if flat else 0)
    assert moved[1] == (0 if flat else QUERIES)
    assert moved[2] == kept * QUERIES
    if not flat:
        assert hits / (K * QUERIES) >= _recall_floor()


def test_filter_span_nests_in_search_and_counters_move(table):
    t, x, queries, doc_id = table
    threshold = N - N // 100
    flt = f"doc_id >= {threshold}"
    _query(queries[0], flt)  # warm: the device filter is compiled
    before = _counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _query(queries[1], flt)
    moved = _counters() - before
    # The flat scan read the filter's kept rows alone.
    assert moved.tolist() == [1, 0, N // 100, N // 100]
    ranges = sorted(
        (ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(),
         ev.start_thread_id())
        for ev in prof.profiler.kineto_results.events()
        if ev.name().startswith("vdb.")
        and ev.device_type() == torch.autograd.DeviceType.CPU)
    searches = [r for r in ranges if r[0] == "vdb.search"]
    filters = [r for r in ranges if r[0] == "vdb.table.filter"]
    assert len(searches) == 1 and len(filters) == 2
    _, s0, s1, tid = searches[0]
    assert all(s0 <= a <= b <= s1 and th == tid
               for _, a, b, th in filters)
    # One range in the mask stage (the lookup), one in the dispatch (the
    # composed mask, its count and the route).
    for f, stage in zip(sorted(filters, key=lambda r: r[1]),
                        ("vdb.table.mask", "vdb.table.dispatch")):
        outer = [r for r in ranges if r[0] == stage]
        assert any(o[1] <= f[1] and f[2] <= o[2] for o in outer)
