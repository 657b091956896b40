"""A dense query under a STRING label filter, through vdb.query, on the
port's CPU route: the filter folds on the host (a STRING comparison does
not compile to the device), the selectivity gate picks the walk or the
exact masked flat scan by the share of rows the label keeps, and the
answers are held against a plain float64 torch reference of their own and
against the JAX package, which folds and gates the same filter on the same
rows (vectordb_tpu/table.py, Table._search_ids).

The table is cohere-768-1m-labels' shape at a CPU test's size: unit rows of
a clustered process, COSINE, a STRING `labels` column whose labels carry
VectorDBBench's shares exactly (a permutation of fixed counts), a graph
built, FlatServe off. label_50p keeps half the rows, so it walks with the
gate's boost; label_5p keeps fewer than N / SELECTIVE_FLAT_RATIO, so it
takes the flat scan.
"""
import json
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import vectordb_tpu_torch as vdb
from vectordb_tpu_torch.config import global_config
from vectordb_tpu_torch.metrics import metrics
from vectordb_tpu_torch.table import Table

N, DIM, K, QUERIES = 4000, 32, 10, 24
COUNTS = {"label_50p": 2000, "label_20p": 800, "label_10p": 400,
          "label_5p": 200, "label_2p": 80, "label_1p": 40, "label_0.5p": 20,
          "label_0.2p": 8, "label_0.1p": 4, "label_other": 448}
COUNTERS = ("host_filter_folds_total", "host_fold_route_walk_total",
            "host_fold_route_flat_total")
CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "perfbench", "configs",
    "cohere-768-1m-labels.json")

SCHEMA = [{"name": "ID", "dataType": "INT", "primaryKey": True},
          {"name": "Emb", "dataType": "VECTOR_FLOAT", "dimensions": DIM,
           "metricType": "COSINE"},
          {"name": "labels", "dataType": "STRING"}]

# 40 Gaussian centres in 8 latent dimensions, carried into DIM columns.
_LATENT = np.random.default_rng(23)
BASIS = np.linalg.qr(_LATENT.normal(size=(DIM, DIM)))[0][:8]
CENTERS = 2.0 * _LATENT.normal(size=(40, 8))


def _clustered(rng, n):
    """n rows of the clustered process: a centre plus N(0, 1) in the
    latent dimensions, plus N(0, 0.05^2) a column."""
    z = CENTERS[rng.integers(0, len(CENTERS), n)] + rng.normal(size=(n, 8))
    return (z @ BASIS + 0.05 * rng.normal(size=(n, DIM))).astype(np.float32)


def _defaults(cfg):
    """Every setting of a package's global config back at its default, so
    that what an earlier test in the process left behind (a search width,
    say) does not reach these tables."""
    vars(cfg).update({k: v for k, v in vars(type(cfg)()).items()
                      if k != "_lock"})


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    saved = dict(vars(global_config))
    _defaults(global_config)
    vdb.set_device("cpu")
    rng = np.random.default_rng(7)
    x = _clustered(rng, N)
    queries = _clustered(rng, QUERIES)
    labels = np.repeat(list(COUNTS), list(COUNTS.values()))[
        rng.permutation(N)].astype(object)
    assert vdb.update_config({"AutoTuneSearch": False,
                              "FlatServe": "off"}) == 0
    assert vdb.load_db("lab", str(tmp_path_factory.mktemp("lab")),
                       vector_scale=N) == 0
    vdb.use_db("lab")
    vdb.create_table("t", SCHEMA)
    code, _ = vdb.insert_columns("t", {"ID": np.arange(N), "Emb": x,
                                       "labels": labels.tolist()})
    assert code == 0
    assert vdb.rebuild() == 0
    t = vdb._db.databases["lab"].tables["t"]
    assert t.graphs.get("Emb") is not None
    yield t, x, queries, labels
    vdb._reset_for_tests()
    vars(global_config).update(saved)


@pytest.fixture(scope="module")
def jax_engine(table, tmp_path_factory):
    """The JAX package's engine over the same rows, labels and settings.
    An engine of its own, not the module API's, so that the API's reset
    after every test leaves it standing."""
    import vectordb_tpu as jvdb
    from vectordb_tpu.config import global_config as jax_config

    _, x, _, labels = table
    saved = dict(vars(jax_config))
    _defaults(jax_config)
    assert jax_config.update({"AutoTuneSearch": False,
                              "FlatServe": "off"})[0]
    eng = jvdb.DBServer()
    assert eng.load_db("lab", str(tmp_path_factory.mktemp("jlab")), N).ok()
    assert eng.create_table("lab", {"name": "t", "fields": SCHEMA})[0].ok()
    assert eng.insert_columns("lab", "t", {"ID": np.arange(N), "Emb": x,
                                           "labels": labels.tolist()}).ok()
    assert eng.rebuild().ok()
    yield eng
    eng.stop()
    vars(jax_config).update(saved)


def _counters():
    c = metrics.snapshot()["counters"]
    return np.array([c.get(name, 0.0) for name in COUNTERS])


def _query(q, flt):
    code, rows = vdb.query("t", "Emb", q.tolist(), ["ID"], K, flt, True)
    assert code == 0
    return (np.array([r["ID"] for r in rows], np.int64),
            np.array([r["@distance"] for r in rows]))


def reference(x, q, keep):
    """Float64 cosine distances (1 - cos of the unit row and the unit
    query) of every row, and the K nearest kept rows, ties to the lower
    id."""
    xs = torch.from_numpy(x).double()
    xs = xs / xs.norm(dim=1, keepdim=True)
    qs = torch.from_numpy(q).double()
    qs = qs / qs.norm()
    d = (1.0 - xs @ qs).numpy()
    masked = np.where(keep, d, np.inf)
    return d, np.lexsort((np.arange(len(d)), masked))[:K]


def _recall_floor():
    with open(CONFIG) as f:
        return 1.0 - json.load(f)["limits"]["recall_miss"]


def _like(pattern):
    rx = re.compile("^" + re.escape(pattern).replace("%", ".*")
                    .replace("_", ".") + "$")
    return lambda s: bool(rx.match(s))


# (filter, the reference's predicate of a label)
FILTERS = [
    ("labels = 'label_50p'", lambda s: s == "label_50p"),
    ("labels = 'label_5p'", lambda s: s == "label_5p"),
    ("labels <> 'label_50p'", lambda s: s != "label_50p"),
    ("labels IN ('label_5p', 'label_1p', 'label_0.1p')",
     lambda s: s in ("label_5p", "label_1p", "label_0.1p")),
    ("labels IN ('label_50p', 'label_20p')",
     lambda s: s in ("label_50p", "label_20p")),
    ("labels LIKE 'label_%0p'", _like("label_%0p")),
    ("labels LIKE 'label_0._p'", _like("label_0._p")),
]


@pytest.mark.parametrize("flt,pred", FILTERS, ids=[f for f, _ in FILTERS])
def test_route_and_answers_against_the_reference(table, flt, pred):
    """Every returned row passes the reference's mask with its float64
    distance within 1e-5; the gate's route follows the kept share, the
    flat scan answers exactly and the walk at the configuration's recall;
    the host fold's mask equals the reference's."""
    t, x, queries, labels = table
    keep = np.array([pred(s) for s in labels])
    kept = int(keep.sum())
    assert kept >= K
    np.testing.assert_array_equal(t._compile_filter(flt).mask(n_rows=N),
                                  keep)
    flat = kept * Table.SELECTIVE_FLAT_RATIO < N
    before = _counters()
    hits = 0
    for q in queries:
        ids, d = _query(q, flt)
        assert len(ids) == K and keep[ids].all()
        ref_d, want = reference(x, q, keep)
        np.testing.assert_allclose(d, ref_d[ids], rtol=0, atol=1e-5)
        if flat:
            np.testing.assert_array_equal(ids, want)
        hits += len(np.intersect1d(ids, want))
    moved = _counters() - before
    assert moved.tolist() == [QUERIES, 0 if flat else QUERIES,
                              QUERIES if flat else 0]
    assert hits / (K * QUERIES) >= (1.0 if flat else _recall_floor())


@pytest.mark.parametrize("flt,pred", FILTERS, ids=[f for f, _ in FILTERS])
def test_route_and_answers_agree_with_the_jax_package(
        table, jax_engine, monkeypatch, flt, pred):
    """The JAX package folds the same filter on the host and gates it the
    same way: the same walk width for every query (no walk on the flat
    route), the same ids on the flat route, and on the walk ids that agree
    as sets with a recall no lower than JAX's; distances within 1e-5."""
    from vectordb_tpu.ops import beam as jbeam
    from vectordb_tpu_torch.ops import beam as tbeam

    _, x, queries, labels = table
    widths = {"j": [], "t": []}
    for mod, key in ((jbeam, "j"), (tbeam, "t")):
        orig = mod.beam_search_topk
        monkeypatch.setattr(
            mod, "beam_search_topk",
            lambda *a, _o=orig, _k=key, **k: (widths[_k].append(a[7]),
                                              _o(*a, **k))[1])
    keep = np.array([pred(s) for s in labels])
    flat = int(keep.sum()) * Table.SELECTIVE_FLAT_RATIO < N
    agree = hits_t = hits_j = 0
    for q in queries:
        tid, td = _query(q, flt)
        status, rows, _ = jax_engine.search("lab", "t", "Emb", ["ID"],
                                            q.tolist(), K, flt, True)
        assert status.ok()
        jid = np.array([r["ID"] for r in rows], np.int64)
        jd = np.array([r["@distance"] for r in rows])
        _, want = reference(x, q, keep)
        if flat:
            np.testing.assert_array_equal(tid, jid)
        if set(tid) == set(jid):
            agree += 1
            np.testing.assert_allclose(np.sort(td), np.sort(jd), rtol=0,
                                       atol=1e-5)
        hits_t += len(np.intersect1d(tid, want))
        hits_j += len(np.intersect1d(jid, want))
    assert widths["t"] == widths["j"]
    assert len(widths["t"]) == (0 if flat else QUERIES)
    assert agree >= 0.95 * QUERIES
    assert hits_t >= hits_j - 0.005 * K * QUERIES


def test_half_the_rows_walk_with_the_gates_boost(table):
    """label_50p keeps 2,000 of 4,000 rows: the gate's boost is 4."""
    t, _, _, labels = table
    kept = int((labels == "label_50p").sum())
    assert kept == N // 2
    assert Table._selectivity(N, kept) == 4
    assert Table._selectivity(N, int((labels == "label_5p").sum())) is None


@pytest.mark.parametrize("flt,route", [("labels = 'label_50p'", 1),
                                       ("labels = 'label_5p'", 2)])
def test_fold_span_and_counters_once_a_query(table, flt, route):
    """One query: one "vdb.table.fold" range inside the mask stage of its
    "vdb.search", the fold counter moved once, one route counter and not
    the other."""
    t, _, queries, _ = table
    _query(queries[0], flt)
    before = _counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _query(queries[1], flt)
    moved = _counters() - before
    want = [1, 0, 0]
    want[route] = 1
    assert moved.tolist() == want
    ranges = sorted(
        (ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
        for ev in prof.profiler.kineto_results.events()
        if ev.name().startswith("vdb.")
        and ev.device_type() == torch.autograd.DeviceType.CPU)
    folds = [r for r in ranges if r[0] == "vdb.table.fold"]
    (search,) = [r for r in ranges if r[0] == "vdb.search"]
    (mask,) = [r for r in ranges if r[0] == "vdb.table.mask"]
    assert len(folds) == 1
    assert search[1] <= mask[1] <= folds[0][1] <= folds[0][2] <= mask[2] \
        <= search[2]


def test_unfiltered_and_device_filtered_queries_neither_fold_nor_upload(
        table):
    """No filter, or one that compiles to the device (ID is an INT
    column): no fold is counted."""
    _, _, queries, _ = table
    before = _counters()
    for flt in ("", "ID >= 2000"):
        _query(queries[2], flt)
    assert (_counters() - before).tolist() == [0, 0, 0]
