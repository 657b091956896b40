"""Device filter masks: vectordb_tpu_torch/expr/device.py and the filter
routing of its Table, held against vectordb_tpu and the host evaluator.

Both packages run the cases of tests/test_device_filter.py on the same
seeded tables; ids must equal the masked numpy oracle (flat path) or agree
as sets with the JAX package (graph path), distances within rtol 1e-5.

The port's device mask must equal the host FilterCompiler's mask bit for
bit. The JAX package's does not on DOUBLE values within float32 rounding
of a constant: it uploads columns and constants as float32, so
`price > 10.5` over prices 10.5 +- 1e-9 keeps no row where the host keeps
half. The expected value here is the host evaluator's.
"""
import numpy as np
import pytest
import torch

import vectordb_tpu as jvdb
import vectordb_tpu_torch as tvdb
from vectordb_tpu.config import global_config as jax_config
from vectordb_tpu.expr.device import is_device_compilable as j_compilable
from vectordb_tpu.expr.parser import parse_expr as j_parse
from vectordb_tpu.schema import FieldType as JFieldType
from vectordb_tpu.schema import MetricType
from vectordb_tpu_torch.config import global_config as torch_config
from vectordb_tpu_torch.expr.device import is_device_compilable
from vectordb_tpu_torch.expr.evaluator import FilterCompiler, haversine_km
from vectordb_tpu_torch.expr.parser import parse_expr
from vectordb_tpu_torch.ops import beam as tbeam
from vectordb_tpu_torch.schema import FieldType
from vectordb_tpu_torch.segment import TableSegment
from vectordb_tpu_torch.table import Table as TorchTable

from test_torch_cuda import (ADV_FILTERS, adversarial_table,
                             device_and_host_masks)

PKGS = [jvdb, tvdb]


@pytest.fixture(autouse=True)
def _reset_port():
    saved_t, saved_j = dict(vars(torch_config)), dict(vars(jax_config))
    tvdb.set_device("cpu")  # the CPU run of the port: plain versions
    yield
    tvdb._reset_for_tests()
    vars(torch_config).update(saved_t)
    vars(jax_config).update(saved_j)


def _fields_map(ft):
    return {"ID": ft.INT8, "price": ft.DOUBLE, "stock": ft.INT4,
            "active": ft.BOOL, "name": ft.STRING, "loc": ft.GEO_POINT,
            "@distance": ft.DOUBLE}


@pytest.mark.parametrize("expr,ok", [
    ("price > 10.5", True),
    ("price * 2.0 + stock > 30.0 AND active", True),
    ("NOT (stock % 3 = 0)", True),
    ("NEARBY(loc, 37.0, -122.0, 50.0)", True),
    ("name = 'abc'", False),
    ("name LIKE 'a%'", False),
    ("@distance < 1.5", False),
])
def test_is_device_compilable_matches_jax(expr, ok):
    assert is_device_compilable(parse_expr(expr, _fields_map(FieldType))) \
        == j_compilable(j_parse(expr, _fields_map(JFieldType))) == ok


def _setup(pkg, path, n=3000, dim=32):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    assert pkg.load_db("fdb", str(path)) == 0
    pkg.use_db("fdb")
    pkg.create_table("t", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "price", "dataType": "DOUBLE"},
        {"name": "active", "dataType": "BOOL"},
        {"name": "loc", "dataType": "GEO_POINT"},
        {"name": "V", "dataType": "VECTOR_FLOAT", "dimensions": dim,
         "metricType": "EUCLIDEAN"}])
    price = rng.uniform(0, 100, n)
    active = rng.integers(0, 2, n).astype(bool)
    lat = rng.uniform(-60, 60, n)
    lon = rng.uniform(-179, 179, n)
    pkg.insert("t", [{"ID": i, "price": float(price[i]),
                      "active": bool(active[i]),
                      "loc": {"latitude": float(lat[i]),
                              "longitude": float(lon[i])},
                      "V": x[i].tolist()} for i in range(n)])
    return x, price, active, lat, lon


def _ids_dists(res):
    return ([r["ID"] for r in res],
            np.asarray([r["@distance"] for r in res], np.float64))


def _both(tmp_path, q, k, flt, **kw):
    """Query both packages (each set up by _setup beforehand); returns the
    port's ids after checking them and the distances against JAX's."""
    out = []
    for pkg in PKGS:
        pkg.use_db("fdb")
        out.append(_ids_dists(pkg.query("t", "V", q.tolist(), ["ID"], k,
                                        flt, True)[1]))
    (jid, jd), (tid, td) = out
    assert tid == jid
    np.testing.assert_allclose(td, jd, rtol=1e-5)
    return tid


def _setup_both(tmp_path, **kw):
    for pkg, sub in ((jvdb, "j"), (tvdb, "t")):
        data = _setup(pkg, tmp_path / sub, **kw)
    return data


def _oracle(x, q, sel, k=10):
    d = ((x - q) ** 2).sum(1)
    d[~sel] = np.inf
    return np.argsort(d, kind="stable")[:min(k, int(sel.sum()))].tolist()


def test_device_filter_matches_oracle(tmp_path):
    x, price, active, lat, lon = _setup_both(tmp_path)
    q = x[100]
    ids = _both(tmp_path, q, 10, "price > 50.0 AND active")
    table = tvdb._db.databases["fdb"].tables["t"]
    assert table._device_filter_cache, "device filter did not engage"
    assert ids == _oracle(x, q, (price > 50.0) & active)


def test_device_filter_repeat_and_new_constants(tmp_path):
    x, price, active, lat, lon = _setup_both(tmp_path)
    q = x[5]
    for thr in (20.0, 80.0, 20.0):
        assert _both(tmp_path, q, 10, f"price < {thr}") == _oracle(
            x, q, price < thr), thr
    table = tvdb._db.databases["fdb"].tables["t"]
    assert len(table._device_filter_cache) == 2


def test_device_nearby_filter(tmp_path):
    x, price, active, lat, lon = _setup_both(tmp_path)
    q = x[9]
    sel = haversine_km(lat, lon, 10.0, 20.0) <= 2000.0
    assert _both(tmp_path, q, 10, "NEARBY(loc, 10.0, 20.0, 2000.0)") == \
        _oracle(x, q, sel)


def test_string_filter_stays_on_host(tmp_path):
    x, price, active, lat, lon = _setup_both(tmp_path, n=500)
    q = x[3]
    _both(tmp_path, q, 5, "ID < 100")
    table = tvdb._db.databases["fdb"].tables["t"]
    assert len(table._device_filter_cache) == 1
    # @distance filters do not take the device path.
    ids = _both(tmp_path, q, 5, "@distance < 1000.0")
    assert len(table._device_filter_cache) == 1
    assert ids[0] == 3


def test_big_int_pk_stays_on_device(tmp_path):
    """INT8 keys past 2^24: the JAX package folds them on the host (its
    float32 columns can't hold them); the port keeps them on the device
    as int64. Both match the oracle."""
    rng = np.random.default_rng(1)
    dim = 16
    x = rng.normal(size=(300, dim)).astype(np.float32)
    base = 1 << 30
    ids_all = [base + 3 * i for i in range(300)]
    for pkg, sub in ((jvdb, "j"), (tvdb, "t")):
        assert pkg.load_db("fdb2", str(tmp_path / sub)) == 0
        pkg.use_db("fdb2")
        pkg.create_table("t2", [
            {"name": "ID", "dataType": "BIGINT", "primaryKey": True},
            {"name": "V", "dataType": "VECTOR_FLOAT", "dimensions": dim,
             "metricType": "EUCLIDEAN"}])
        pkg.insert("t2", [{"ID": ids_all[i], "V": x[i].tolist()}
                          for i in range(300)])
    q = x[250]
    thr = base + 3 * 100
    d = ((x - q) ** 2).sum(1)
    d[np.asarray(ids_all) >= thr] = np.inf
    oracle = [ids_all[i] for i in np.argsort(d, kind="stable")[:5]]
    for pkg in PKGS:
        got = [r["ID"] for r in pkg.query("t2", "V", q.tolist(), ["ID"], 5,
                                          f"ID < {thr}")[1]]
        assert got == oracle
    table = tvdb._db.databases["fdb2"].tables["t2"]
    assert len(table._device_filter_cache) == 1


def test_all_masked_graph_query(tmp_path):
    """Every row filtered out: graph path + flat top-up return nothing;
    a single-match filter returns exactly that row."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1500, 16)).astype(np.float32)
    for pkg, sub in ((jvdb, "j"), (tvdb, "t")):
        assert pkg.load_db("fdb3", str(tmp_path / sub)) == 0
        pkg.use_db("fdb3")
        pkg.create_table("t3", [
            {"name": "ID", "dataType": "INT", "primaryKey": True},
            {"name": "V", "dataType": "VECTOR_FLOAT", "dimensions": 16,
             "metricType": "EUCLIDEAN"}])
        pkg.insert("t3", [{"ID": i, "V": x[i].tolist()} for i in range(1500)])
        assert pkg.rebuild() == 0
        assert pkg.query("t3", "V", x[0].tolist(), ["ID"], 10, "ID < 0")[1] \
            == []
        res = pkg.query("t3", "V", x[0].tolist(), ["ID"], 10, "ID = 700")[1]
        assert [r["ID"] for r in res] == [700]


# ---------------------------------------------------------------------------
# Selectivity gate and the grouped graph path.
# ---------------------------------------------------------------------------


def _graph_both(tmp_path, n, dim, seed, cfg=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    cat = rng.integers(0, 10, n)
    price = rng.uniform(0, 100, n)
    tables = []
    for pkg, sub in ((jvdb, "j"), (tvdb, "t")):
        assert pkg.load_db("g", str(tmp_path / sub), vector_scale=n) == 0
        pkg.use_db("g")
        pkg.create_table("t", [
            {"name": "ID", "dataType": "INT", "primaryKey": True},
            {"name": "cat", "dataType": "INT"},
            {"name": "price", "dataType": "DOUBLE"},
            {"name": "V", "dataType": "VECTOR_FLOAT", "dimensions": dim,
             "metricType": "EUCLIDEAN"}])
        pkg.insert_columns("t", {"ID": np.arange(n), "cat": cat,
                                 "price": price, "V": x})
        if cfg:
            assert pkg.update_config(cfg) == 0
        assert pkg.rebuild() == 0
        tables.append(pkg._db.databases["g"].tables["t"])
    return x, cat, price, tables[0], tables[1]


@pytest.mark.parametrize("flt,lo,hi,route", [
    ("ID < 100", 0, 100, "flat"),          # 5%: exact pre-filter scan
    ("ID >= 1000", 1000, 2000, "boosted"),  # 50%: graph, widened beam
    ("ID >= 300", 300, 2000, "graph"),     # 85%: graph, plain beam
])
def test_selectivity_gate_routes_match_jax(tmp_path, monkeypatch, flt, lo,
                                           hi, route):
    n, dim = 2000, 16
    rng = np.random.default_rng(21)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    for pkg, sub in ((jvdb, "j"), (tvdb, "t")):
        assert pkg.load_db("fdb4", str(tmp_path / sub)) == 0
        pkg.use_db("fdb4")
        pkg.create_table("t4", [
            {"name": "ID", "dataType": "INT", "primaryKey": True},
            {"name": "V", "dataType": "VECTOR_FLOAT", "dimensions": dim,
             "metricType": "EUCLIDEAN"}])
        pkg.insert("t4", [{"ID": i, "V": x[i].tolist()} for i in range(n)])
        assert pkg.rebuild() == 0
    from vectordb_tpu.ops import beam as jbeam
    widths = {"j": [], "t": []}
    for mod, key in ((jbeam, "j"), (tbeam, "t")):
        orig = mod.beam_search_topk
        monkeypatch.setattr(
            mod, "beam_search_topk",
            lambda *a, _o=orig, _k=key, **k: (widths[_k].append(a[7]),
                                              _o(*a, **k))[1])
    q = x[1234]
    keep = (np.arange(n) >= lo) & (np.arange(n) < hi)
    d = ((x - q) ** 2).sum(1)
    oracle = [int(i) for i in np.argsort(d, kind="stable") if keep[i]][:10]
    got = {}
    for pkg, key in ((jvdb, "j"), (tvdb, "t")):
        pkg.use_db("fdb4")
        got[key] = _ids_dists(pkg.query("t4", "V", q.tolist(), ["ID"], 10,
                                        flt, True)[1])
    assert widths["t"] == widths["j"]
    np.testing.assert_allclose(
        sorted(got["t"][1]), sorted(got["j"][1]), rtol=1e-5)
    if route == "flat":
        assert widths["t"] == []
        assert got["t"][0] == oracle
    else:
        assert len(widths["t"]) == 1
        ef = torch_config.search_ef
        assert (widths["t"][0] > ef) == (route == "boosted")
        assert len(set(got["t"][0]) & set(oracle)) >= 9
    assert tvdb._db.databases["fdb4"].tables["t4"]._device_filter_cache


@pytest.mark.parametrize("flt,grouped", [
    ("cat < 5", True), ("price > 80.0", True), ("price < 5.0", False)])
def test_grouped_graph_with_device_filter_matches_jax(tmp_path, monkeypatch,
                                                      flt, grouped):
    """6,000 rows with FlatServe=off: a device filter reaches the grouped
    graph program with a widened beam; a selective one (< 1/8 of rows)
    goes to the per-batch path and its exact pre-filter scan."""
    n, dim, nq = 6000, 32, 600
    x, cat, price, jt, tt = _graph_both(tmp_path, n, dim, seed=31,
                                        cfg={"FlatServe": "off"})
    calls = []
    orig = tbeam.beam_search_grouped
    monkeypatch.setattr(tbeam, "beam_search_grouped",
                        lambda *a, **k: calls.append(a[8]) or orig(*a, **k))
    rng = np.random.default_rng(32)
    queries = (x[rng.integers(0, n, nq)]
               + 0.05 * rng.normal(size=(nq, dim))).astype(np.float32)
    keep = {"cat < 5": cat < 5, "price > 80.0": price > 80.0,
            "price < 5.0": price < 5.0}[flt]
    out = []
    for t, parse in ((jt, j_parse), (tt, parse_expr)):
        ctx = t._device_filter(parse(flt, t.field_type_map),
                               t._compile_filter(flt))
        assert ctx is not None
        out.append(t.grouped_dense_search(
            "V", queries, t.segment.valid_mask(), MetricType.EUCLIDEAN, 10,
            batch=128, mask_cacheable=True, filter_ctx=ctx))
    (jid, jd), (tid, td) = out
    assert bool(calls) == grouped
    if grouped:
        assert all(bw > torch_config.search_ef for bw in calls)
    assert tid.shape == jid.shape == (nq, 10)
    assert keep[tid[tid >= 0]].all()
    d = ((x[None, :, :] - queries[:50, None, :]) ** 2).sum(2)
    d[:, ~keep] = np.inf
    want = np.argsort(d, axis=1, kind="stable")[:, :10]
    agree = np.mean([set(a) == set(b) for a, b in zip(tid, jid)])
    assert agree >= 0.99, agree
    rec_t = np.mean([len(set(a) & set(b)) / 10
                     for a, b in zip(tid[:50], want)])
    rec_j = np.mean([len(set(a) & set(b)) / 10
                     for a, b in zip(jid[:50], want)])
    assert rec_t >= rec_j - 0.005
    if not grouped:
        assert rec_t == 1.0
    exact = ((x[tid] - queries[:, None, :]) ** 2).sum(2)
    np.testing.assert_allclose(td, exact, rtol=1e-5)


# ---------------------------------------------------------------------------
# Bit-for-bit against the host evaluator on adversarial values.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flt", ADV_FILTERS)
def test_device_mask_equals_host_mask(tmp_path, flt):
    table, _ = adversarial_table(tmp_path)
    dev, host = device_and_host_masks(table, flt)
    np.testing.assert_array_equal(dev, host, err_msg=flt)


def test_device_columns_are_exact(tmp_path):
    table, cols = adversarial_table(tmp_path)
    seg = table.segment
    for name, dtype in (("price", torch.float64), ("big", torch.int64),
                        ("stock", torch.int64), ("f32", torch.float64),
                        ("active", torch.bool)):
        c = seg.device_column(name, 4096)
        assert c.dtype == dtype and c.shape == (4096,)
        np.testing.assert_array_equal(c[:40].cpu().numpy(),
                                      np.asarray(cols[name]).astype(
                                          c.cpu().numpy().dtype))
    lat, lon = seg.device_column("loc", 4096)
    assert lat.dtype == lon.dtype == torch.float64
    np.testing.assert_array_equal(lat[:40].cpu().numpy(), cols["loc"][0])


def test_price_boundary_through_query_diverges_from_jax(tmp_path):
    """The 40-row table of prices 10.5 +- 1e-9: `price > 10.5` keeps the
    20 rows above 10.5 on the host and through the port's device filter;
    the JAX package's float32 device filter keeps none (the divergence
    this port repairs)."""
    n = 40
    price = np.where(np.arange(n) % 2 == 0, 10.5 + 1e-9, 10.5 - 1e-9)
    x = np.random.default_rng(3).normal(size=(n, 4)).astype(np.float32)
    got = {}
    for pkg, sub in ((jvdb, "j"), (tvdb, "t")):
        assert pkg.load_db("p", str(tmp_path / sub)) == 0
        pkg.use_db("p")
        pkg.create_table("t", [
            {"name": "ID", "dataType": "INT", "primaryKey": True},
            {"name": "price", "dataType": "DOUBLE"},
            {"name": "V", "dataType": "VECTOR_FLOAT", "dimensions": 4,
             "metricType": "EUCLIDEAN"}])
        pkg.insert_columns("t", {"ID": np.arange(n), "price": price, "V": x})
        got[pkg] = sorted(r["ID"] for r in pkg.query(
            "t", "V", [0.0] * 4, ["ID"], 100, "price > 10.5")[1])
    table = tvdb._db.databases["p"].tables["t"]
    host = FilterCompiler(parse_expr("price > 10.5", table.field_type_map),
                          table.segment.column).mask(n_rows=n)
    assert got[tvdb] == np.nonzero(host)[0].tolist() == list(range(0, n, 2))
    assert table._device_filter_cache
    assert got[jvdb] == []


def test_device_filter_errors_propagate(tmp_path, monkeypatch):
    """An evaluator fault raises out of the query; the filter is not
    folded on the host instead."""
    x, *_ = _setup(tvdb, tmp_path / "t", n=200)

    def boom(self, name, capacity):
        raise RuntimeError("device column failed")

    with monkeypatch.context() as m:
        m.setattr(TableSegment, "device_column", boom)
        with pytest.raises(RuntimeError, match="device column failed"):
            tvdb.query("t", "V", x[0].tolist(), ["ID"], 5, "price > 50.0")
    res = tvdb.query("t", "V", x[0].tolist(), ["ID"], 5, "price > 50.0")[1]
    assert len(res) == 5


def test_device_filter_cache_is_bounded(tmp_path):
    x, *_ = _setup(tvdb, tmp_path / "t", n=100)
    table = tvdb._db.databases["fdb"].tables["t"]
    for i in range(TorchTable.DEVICE_FILTER_CACHE + 3):
        tvdb.query("t", "V", x[0].tolist(), ["ID"], 1, f"price > {i}.5")
    assert len(table._device_filter_cache) <= TorchTable.DEVICE_FILTER_CACHE
