"""The host validity mask of vectordb_tpu_torch's TableSegment: one
read-only snapshot per mutation version, its alive count stored beside it.

Every query reads the mask; a write (insert, upsert, delete) bumps the
version and the next query builds a new one, and a snapshot load starts a
new segment. The snapshot is never written in place (a host-folded filter
makes a new array), its count equals np.count_nonzero, a mask built across
a concurrent write is never served at the write's version, and a seeded
sequence of writes and queries on every route answers bit for bit as a
fresh build on every query does.
"""
import numpy as np
import pytest

import vectordb_tpu_torch as vdb
from vectordb_tpu_torch import segment as segment_mod
from vectordb_tpu_torch.config import global_config
from vectordb_tpu_torch.metrics import metrics
from vectordb_tpu_torch.schema import MetricType
from vectordb_tpu_torch.segment import TableSegment

DIM, SPARSE_DIM = 8, 64
N_GRAPH, N_FLAT = 400, 120
COUNTERS = ("valid_mask_builds_total", "valid_mask_reuses_total")


@pytest.fixture(autouse=True)
def _cpu_port():
    saved = dict(vars(global_config))
    vdb.set_device("cpu")
    global_config.flat_serve = "off"
    global_config.minimal_graph_size = 200
    global_config.auto_tune_search = False
    yield
    vdb._reset_for_tests()
    vars(global_config).update(saved)


def _fresh_build(self, n_padded=None):
    """valid_mask as it was before the snapshot: a new array every call."""
    n = self.record_number
    size = n_padded if n_padded is not None else n
    mask = np.zeros(size, dtype=bool)
    lim = min(n, size)
    mask[:lim] = ~self.deleted[:lim]
    return mask


def _counts():
    c = metrics.snapshot()["counters"]
    return np.array([int(c.get(k, 0)) for k in COUNTERS])


def _sparse(rng, nnz):
    idx = np.sort(rng.choice(SPARSE_DIM, size=nnz, replace=False))
    return {"indices": idx.tolist(),
            "values": rng.gamma(1.0, 1.0, nnz).astype(np.float32).tolist()}


def _records(rng, start, n):
    x = rng.normal(size=(n, DIM)).astype(np.float32)
    return [{"ID": start + i, "Tag": "ab"[(start + i) % 2],
             "Cat": (start + i) % 5, "Dense": x[i].tolist(),
             "Sparse": _sparse(rng, 6)} for i in range(n)]


def _db(path, seed=0):
    """Database "vm" with a graph table "g" (N_GRAPH rows) and a flat
    table "f" (N_FLAT rows, below MinimalGraphSize); each has a STRING
    column Tag (host-folded filters), an INT column Cat (device filters),
    a dense and a sparse field. Returns (rng, {name: Table})."""
    rng = np.random.default_rng(seed)
    assert vdb.load_db("vm", str(path), vector_scale=1000) == 0
    vdb.use_db("vm")
    for name, n in (("g", N_GRAPH), ("f", N_FLAT)):
        vdb.create_table(name, [
            {"name": "ID", "dataType": "INT", "primaryKey": True},
            {"name": "Tag", "dataType": "STRING"},
            {"name": "Cat", "dataType": "INT"},
            {"name": "Dense", "dataType": "VECTOR_FLOAT",
             "dimensions": DIM, "metricType": "EUCLIDEAN"},
            {"name": "Sparse", "dataType": "SPARSE_VECTOR_FLOAT",
             "dimensions": SPARSE_DIM, "metricType": "DOT_PRODUCT"}])
        assert vdb.insert(name, _records(rng, 0, n)) == 0
    assert vdb.rebuild() == 0
    tables = vdb._db.databases["vm"].tables
    assert tables["g"].graphs.get("Dense") is not None
    assert tables["f"].graphs.get("Dense") is None
    return rng, tables


def _query(table, vec, flt="", field="Dense"):
    code, rows = vdb.query(table, field, vec, ["ID"], 10, flt, True)
    assert code == 0
    return [(r["ID"], r["@distance"]) for r in rows]


def _dense_q(rng):
    return rng.normal(size=DIM).astype(np.float32).tolist()


def _write(kind, rng, tables, name="g"):
    seg = tables[name].segment
    n = seg.record_number
    if kind == "insert":
        assert vdb.insert(name, _records(rng, 10_000 + n, 3)) == 0
    elif kind == "upsert":
        assert vdb.insert(name, _records(rng, 5, 2), upsert=True) == 0
    else:
        assert vdb.delete_by_pk(name, [int(rng.integers(0, N_FLAT))]) == 0


@pytest.mark.parametrize("write", ["insert", "upsert", "delete", "load"])
def test_one_snapshot_per_version(tmp_path, write):
    """Queries at one version read one mask object; a write or a snapshot
    load gives a new one that holds the write."""
    rng, tables = _db(tmp_path)
    seg = tables["g"].segment
    first = seg.valid_mask()
    _query("g", _dense_q(rng))
    _query("g", _sparse(rng, 5), field="Sparse")
    assert seg.valid_mask() is first
    if write == "load":
        assert vdb.delete_by_pk("g", [7]) == 0
        before = seg.valid_mask()
        assert vdb.dump_db("vm", str(tmp_path)) == 0
        assert vdb.unload_db("vm") == 0
        assert vdb.load_db("vm", str(tmp_path), vector_scale=1000) == 0
        seg = vdb._db.databases["vm"].tables["g"].segment
        after = seg.valid_mask()
        assert after is not before and not after[7]
        np.testing.assert_array_equal(after, before)
        return
    _write(write, rng, tables)
    after = seg.valid_mask()
    assert after is not first
    np.testing.assert_array_equal(after, _fresh_build(seg))
    assert seg.valid_mask() is after


def test_served_mask_is_read_only(tmp_path):
    _, tables = _db(tmp_path)
    seg = tables["g"].segment
    for mask in (seg.valid_mask(), seg.valid_mask(n_padded=512)):
        assert not mask.flags.writeable
        with pytest.raises(ValueError):
            mask[0] = False
        with pytest.raises(ValueError):
            mask &= np.zeros_like(mask)
    assert seg.valid_mask().all()


@pytest.mark.parametrize("name", ["g", "f"])
def test_host_fold_leaves_the_snapshot_clean(tmp_path, name):
    """A host-folded string filter, then the same query unfiltered: the
    rows the filter left out come back."""
    _, tables = _db(tmp_path)
    seg = tables[name].segment
    snap = seg.valid_mask()
    vec = seg.dense_host["Dense"][3].tolist()  # row 3: Tag "b"
    filtered = _query(name, vec, "Tag = 'a'")
    assert filtered and all(i % 2 == 0 for i, _ in filtered)
    assert seg.valid_mask() is snap and snap.all()
    plain = _query(name, vec)
    assert plain[0][0] == 3
    assert any(i % 2 for i, _ in plain)


def test_alive_count(tmp_path):
    _, tables = _db(tmp_path)
    seg = tables["g"].segment
    assert vdb.delete_by_pk("g", [1, 2, 50]) == 0
    snap = seg.valid_mask()
    padded = seg.valid_mask(n_padded=512)
    folded = snap & (np.arange(len(snap)) % 3 == 0)
    for mask in (snap, padded, folded, snap.copy()):
        assert seg.alive_count(mask) == np.count_nonzero(mask)
    assert seg.alive_count(snap) == N_GRAPH - 3


def test_a_mask_built_across_a_write_is_not_served_after_it(tmp_path,
                                                             monkeypatch):
    """An insert lands between the version read and the store (here, at
    the build counter): the mask built before it answers its own caller
    and is not served at the insert's version."""
    rng, tables = _db(tmp_path)
    seg = tables["g"].segment
    _write("delete", rng, tables)  # a new version: the next call builds
    n = seg.record_number
    fired = []

    class _Hook:
        def inc(self, name, value=1.0):
            metrics.inc(name, value)
            if name == "valid_mask_builds_total" and not fired:
                fired.append(1)
                _write("insert", rng, tables)

    monkeypatch.setattr(segment_mod, "metrics", _Hook())
    stale = seg.valid_mask()
    assert fired and len(stale) == n
    fresh = seg.valid_mask()
    assert fresh is not stale and len(fresh) == n + 3 and fresh[n:].all()
    assert seg.valid_mask() is fresh


def _answers(rng_q, tables):
    """One round of queries on every route, as comparable tuples."""
    g, f = tables["g"], tables["f"]
    out = []
    for name in ("g", "f"):
        q = _dense_q(rng_q)
        out.append(_query(name, q))
        out.append(_query(name, q, "Tag = 'b'"))
        out.append(_query(name, q, "Cat < 2"))
        out.append(_query(name, _sparse(rng_q, 5), field="Sparse"))
        out.append(_query(name, _sparse(rng_q, 5), "Tag = 'a'",
                          field="Sparse"))
    code, rows = vdb.hybrid_query(
        "g", [{"field": "Dense", "vector": _dense_q(rng_q), "weight": 0.5},
              {"field": "Sparse", "vector": _sparse(rng_q, 5),
               "weight": 0.5}], ["ID"], 10, "", True)
    assert code == 0
    out.append([(r["ID"], r["@distance"]) for r in rows])
    qs = rng_q.normal(size=(5, DIM)).astype(np.float32)
    for t in (g, f):
        ids, d = t.batch_dense_search("Dense", qs, t.segment.valid_mask(),
                                      MetricType.EUCLIDEAN, 10,
                                      mask_cacheable=True)
        out.append((ids.tobytes(), d.tobytes()))
    ids, d = g.grouped_dense_search("Dense", qs, g.segment.valid_mask(),
                                    MetricType.EUCLIDEAN, 10, batch=2,
                                    mask_cacheable=True)
    out.append((ids.tobytes(), d.tobytes()))
    return out


def test_cached_masks_answer_as_fresh_builds(tmp_path, monkeypatch):
    """A seeded sequence of inserts, upserts, deletes and queries (graph,
    flat, sparse, hybrid, batched and grouped; unfiltered, host-folded and
    device filters): each round answers bit for bit as the same round with
    valid_mask building a new mask on every call."""
    rng, tables = _db(tmp_path)
    ops = np.random.default_rng(11)
    for step in range(4):
        seed = 100 + step
        got = _answers(np.random.default_rng(seed), tables)
        with monkeypatch.context() as m:
            m.setattr(TableSegment, "valid_mask", _fresh_build)
            want = _answers(np.random.default_rng(seed), tables)
        assert got == want, step
        for name in ("g", "f"):
            _write(("insert", "upsert", "delete")[int(ops.integers(3))],
                   rng, tables, name)


def test_counters(tmp_path):
    """A build when a version's mask is first asked for; after that, one
    reuse a query (its device mask is cached); a write's first query builds
    once and reuses once (the device mask's miss takes the snapshot)."""
    rng, tables = _db(tmp_path)
    seg = tables["g"].segment
    for fld, vec in (("Dense", _dense_q(rng)), ("Sparse", _sparse(rng, 5))):
        _query("g", vec, field=fld)
        before = _counts()
        for _ in range(4):
            _query("g", vec, field=fld)
        assert (_counts() - before).tolist() == [0, 4]
    _write("delete", rng, tables)
    before = _counts()
    _query("g", _dense_q(rng))
    assert (_counts() - before).tolist() == [1, 1]
    before = _counts()
    seg.valid_mask(n_padded=512)
    seg.valid_mask(n_padded=512)
    assert (_counts() - before).tolist() == [1, 1]
