"""The filtered scan by ids on the port's CPU route: ops/flat.id_topk (the
plain version of the id-scan kernel, ops/id_scan.id_scan_ref, under
torch.topk) against the full masked scan flat_topk, the kernel wrapper's
argument checks, and, through vdb.query, the kept-id list a device filter
builds once per filter and mutation version (DeviceFilter.kept_ids), the
routes that take the id scan and those that keep the full-table scan, and
their counters (flat_id_scans_total, flat_id_lists_built_total,
flat_scan_rows_total).

Rows and queries of the scan tests are integer-valued and bf16-exact, so
every f32 distance is exact in any order of summation: the two scans must
give the same distances bit for bit, and ids that differ only among rows at
the same distance.
"""
import numpy as np
import pytest
import torch

import vectordb_tpu_torch as vdb
from vectordb_tpu_torch.config import global_config
from vectordb_tpu_torch.metrics import metrics
from vectordb_tpu_torch.ops import flat as flat_ops
from vectordb_tpu_torch.ops import id_scan
from vectordb_tpu_torch.schema import MetricType

METRICS = [MetricType.EUCLIDEAN, MetricType.COSINE, MetricType.DOT_PRODUCT]
SCAN_N, SCAN_B, SCAN_K = 6000, 3, 42
# Kept rows: one, fewer than k, 1% and 10% of the table.
SHARES = {"one": 1, "under_k": 20, "1pct": SCAN_N // 100,
          "10pct": SCAN_N // 10}


def _scan_case(dim: int, kept: int, seed: int = 0):
    """(queries [B, D] f32, bf16 table [N, D], f32 norms [N], kept ids
    [m] int32, mask [N] bool, float64 rows)."""
    rng = np.random.default_rng(seed + dim + kept)
    x = rng.integers(-8, 9, size=(SCAN_N, dim)).astype(np.float32)
    q = rng.integers(-8, 9, size=(SCAN_B, dim)).astype(np.float32)
    ids = np.sort(rng.choice(SCAN_N, kept, replace=False)).astype(np.int32)
    mask = np.zeros(SCAN_N, dtype=bool)
    mask[ids] = True
    return (torch.from_numpy(q), torch.from_numpy(x).to(torch.bfloat16),
            torch.from_numpy((x * x).sum(1)), torch.from_numpy(ids),
            torch.from_numpy(mask), x.astype(np.float64))


def _exact(x, q, metric):
    """[B, N] float64 distances of the integer rows (exact in f32 too)."""
    ip = q.astype(np.float64) @ x.T
    if metric == MetricType.EUCLIDEAN:
        return (q.astype(np.float64) ** 2).sum(1)[:, None] - 2 * ip + (
            x ** 2).sum(1)[None, :]
    return 1.0 - ip if metric == MetricType.COSINE else -ip


def _assert_same_topk(got, want, exact, mask):
    """id_topk's (d, ids) against flat_topk's: the same finite distances
    in the same order, bit for bit, and each returned id a kept row at its
    reported exact distance (ties may order differently); slots past the
    kept rows are +inf with id -1."""
    (gd, gi), (wd, wi) = got, want
    gd, gi, wd = gd.numpy(), gi.numpy(), wd.numpy()
    assert gd.shape == wd.shape and gi.dtype == np.int32
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    assert gd[fin].tobytes() == wd[fin].tobytes()
    assert (gi[~fin] == -1).all()
    for row in range(gd.shape[0]):
        ids = gi[row][fin[row]]
        assert len(set(ids.tolist())) == len(ids) and mask[ids].all()
        np.testing.assert_array_equal(exact[row, ids], gd[row][fin[row]])


@pytest.mark.parametrize("dim", [64, 768])
@pytest.mark.parametrize("share", list(SHARES))
@pytest.mark.parametrize("metric", METRICS)
def test_id_topk_equals_the_full_masked_scan(metric, share, dim):
    q, tab, norms, ids, mask, x = _scan_case(dim, SHARES[share])
    nrm = norms if metric == MetricType.EUCLIDEAN else None
    got = flat_ops.id_topk(q, tab, nrm, ids, metric, SCAN_K)
    want = flat_ops.flat_topk(q, tab, nrm, mask, metric, SCAN_K)
    _assert_same_topk(got, want, _exact(x, q.numpy(), metric), mask.numpy())
    # The plain version's scores are the full scan's columns, bit for bit.
    full = flat_ops.flat_distances(q, tab, nrm, metric)
    scores = id_scan.id_scan(q, tab, nrm, ids, int(metric))
    assert scores.shape == (SCAN_B, SHARES[share])
    assert scores.numpy().tobytes() == full[:, ids.long()].numpy().tobytes()


@pytest.mark.parametrize("metric", METRICS)
def test_id_topk_in_slices_equals_one_pass(monkeypatch, metric):
    """Past SINGLE_PASS_MAX_ELEMS the ids go in slices with a running
    top-k, which keeps the one pass's answer."""
    q, tab, norms, ids, mask, x = _scan_case(128, SHARES["10pct"], seed=3)
    nrm = norms if metric == MetricType.EUCLIDEAN else None
    one = flat_ops.id_topk(q, tab, nrm, ids, metric, SCAN_K)
    monkeypatch.setattr(flat_ops, "SINGLE_PASS_MAX_ELEMS", SCAN_B * 37)
    sliced = flat_ops.id_topk(q, tab, nrm, ids, metric, SCAN_K)
    _assert_same_topk(sliced, one, _exact(x, q.numpy(), metric),
                      mask.numpy())


def test_id_topk_of_no_rows_is_all_padding():
    q, tab, norms, _, _, _ = _scan_case(64, 1)
    d, i = flat_ops.id_topk(q, tab, norms, torch.zeros(0, dtype=torch.int32),
                            MetricType.EUCLIDEAN, SCAN_K)
    assert d.shape == i.shape == (SCAN_B, SCAN_K)
    assert torch.isinf(d).all() and (i == -1).all()


def test_kernel_args_are_checked():
    """check_kernel_args raises on what the kernel does not take; a CPU
    tensor is one of them (the wrapper runs the plain version there)."""
    q, tab, norms, ids, _, _ = _scan_case(64, 10)
    l2 = int(MetricType.EUCLIDEAN)
    bad = [
        ((q.double(), tab, norms, ids, l2), TypeError),
        ((q, tab.half(), norms, ids, l2), TypeError),
        ((q, tab, norms, ids.long(), l2), TypeError),
        ((q[:, :60].contiguous(), tab, norms, ids, l2), ValueError),
        ((q, tab[:, :60].contiguous(), norms, ids, l2), ValueError),
        ((q, tab, None, ids, l2), ValueError),
        ((q, tab, norms[:-1], ids, l2), ValueError),
        ((q, tab, norms, ids[None], l2), ValueError),
        ((q, tab, None, ids, int(MetricType.COSINE)), ValueError),
    ]
    for args, err in bad:
        with pytest.raises(err):
            id_scan.check_kernel_args(*args)


def test_id_scan_cost_counts_each_byte_once():
    # cohere-768-1m-filter99's shape: 10,023 kept rows of 768 bf16 columns.
    assert id_scan.id_scan_cost(1, 10023, 768) == (
        2 * 10023 * 768 + 4 * 768 + 4 * 10023 + 4 * 10023)
    assert id_scan.id_scan_cost(2, 5, 8, itemsize=4, l2=True) == (
        4 * 5 * 8 + 4 * 2 * 8 + 4 * 5 + 4 * 2 * 5 + 4 * 5)


# --- through vdb.query ----------------------------------------------------

N, DIM, K = 3000, 16, 10
COUNTERS = ("flat_id_scans_total", "flat_id_lists_built_total",
            "flat_scan_rows_total")


@pytest.fixture
def table(tmp_path):
    """A graph table (FlatServe off) with a uniform INT doc_id (a
    permutation) and a STRING tag, EUCLIDEAN."""
    saved = dict(vars(global_config))
    vdb.set_device("cpu")
    rng = np.random.default_rng(11)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    doc_id = rng.permutation(N).astype(np.int64)
    assert vdb.update_config({"AutoTuneSearch": False,
                              "FlatServe": "off"}) == 0
    assert vdb.load_db("ids", str(tmp_path / "ids"), vector_scale=2 * N) == 0
    vdb.use_db("ids")
    vdb.create_table("t", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "doc_id", "dataType": "INT"},
        {"name": "Tag", "dataType": "STRING"},
        {"name": "Emb", "dataType": "VECTOR_FLOAT", "dimensions": DIM,
         "metricType": "EUCLIDEAN"}])
    code, _ = vdb.insert_columns("t", {
        "ID": np.arange(N), "doc_id": doc_id,
        "Tag": [f"t{i % 100:02d}" for i in range(N)], "Emb": x})
    assert code == 0 and vdb.rebuild() == 0
    t = vdb._db.databases["ids"].tables["t"]
    assert t.graphs.get("Emb") is not None
    yield t, x, doc_id, rng
    vdb._reset_for_tests()
    vars(global_config).update(saved)


def _counters():
    c = metrics.snapshot()["counters"]
    return np.array([c.get(name, 0.0) for name in COUNTERS])


def _query(q, flt=""):
    code, rows = vdb.query("t", "Emb", q.tolist(), ["ID"], K, flt, True)
    assert code == 0
    return np.array([r["ID"] for r in rows], np.int64)


def _reference(x, q, keep):
    d = ((x.astype(np.float64) - q) ** 2).sum(1)
    d[~keep] = np.inf
    return np.lexsort((np.arange(len(d)), d))[:K]


def test_id_list_is_built_once_per_filter_and_version(table):
    t, x, doc_id, rng = table
    flt = f"doc_id >= {N - N // 100}"  # keeps 30 rows: the flat route
    keep = doc_id >= N - N // 100
    queries = rng.normal(size=(5, DIM)).astype(np.float32)
    before = _counters()
    for q in queries:
        np.testing.assert_array_equal(_query(q, flt), _reference(x, q, keep))
    moved = _counters() - before
    assert moved.tolist() == [5, 1, 5 * keep.sum()]

    # An insert: the next query builds a new list, which holds the new row.
    q = queries[0]
    before = _counters()
    assert vdb.insert("t", [{"ID": N, "doc_id": N, "Tag": "new",
                             "Emb": q.tolist()}]) == 0
    x = np.concatenate([x, q[None]])
    keep = np.append(keep, True)
    got = _query(q, flt)
    assert got[0] == N
    np.testing.assert_array_equal(got, _reference(x, q, keep))
    _query(queries[1], flt)
    moved = _counters() - before
    assert moved.tolist() == [2, 1, 2 * keep.sum()]

    # A delete: again a new list, without the deleted row.
    before = _counters()
    assert vdb.delete_by_pk("t", [N]) == 0
    keep[N] = False
    got = _query(q, flt)
    assert N not in got
    np.testing.assert_array_equal(got, _reference(x, q, keep))
    moved = _counters() - before
    assert moved.tolist() == [1, 1, keep.sum()]


def test_unfiltered_and_host_folded_scans_read_the_whole_store(table):
    """No filter on a graph-less table's flat scan, and a host-folded
    filter past the selectivity cutover: the full-table scan, which reads
    the store's capacity, and no id scan."""
    t, x, doc_id, rng = table
    q = rng.normal(size=DIM).astype(np.float32)
    capacity = t.segment.device_view("Emb").capacity
    keep = np.array([i % 100 == 7 for i in range(N)])
    before = _counters()
    got = _query(q, "Tag = 't07'")  # a host fold keeping 1%
    np.testing.assert_array_equal(got, _reference(x, q, keep))
    assert (_counters() - before).tolist() == [0, 0, capacity]
    t.graphs.pop("Emb")  # no graph: every query takes the flat scan
    before = _counters()
    np.testing.assert_array_equal(_query(q), _reference(x, q,
                                                       np.ones(N, bool)))
    assert (_counters() - before).tolist() == [0, 0, capacity]


def test_graphless_table_under_a_device_filter_takes_the_id_scan(table):
    """The id scan depends only on what the flat launch sees: a device
    filter with a cacheable mask. A table with no graph (no selectivity
    gate) takes it too, with the same answers."""
    t, x, doc_id, rng = table
    t.graphs.pop("Emb")
    flt = "doc_id < 600"  # keeps 20%: past the cutover, no gate here
    keep = doc_id < 600
    before = _counters()
    for q in rng.normal(size=(3, DIM)).astype(np.float32):
        np.testing.assert_array_equal(_query(q, flt), _reference(x, q, keep))
    assert (_counters() - before).tolist() == [3, 1, 3 * keep.sum()]
