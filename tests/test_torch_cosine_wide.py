"""A COSINE table of 1,536-wide rows (the width of text-embedding-ada-002)
through vdb.query on the graph path, as a 1M-row table of that width walks
it: flat-serve off and fused traversal off, so the walk reads the table's
bf16 rows (the split path).

Held to two others on the same rows:
  - the benchmark's plain reference (perfbench/reference/dense_cosine.py:
    unit rows and queries multiplied in float64): every reported distance
    within 1e-5 of its 1 - cos (absolute: |cos| <= 1; the port's float32
    re-rank of float32 unit rows reads about 1e-6 here, TF32 operands about
    4e-5), and recall@10 at least 0.95;
  - the JAX package: top-10 id sets equal on at least 95% of the queries
    (each package builds its own graph), distances of the ids both return
    within 1e-5, and the port's recall at most 0.01 below JAX's.
The ingest of such a batch is held to its one-pass arithmetic bit for bit
(the port scales the rows in place, block by block, and uploads the store
block by block), and encodes no WAL payload for a log that is off.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import vectordb_tpu as jvdb
import vectordb_tpu_torch as tvdb
from vectordb_tpu.config import global_config as jax_config
from vectordb_tpu_torch import colcodec, segment
from vectordb_tpu_torch.config import global_config as torch_config
from vectordb_tpu_torch.metrics import metrics

N, DIM, NQ, K = 2000, 1536, 48, 10
CFG = {"FlatServe": "off", "FusedTraversal": "off", "AutoTuneSearch": False}
DIST_TOL = 1e-5
WALKS = ("beam_walks_split_total", "beam_walks_fused_total")


def _reference_module():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "perfbench", "reference",
        "dense_cosine.py")
    spec = importlib.util.spec_from_file_location("dense_cosine_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _reset_port():
    saved_t, saved_j = dict(vars(torch_config)), dict(vars(jax_config))
    tvdb.set_device("cpu")
    yield
    tvdb._reset_for_tests()
    vars(torch_config).update(saved_t)
    vars(jax_config).update(saved_j)


def _data(seed=41):
    """Clustered rows and held-out queries, not unit length: the program
    scales both."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(20, DIM)) * 0.2 + 0.05
    x = (centers[rng.integers(0, 20, N)]
         + 0.1 * rng.normal(size=(N, DIM))).astype(np.float32)
    q = (centers[rng.integers(0, 20, NQ)]
         + 0.1 * rng.normal(size=(NQ, DIM))).astype(np.float32)
    return x, q


def _query_all(pkg, tmp_path, name, x, q):
    assert pkg.load_db("db", str(tmp_path / name), vector_scale=2 * N) == 0
    pkg.use_db("db")
    pkg.create_table("t", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "Emb", "dataType": "VECTOR_FLOAT", "dimensions": DIM,
         "metricType": "COSINE"}])
    pkg.insert_columns("t", {"ID": np.arange(N), "Emb": x})
    assert pkg.update_config(CFG) == 0
    assert pkg.rebuild() == 0
    ids = np.full((NQ, K), -1, np.int64)
    d = np.full((NQ, K), np.nan)
    c0 = metrics.snapshot()["counters"]
    for i, v in enumerate(q):
        code, rows = pkg.query("t", "Emb", v.tolist(), ["ID"], K, "", True)
        assert code == 0 and len(rows) == K
        ids[i] = [r["ID"] for r in rows]
        d[i] = [r["@distance"] for r in rows]
    c1 = metrics.snapshot()["counters"]
    return ids, d, {k: c1.get(k, 0) - c0.get(k, 0) for k in WALKS}


def _recall(ids, want):
    return float(np.mean([len(set(a) & set(b)) / K
                          for a, b in zip(ids, want)]))


def test_wide_cosine_split_walk_matches_reference_and_jax(tmp_path):
    x, q = _data()
    tid, td, walked = _query_all(tvdb, tmp_path, "t", x, q)
    assert walked == {"beam_walks_split_total": NQ,
                      "beam_walks_fused_total": 0}

    ref = _reference_module().Reference({"x": x}, q, torch.device("cpu"))
    d, scale = ref.distances(np.arange(NQ))
    d = d.numpy()
    assert scale.shape == d.shape and bool((scale == 1).all())
    want = np.argsort(d, axis=0, kind="stable")[:K].T
    exact = np.take_along_axis(d.T, tid, axis=1)
    assert float(np.abs(td - exact).max()) <= DIST_TOL
    recall = _recall(tid, want)
    assert recall >= 0.95, recall

    jid, jd, _ = _query_all(jvdb, tmp_path, "j", x, q)
    agree = np.mean([set(a) == set(b) for a, b in zip(tid, jid)])
    assert agree >= 0.95, agree
    for a_i, a_d, b_i, b_d in zip(tid, td, jid, jd):
        both = np.intersect1d(a_i, b_i)
        sa, sb = np.isin(a_i, both), np.isin(b_i, both)
        np.testing.assert_allclose(a_d[sa][np.argsort(a_i[sa])],
                                   b_d[sb][np.argsort(b_i[sb])],
                                   rtol=0, atol=DIST_TOL)
    assert recall >= _recall(jid, want) - 0.01


def test_reference_control_is_tf32():
    """The control rounds the unit rows to TF32 and multiplies in float32:
    its distances leave the float64 ones by more than the limit the port
    is held to."""
    x, q = _data(seed=43)
    mod = _reference_module()
    exact, _ = mod.Reference({"x": x}, q, torch.device("cpu")).distances(
        np.arange(NQ))
    low, _ = mod.Reference({"x": x}, q, torch.device("cpu"),
                           precision="tf32").distances(np.arange(NQ))
    assert low.dtype == torch.float32 and exact.dtype == torch.float64
    err = float((low.double() - exact).abs().max())
    assert err > 4 * DIST_TOL, err
    t = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -12, -3.0])
    assert mod.tf32_round(t).tolist() == [1.0 + 2 ** -10, 1.0, -3.0]


@pytest.mark.parametrize("wal", [False, True])
def test_ingest_in_blocks_equals_one_pass(tmp_path, monkeypatch, wal):
    """Ingest of a wide COSINE batch: each row scaled to unit length in
    place, block by block (rows of norm 1e-5 or less as they are), equal
    bit for bit to the one-pass formula, norms and the bf16 device store
    too; the WAL payload is encoded only when the log writes it."""
    monkeypatch.setattr(segment, "BLOCK_ROWS", 7)
    encoded = []
    real = colcodec.encode_columns
    monkeypatch.setattr(colcodec, "encode_columns",
                        lambda *a, **k: encoded.append(1) or real(*a, **k))
    rng = np.random.default_rng(44)
    x = rng.normal(size=(40, DIM)).astype(np.float32)
    x[3] = 0.0
    x[11] = 1e-7
    assert tvdb.load_db("db", str(tmp_path / "w"), wal_enabled=wal) == 0
    tvdb.use_db("db")
    tvdb.create_table("t", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "Emb", "dataType": "VECTOR_FLOAT", "dimensions": DIM,
         "metricType": "COSINE"}])
    tvdb.insert_columns("t", {"ID": np.arange(40), "Emb": x})
    assert len(encoded) == int(wal)
    seg = tvdb._db.databases["db"].tables["t"].segment
    nrm = np.linalg.norm(x, axis=1, keepdims=True)
    want = np.where(nrm > 1e-5, x / np.maximum(nrm, 1e-30), x)
    assert seg.dense_host["Emb"][:40].tobytes() == want.tobytes()
    assert seg.dense_norms["Emb"][:40].tobytes() == np.einsum(
        "nd,nd->n", want, want).astype(np.float32).tobytes()
    store = seg.device_view("Emb")
    assert torch.equal(store.buf[:40],
                       torch.from_numpy(want).to(torch.bfloat16))
    assert not bool(store.buf[40:].any())
