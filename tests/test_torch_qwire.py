"""The reduced-precision query wires of vectordb_tpu_torch (ops/qwire,
QueryDtype, the tuner's wire validation) against vectordb_tpu's, on the same
numpy inputs; the JAX side runs as tests/test_int8_wire.py runs it.

Held:
  - the codec, bit for bit: the port's host round trips equal JAX's
    roundtrip_int8 and the bf16 cast, and its device round trip (on a CPU
    tensor here) equals JAX's decode_int8_queries(encode_int8_queries(q));
  - candidates follow the wire: both packages open one table and one graph
    (the port opens a copy of the JAX package's directory), and under a
    forced int8 or bf16 wire the candidate pools the grouped programs hand
    to the re-rank (DeviceRerank off: table_f32 None, the k_cand ids before
    the re-rank) are equal as sets, on the flat-serve, graph and sharded
    paths;
  - the named divergence: the port re-ranks against the f32 query, so its
    grouped `@distance` is within rtol 1e-5 of a float64 recomputation from
    the f32 query under every wire, its ids are the exact top-k of the pool
    and recall@10 is at least the JAX package's; the JAX package re-ranks
    against the wire's values and misses that tolerance;
  - the tuner picks the same wire and rung, and the tuning sidecar's
    `qdtype` crosses packages both ways.
"""
import json
import shutil

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vectordb_tpu as jvdb
import vectordb_tpu_torch as tvdb
from vectordb_tpu.config import global_config as jax_config
from vectordb_tpu.ops import qwire as jq
from vectordb_tpu.parallel import engine as jengine
from vectordb_tpu.schema import MetricType
from vectordb_tpu_torch.config import global_config as torch_config
from vectordb_tpu_torch.db_server import DBServer
from vectordb_tpu_torch.ops import beam as tbeam
from vectordb_tpu_torch.ops import flat as tflat
from vectordb_tpu_torch.ops import qwire as tq
from vectordb_tpu_torch.parallel import engine as tengine
from vectordb_tpu_torch.rest.server import RestServer

L2 = MetricType.EUCLIDEAN


@pytest.fixture(autouse=True)
def _reset_port():
    saved_t, saved_j = dict(vars(torch_config)), dict(vars(jax_config))
    tvdb.set_device("cpu")  # the CPU run of the port: plain versions
    for cfg in (torch_config, jax_config):
        cfg.query_group_size = 4
        cfg.device_rerank = "auto"
    yield
    tvdb._reset_for_tests()
    jengine._reset_for_tests()
    vars(torch_config).update(saved_t)
    vars(jax_config).update(saved_j)


# ---------------------------------------------------------------------------
# The codec, bit for bit.
# ---------------------------------------------------------------------------


def _bf16_tie_scales(r: int) -> np.ndarray:
    """[r, 128] rows whose every block max m makes m / 127 an f32 value
    exactly half way between two bf16 values (low 16 bits 0x8000)."""
    rng = np.random.default_rng(7)
    hi = (0x3C00 + rng.integers(0, 0x300, size=(r, 16))).astype(np.uint32)
    s = ((hi << 16) | 0x8000).view(np.float32)
    amax = s * np.float32(127.0)  # 9 + 7 significant bits: exact in f32
    q = rng.uniform(-1.0, 1.0, size=(r, 16, 8)).astype(np.float32)
    q *= amax[:, :, None]
    q[:, :, 0] = np.where(rng.random((r, 16)) < 0.5, amax, -amax)
    return q.reshape(r, 128)


def _codec_case(name: str) -> np.ndarray:
    rng = np.random.default_rng(1)
    if name in ("16x64", "128x128", "100x256"):
        r, d = map(int, name.split("x"))
        return (rng.normal(size=(r, d)) * rng.uniform(0.1, 5)).astype(
            np.float32)
    if name in ("zero_row", "hot_block"):
        q = rng.normal(size=(64, 128)).astype(np.float32) * 3.0
        q[5] = 0.0  # an all-zero row must not divide by zero
        q[7, :jq.QBLOCK] = 100.0  # a hot block keeps to itself
        return q
    if name == "bf16_tie_scales":
        return _bf16_tie_scales(32)
    assert name == "dim100"
    return rng.normal(size=(8, 100)).astype(np.float32)


CODEC_CASES = ["16x64", "128x128", "100x256", "zero_row", "hot_block",
               "bf16_tie_scales", "dim100"]


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(
        np.uint32)


def _jax_device_roundtrip(q: np.ndarray) -> np.ndarray:
    """JAX's grouped-path decode of the packed buffer of q, lane-padded to
    a multiple of 128 as the device path pads it."""
    r, d = q.shape
    dp = -(-d // 128) * 128
    qp = np.zeros((r, dp), np.float32)
    qp[:, :d] = q
    buf = jq.encode_int8_queries(qp)
    return np.asarray(jq.decode_int8_queries(jnp.asarray(buf), r, dp))[:, :d]


@pytest.mark.parametrize("case", CODEC_CASES)
def test_int8_codec_bitwise_equals_jax(case):
    q = _codec_case(case)
    if case == "bf16_tie_scales":
        raw = (np.abs(q).reshape(-1, 8).max(1) / np.float32(127.0)).astype(
            np.float32)
        assert (_bits(raw) & 0xFFFF == 0x8000).all()
    want = jq.roundtrip_int8(q)
    np.testing.assert_array_equal(_bits(tq.roundtrip_int8(q)), _bits(want))
    np.testing.assert_array_equal(_bits(_jax_device_roundtrip(q)),
                                  _bits(want))
    dev = tq.apply_wire(torch.from_numpy(q), "int8")
    assert dev.dtype == torch.float32 and dev.shape == q.shape
    np.testing.assert_array_equal(_bits(dev.numpy()), _bits(want))
    if q.shape[1] % jq.QBLOCK == 0:
        for got, ref in zip(tq.quantize_block_int8(q),
                            jq.quantize_block_int8(q)):
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
    if case == "zero_row":
        np.testing.assert_array_equal(_bits(dev.numpy()[5]), 0)


@pytest.mark.parametrize("case", CODEC_CASES + ["bf16_ties"])
def test_bf16_wire_bitwise_equals_the_cast(case):
    if case == "bf16_ties":
        # Every f32 whose low 16 bits sit on or next to a tie, both signs.
        hi = np.arange(0x0000, 0x7F80, 7, dtype=np.uint32) << 16
        lo = np.array([0x7FFF, 0x8000, 0x8001], np.uint32)
        pos = (hi[:, None] | lo[None, :]).reshape(-1, 1).view(np.float32)
        q = np.concatenate([pos, -pos], axis=1)
    else:
        q = _codec_case(case)
    want = q.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(_bits(tq.roundtrip_bf16(q)), _bits(want))
    np.testing.assert_array_equal(
        _bits(tq.apply_wire(torch.from_numpy(q), "bf16").numpy()),
        _bits(want))
    np.testing.assert_array_equal(
        _bits(tq.apply_wire(torch.from_numpy(q), "f32").numpy()), _bits(q))


# ---------------------------------------------------------------------------
# One table and one graph in both packages.
# ---------------------------------------------------------------------------


def _pair(tmp_path, n, seed, dim=32, shards=0):
    """The test_int8_wire `_mk` table (normal rows, EUCLIDEAN) in both
    packages with the JAX package's graph: JAX builds it, then the port
    opens a copy of JAX's directory. Returns (x, JAX table, port table)."""
    x = np.random.default_rng(seed).normal(size=(n, dim)).astype(np.float32)
    jpath, tpath = tmp_path / "j", tmp_path / "t"
    for pkg in (jvdb, tvdb):
        assert pkg.update_config({"ShardCount": shards}) == 0
    assert jvdb.load_db("i8db", str(jpath)) == 0
    jvdb.use_db("i8db")
    jvdb.create_table("t", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "V", "dataType": "VECTOR_FLOAT", "dimensions": dim,
         "metricType": "EUCLIDEAN"}])
    jvdb.insert_columns("t", {"ID": np.arange(n), "V": x}, n)
    assert jvdb.rebuild() == 0
    assert jvdb.unload_db("i8db") == 0
    shutil.copytree(jpath, tpath)
    out = [x]
    for pkg, path in ((jvdb, jpath), (tvdb, tpath)):
        assert pkg.load_db("i8db", str(path)) == 0
        pkg.use_db("i8db")
        t = pkg._db.databases["i8db"].tables["t"]
        graph = t.sharded_fields["V"].graph if shards else t.graphs["V"]
        assert graph is not None and graph.num_rows == n
        out.append(t)
    return tuple(out)


def _queries(x, nq, seed):
    rng = np.random.default_rng(seed)
    return x[rng.integers(0, len(x), nq)] + 0.01 * rng.normal(
        size=(nq, x.shape[1])).astype(np.float32)


def _grouped(table, queries, pools=None):
    """grouped_dense_search of `queries` (k 10, batch 128). With `pools`
    (a list), DeviceRerank is off, so no f32 view is on the device and the
    program's k_cand candidates (table_f32 None) go to the host re-rank,
    which appends them to `pools`."""
    if pools is None:
        return table.grouped_dense_search("V", queries,
                                          table.segment.valid_mask(), L2,
                                          10, batch=128, mask_cacheable=True)
    orig = table._rerank_candidates
    table._rerank_candidates = (lambda f, q, ids, *a: pools.append(
        ids.copy()) or orig(f, q, ids, *a))
    table.config.device_rerank = "off"
    try:
        return _grouped(table, queries)
    finally:
        table.config.device_rerank = "auto"
        del table._rerank_candidates


def _pool(table, queries):
    pools = []
    _grouped(table, queries, pools)
    assert len(pools) == 1
    return pools[0]


def _d64(x, q, ids):
    return ((x[ids].astype(np.float64) - q[:, None, :]) ** 2).sum(2)


def _recall(x, queries, ids):
    d = ((queries.astype(np.float64) ** 2).sum(1)[:, None]
         - 2 * queries.astype(np.float64) @ x.T.astype(np.float64)
         + (x.astype(np.float64) ** 2).sum(1)[None])
    want = np.argsort(d, axis=1, kind="stable")[:, :10]
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                    for a, b in zip(ids, want)])


@pytest.mark.parametrize("flat_serve", ["on", "off"])
@pytest.mark.parametrize("wire", ["int8", "bf16"])
def test_candidates_follow_the_wire_distances_stay_exact(
        tmp_path, monkeypatch, flat_serve, wire):
    x, jt, tt = _pair(tmp_path, 3000, seed=2)
    queries = _queries(x, 300, seed=3)
    for pkg in (jvdb, tvdb):
        assert pkg.update_config({"FlatServe": flat_serve,
                                  "QueryDtype": wire}) == 0
    mod, name = ((tflat, "flat_serve_grouped") if flat_serve == "on"
                 else (tbeam, "beam_search_grouped"))
    calls = []
    orig = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: calls.append(k["wire"])
                        or orig(*a, **k))
    jpool, tpool = _pool(jt, queries), _pool(tt, queries)
    assert calls == [wire]
    assert tpool.shape == jpool.shape == (300, 42 if flat_serve == "on"
                                          else 18)
    for a, b in zip(tpool, jpool):
        assert set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
    if wire == "int8":
        # Under the f32 wire the pools differ: the wire moved them. (bf16
        # queries score a bf16 table as f32 ones do, up to rounding.)
        torch_config.query_dtype = "f32"
        f32_pool = _pool(tt, queries)
        torch_config.query_dtype = wire
        assert any(set(a.tolist()) != set(b.tolist())
                   for a, b in zip(f32_pool, tpool))

    (jid, jd), (tid, td) = (_grouped(t, queries) for t in (jt, tt))
    assert tid.shape == jid.shape == (300, 10)
    # The port: exact distances from the f32 query, the exact top-10 of
    # its pool, recall no lower than the JAX package's.
    np.testing.assert_allclose(td, _d64(x, queries, tid), rtol=1e-5)
    pool_d = np.where(tpool >= 0, _d64(x, queries, np.maximum(tpool, 0)),
                      np.inf)
    best = np.take_along_axis(tpool, np.argsort(pool_d, axis=1,
                                                kind="stable"), 1)[:, :10]
    for a, b in zip(tid, best):
        assert set(a.tolist()) == set(b.tolist())
    r_t, r_j = _recall(x, queries, tid), _recall(x, queries, jid)
    assert r_t >= r_j and r_t >= 0.99, (r_t, r_j)
    # The JAX package re-ranks against the wire's values: its distances
    # miss the f32 recomputation by more than rtol 1e-5.
    rel = np.abs(jd - _d64(x, queries, jid)) / _d64(x, queries, jid)
    assert rel.max() > 1e-5


@pytest.mark.parametrize("wire", ["int8", "bf16"])
def test_sharded_grouped_wire_matches_jax(tmp_path, monkeypatch, wire):
    """ShardCount 2 (JAX on two of the virtual CPU devices, the port on two
    shards on `cpu`): under int8 the pools of launch_grouped are equal as
    sets; a bf16 override uploads f32 on the sharded path in both packages,
    so its pools are the f32 pools."""
    x, jt, tt = _pair(tmp_path, 2500, seed=5, shards=2)
    assert tt.mesh.size == 2 and jt.mesh.size == 2
    queries = _queries(x, 300, seed=6)
    wires = []
    orig = tengine.ShardedDenseField.launch_grouped
    monkeypatch.setattr(tengine.ShardedDenseField, "launch_grouped",
                        lambda self, *a, **k: wires.append(k["wire"])
                        or orig(self, *a, **k))
    pools = {}
    for qd in (wire, "f32"):
        for pkg in (jvdb, tvdb):
            assert pkg.update_config({"QueryDtype": qd}) == 0
        for name, t in (("jax", jt), ("port", tt)):
            p = []
            ids, d = _grouped(t, queries, p)
            pools[name, qd] = p[0]
            if name == "port":
                np.testing.assert_allclose(d, _d64(x, queries, ids),
                                           rtol=1e-5)
                assert _recall(x, queries, ids) >= 0.99
    assert wires == ([wire, "f32"] if wire == "int8" else ["f32", "f32"])
    for qd in (wire, "f32"):
        for a, b in zip(pools["port", qd], pools["jax", qd]):
            assert set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
    same = [set(a.tolist()) == set(b.tolist())
            for a, b in zip(pools["port", wire], pools["port", "f32"])]
    assert all(same) == (wire == "bf16")


# ---------------------------------------------------------------------------
# The tuner and its sidecar.
# ---------------------------------------------------------------------------


def test_tuner_picks_the_jax_wire_and_sidecars_cross(tmp_path):
    """test_int8_wire.py's tuning case (n 2,500, seed 4, target 0.9,
    sample 32, k 5) on one graph: the same wire and rung in both packages;
    then each package loads the other's directory and serves its wire."""
    _, jt, tt = _pair(tmp_path, 2500, seed=4)
    reps = []
    for t in (jt, tt):
        t.is_leader = True
        reps.append(t.tune_search_ef(target_recall=0.9, sample=32, k=5)["V"])
    jrep, trep = reps
    assert trep["qdtype"] == jrep["qdtype"] == "int8"
    assert (trep["ef"], trep["iters"]) == (jrep["ef"], jrep["iters"])
    assert trep["recall"] == trep["qdtype_wire_recall"] >= 0.9
    assert trep["qdtype_wire_recall"] == jrep["qdtype_wire_recall"]
    assert trep["tried"][-1]["qdtype"] == "int8"
    assert [r.get("qdtype") for r in trep["tried"]] == [
        r.get("qdtype") for r in jrep["tried"]]
    assert tt.search_qdtype_override == {"V": "int8"}
    assert tt._query_wire("V") == "int8"  # QueryDtype defaults to auto
    for pkg in (jvdb, tvdb):
        assert pkg.unload_db("i8db") == 0
    # Each package opens the other's directory, sidecar included.
    for pkg, sub in ((jvdb, "t"), (tvdb, "j")):
        assert pkg.load_db("i8db", str(tmp_path / sub)) == 0
        t = pkg._db.databases["i8db"].tables["t"]
        assert t.search_qdtype_override == {"V": "int8"}
        assert t._query_wire("V") == "int8"
        assert t.search_ef_override["V"] == trep["ef"]
        # An f32 entry clears the override (a leader that moved back).
        with open(t._tuned_ef_path()) as f:
            side = json.load(f)
        assert side["V"]["qdtype"] == "int8"
        side["V"]["qdtype"] = "f32"
        with open(t._tuned_ef_path(), "w") as f:
            json.dump(side, f)
        t._load_tuned_ef()
        assert t.search_qdtype_override == {}
        assert t._query_wire("V") == "f32"


def test_explicit_f32_ignores_override(tmp_path):
    """test_int8_wire.py's three cases on the port."""
    assert tvdb.load_db("db", str(tmp_path / "db")) == 0
    tvdb.use_db("db")
    tvdb.create_table("t", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "V", "dataType": "VECTOR_FLOAT", "dimensions": 8,
         "metricType": "EUCLIDEAN"}])
    table = tvdb._db.databases["db"].tables["t"]
    table.search_qdtype_override["V"] = "int8"
    torch_config.query_dtype = "f32"
    assert table._query_wire("V") == "f32"
    torch_config.query_dtype = "bf16"
    assert table._query_wire("V") == "bf16"
    torch_config.query_dtype = "auto"
    assert table._query_wire("V") == "int8"


def test_rest_config_sets_the_wire(tmp_path):
    """POST /api/config {"QueryDtype": ...} is accepted and the grouped
    path then runs that wire."""
    rest = RestServer(DBServer())
    try:
        code, _ = rest.dispatch("POST", "/api/load",
                                {"name": "db", "path": str(tmp_path / "db")},
                                {})
        assert code == 200
        x = np.random.default_rng(9).normal(size=(600, 16)).astype(
            np.float32)
        db = rest.db.databases["db"]
        code, _ = rest.dispatch("POST", "/api/db/schema/tables", {
            "name": "t", "fields": [
                {"name": "ID", "dataType": "INT", "primaryKey": True},
                {"name": "V", "dataType": "VECTOR_FLOAT", "dimensions": 16,
                 "metricType": "EUCLIDEAN"}]}, {})
        assert code == 200
        table = db.tables["t"]
        assert table.insert_columns({"ID": np.arange(600), "V": x},
                                    600).ok()
        for wire in ("bf16", "int8", "f32"):
            code, _ = rest.dispatch("POST", "/api/config",
                                    {"QueryDtype": wire}, {})
            assert code == 200 and torch_config.query_dtype == wire
            assert table._query_wire("V") == wire
            ids, d = table.grouped_dense_search(
                "V", x[:300], table.segment.valid_mask(), L2, 5, batch=128,
                mask_cacheable=True)
            assert (ids[:, 0] == np.arange(300)).all()
            np.testing.assert_allclose(d, _d64(x, x[:300], ids), rtol=1e-5,
                                       atol=1e-6)
    finally:
        rest.db.stop()
