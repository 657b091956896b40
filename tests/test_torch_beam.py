"""Beam traversal of vectordb_tpu_torch against vectordb_tpu's on the same
graph: one exact KNN adjacency and one representative set, made with
numpy from a seed, go to both packages' beam_search_grouped (split gather
path with compaction, fused int8 path, the fixed-depth and the deep loop).

Tolerance: after the exact f32 re-rank the top-10 id sets must agree on at
least 99% of queries (traversal scores bf16/int8 rows in f32 in another
summation order, so a near-tie may send a walk elsewhere), distances of the
ids both return within rtol 1e-5, and the port's recall@10 against the
numpy oracle no lower than the JAX package's minus 0.005.

Also the port's ReplayCache (a table's graph queries replayed from a
captured CUDA graph): eager on the CPU, its key, and its bookkeeping with a
stand-in capture; the replays themselves are tested on the card
(tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vectordb_tpu.ops import beam as jbeam
from vectordb_tpu.schema import MetricType
from vectordb_tpu_torch.ops import beam as tbeam

N, N_PAD, DIM, DP, R = 4000, 4096, 32, 128, 48
G, B = 2, 128


def _graph(metric, seed=0):
    """Clustered rows (bf16-exact), a 32-NN adjacency padded to R columns,
    256 random representatives, near-duplicate queries, 5% deleted rows."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(24, DIM)) * 3
    x = centers[rng.integers(0, 24, N)] + rng.normal(size=(N, DIM))
    q = x[rng.integers(0, N, G * B)] + 0.1 * rng.normal(size=(G * B, DIM))
    if metric == MetricType.COSINE:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    x = torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()
    q = q.astype(np.float32)
    d = _dist(x, x, metric)
    np.fill_diagonal(d, np.inf)
    adj = np.full((N_PAD, R), -1, np.int32)
    adj[:N, :32] = np.argsort(d, axis=1)[:, :32]
    tab = np.zeros((N_PAD, DP), np.float32)
    tab[:N, :DIM] = x
    qp = np.zeros((G * B, DP), np.float32)
    qp[:, :DIM] = q
    valid = np.zeros(N_PAD, bool)
    valid[:N] = rng.random(N) > 0.05
    reps = rng.choice(N, 256, replace=False).astype(np.int32)
    scale = float(np.abs(x).max()) / 127.0
    x_q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    fused = np.zeros((N_PAD, R, DP), np.int8)
    fused[:N, :, :DIM] = x_q[np.clip(adj[:N], 0, N - 1)]
    return dict(x=x, q=q, tab=tab, qp=qp, adj=adj, valid=valid, reps=reps,
                fused=fused.reshape(N_PAD, R * DP), scale=np.float32(scale))


def _dist(x, q, metric):
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    ip = q64 @ x64.T
    if metric == MetricType.EUCLIDEAN:
        return (q64 ** 2).sum(1)[:, None] - 2 * ip + (x64 ** 2).sum(1)[None]
    return (1.0 - ip) if metric == MetricType.COSINE else -ip


def _run_both(g, metric, max_iters, path):
    norms = (g["tab"].astype(np.float64) ** 2).sum(1).astype(np.float32)
    fused = g["fused"] if path == "fused" else None
    args = dict(metric=int(metric), beam_width=32, expand=4,
                max_iters=max_iters, num_seeds=32, term_width=12, k_cand=18,
                k_out=10, compact=0 if fused is not None else 96)
    jd, ji = jbeam.beam_search_grouped(
        jnp.asarray(g["qp"].reshape(G, B, DP)),
        jnp.asarray(g["tab"], jnp.bfloat16), jnp.asarray(norms),
        jnp.asarray(g["adj"]), jnp.asarray(g["reps"]),
        jnp.asarray(g["valid"]), jnp.asarray(g["tab"]),
        fused=None if fused is None else jnp.asarray(fused),
        scale=None if fused is None else g["scale"], **args)
    td, ti = tbeam.beam_search_grouped(
        torch.from_numpy(g["qp"].reshape(G, B, DP)),
        torch.from_numpy(g["tab"]).bfloat16(), torch.from_numpy(norms),
        torch.from_numpy(g["adj"]), torch.from_numpy(g["reps"]),
        torch.from_numpy(g["valid"]), torch.from_numpy(g["tab"]),
        fused=None if fused is None else torch.from_numpy(fused),
        scale=None if fused is None else float(g["scale"]), **args)
    return (np.asarray(jd).reshape(G * B, -1), np.asarray(ji).reshape(G * B, -1),
            td.numpy().reshape(G * B, -1), ti.numpy().reshape(G * B, -1))


@pytest.mark.parametrize("metric,path,max_iters", [
    (MetricType.EUCLIDEAN, "split", 8),
    (MetricType.EUCLIDEAN, "fused", 8),
    (MetricType.EUCLIDEAN, "split", 20),
    (MetricType.COSINE, "split", 8),
    (MetricType.DOT_PRODUCT, "fused", 6)])
def test_grouped_traversal_matches_jax(metric, path, max_iters):
    g = _graph(metric, seed=int(metric))
    jd, ji, td, ti = _run_both(g, metric, max_iters, path)
    assert ti.shape == ji.shape == (G * B, 10)
    assert g["valid"][ti[ti >= 0]].all()
    agree = np.mean([set(a) == set(b) for a, b in zip(ti, ji)])
    assert agree >= 0.99, agree
    for a_i, a_d, b_i, b_d in zip(ti, td, ji, jd):
        common = np.intersect1d(a_i[a_i >= 0], b_i)
        np.testing.assert_allclose(
            a_d[np.isin(a_i, common)][np.argsort(a_i[np.isin(a_i, common)])],
            b_d[np.isin(b_i, common)][np.argsort(b_i[np.isin(b_i, common)])],
            rtol=1e-5, atol=1e-5)
    d = _dist(g["x"], g["q"], metric)
    d[:, ~g["valid"][:N]] = np.inf
    gt = np.argsort(d, axis=1)[:, :10]

    def recall(ids):
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, gt)])

    assert recall(ti) >= recall(ji) - 0.005
    assert recall(ti) >= 0.9


def test_fixed_depth_loop_equals_host_checked_loop(monkeypatch):
    """The masked fixed-depth loop (max_iters <= UNROLL_MAX_ITERS) and the
    loop that tests convergence on the host give identical beams."""
    g = _graph(MetricType.EUCLIDEAN, seed=3)
    norms = torch.from_numpy((g["tab"] ** 2).sum(1).astype(np.float32))
    args = (torch.from_numpy(g["qp"][:B]), torch.from_numpy(g["tab"]).bfloat16(),
            norms, torch.from_numpy(g["adj"]), torch.from_numpy(g["reps"]),
            int(MetricType.EUCLIDEAN), 24, 4, 12)
    fixed = tbeam.beam_search_kernel(*args, term_width=12, compact=96)
    monkeypatch.setattr(tbeam, "UNROLL_MAX_ITERS", 0)
    host = tbeam.beam_search_kernel(*args, term_width=12, compact=96)
    for a, b in zip(fixed, host):
        assert torch.equal(a, b)
    assert bool((fixed[1] >= 0).all())
    assert bool((fixed[0][:, 1:] >= fixed[0][:, :-1]).all())  # sorted beam


def test_topk_selects_first_valid_entries_of_the_beam():
    """beam_search_topk keeps the first k_out valid entries of the sorted
    beam (the lower position wins a tie, as lax.top_k), -1/inf padded."""
    g = _graph(MetricType.EUCLIDEAN, seed=4)
    norms = torch.from_numpy((g["tab"] ** 2).sum(1).astype(np.float32))
    valid = torch.from_numpy(g["valid"])
    valid[:N // 2] = False
    kw = dict(metric=int(MetricType.EUCLIDEAN), beam_width=16, expand=4,
              max_iters=4, num_seeds=16, term_width=8)
    args = (torch.from_numpy(g["qp"][:B]), torch.from_numpy(g["tab"]).bfloat16(),
            norms, torch.from_numpy(g["adj"]), torch.from_numpy(g["reps"]))
    beam_d, beam_ids, _ = tbeam.beam_search_kernel(*args, **kw)
    d, ids = tbeam.beam_search_topk(*args, valid, k_out=12, **kw)
    ok = (beam_ids >= 0) & valid[beam_ids.clamp(min=0).long()]
    for i in range(B):
        want = beam_ids[i][ok[i]][:12]
        assert torch.equal(ids[i][:len(want)], want)
        assert bool((ids[i][len(want):] == -1).all())
        assert bool(torch.isinf(d[i][len(want):]).all())


def test_first_m_pick_rule():
    avail = torch.tensor([[False, True, True, False, True],
                          [False, False, False, False, True]])
    np.testing.assert_array_equal(tbeam._first_m(avail, 3).numpy(),
                                  [[1, 2, 4], [4, 0, 1]])


def test_beam_search_helper_matches_jax():
    """beam_search (a graph's device views, host queries -> candidate ids)
    in both packages on the same graph, at full depth."""
    from types import SimpleNamespace
    g = _graph(MetricType.EUCLIDEAN, seed=5)
    norms = (g["tab"] ** 2).sum(1).astype(np.float32)
    jg = SimpleNamespace(table=jnp.asarray(g["tab"], jnp.bfloat16),
                         norms=jnp.asarray(norms), adjacency=jnp.asarray(
                             g["adj"]), rep_ids=jnp.asarray(g["reps"]))
    tg = SimpleNamespace(table=torch.from_numpy(g["tab"]).bfloat16(),
                         norms=torch.from_numpy(norms),
                         adjacency=torch.from_numpy(g["adj"]),
                         rep_ids=torch.from_numpy(g["reps"]))
    q = g["q"][:64]
    ji = jbeam.beam_search(jg, q, g["valid"], MetricType.EUCLIDEAN,
                           beam_width=24, compact=96)
    ti = tbeam.beam_search(tg, q, g["valid"], MetricType.EUCLIDEAN,
                           beam_width=24, compact=96)
    assert ti.shape == ji.shape == (64, 24) and ti.dtype == np.int64
    agree = np.mean([set(a[:10]) == set(b[:10]) for a, b in zip(ti, ji)])
    assert agree >= 0.99, agree


# ReplayCache (the captured chains of a table's graph queries). The CPU
# never captures; where a test needs chains, _fake_capture stands in for
# the CUDA capture: its "graph" reruns the search from the query buffer.

REPLAY_COUNTERS = ("cuda_graph_replays_total", "cuda_graph_captures_total",
                   "cuda_graph_eager_total")


def _replay_counts():
    from vectordb_tpu_torch.metrics import metrics
    c = metrics.snapshot()["counters"]
    return np.array([int(c.get(k, 0)) for k in REPLAY_COUNTERS])


def _fake_capture(chain, qp):
    from types import SimpleNamespace
    chain.q_np = qp.copy()

    def replay():
        d, ids = tbeam.beam_search_topk(torch.from_numpy(chain.q_np),
                                        *chain.inputs)
        chain.d_np, chain.ids_np = d.numpy(), ids.numpy()

    chain.graph = SimpleNamespace(replay=replay)
    chain.done = SimpleNamespace(record=lambda: None,
                                 synchronize=lambda: None)
    chain.launches = (0, {}, 0, {})


@pytest.fixture
def fake_capture(monkeypatch):
    """Chains captured on the CPU: every table is capturable, _capture is
    _fake_capture."""
    monkeypatch.setattr(tbeam, "_capturable", lambda table, plan, it: True)
    monkeypatch.setattr(tbeam, "_capture", _fake_capture)


def _topk_inputs(path="split", seed=6):
    """(host queries [8, DP], beam_search_topk's arguments after them)."""
    g = _graph(MetricType.EUCLIDEAN, seed=seed)
    norms = torch.from_numpy((g["tab"] ** 2).sum(1).astype(np.float32))
    fused = path == "fused"
    return g["qp"][:8].copy(), (
        torch.from_numpy(g["tab"]).bfloat16(), norms,
        torch.from_numpy(g["adj"]), torch.from_numpy(g["reps"]),
        torch.from_numpy(g["valid"]), int(MetricType.EUCLIDEAN), 16, 4, 6,
        16, 8, 10, 0 if fused else 96,
        torch.from_numpy(g["fused"]) if fused else None,
        g["scale"] if fused else None)


def _host(out):
    """A search_topk result as numpy (d, ids)."""
    if isinstance(out, tbeam.Replayed):
        return out.fetch()
    return tuple(t.numpy() for t in out)


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("path", ["split", "fused"])
def test_replay_cache_runs_eager_on_the_cpu(path):
    qp, args = _topk_inputs(path)
    want = _host(tbeam.beam_search_topk(torch.from_numpy(qp), *args))
    cache = tbeam.ReplayCache()
    before = _replay_counts()
    for _ in range(3):
        _assert_same(_host(cache.search_topk(qp, *args)), want)
    assert (_replay_counts() - before).tolist() == [0, 0, 3]
    assert len(cache) == 0


KEY_FIELDS = ("qp_shape", "table", "norms", "adjacency", "rep_ids", "valid",
              "metric", "beam_width", "expand", "max_iters", "num_seeds",
              "term_width", "k_out", "compact", "fused", "scale", "plan")


@pytest.mark.parametrize("field", KEY_FIELDS)
def test_replay_key_covers_every_input(field):
    """Changing any one scalar, the plan, or any device input (another
    tensor of the same shape and dtype) gives another key."""
    qp, args = _topk_inputs("fused")
    kw = dict(zip(KEY_FIELDS[1:-1], args))
    kw.update(qp_shape=qp.shape, plan=tbeam.WalkPlan("block", "walk"))
    base = tbeam.replay_key(**kw)
    assert tbeam.replay_key(**kw) == base
    v = kw[field]
    kw[field] = (v.clone() if isinstance(v, torch.Tensor)
                 else (9, DP) if field == "qp_shape"
                 else tbeam.WalkPlan("warp", "walk") if field == "plan"
                 else float(v) * 2 if field == "scale"
                 else v + 1)
    assert tbeam.replay_key(**kw) != base


@pytest.mark.parametrize("cuda,mode,max_iters,want", [
    (False, "walk", 8, False), (True, "walk", 64, True),
    (True, "iteration", tbeam.UNROLL_MAX_ITERS, True),
    (True, "iteration", tbeam.UNROLL_MAX_ITERS + 1, False)])
def test_capturable_chains(cuda, mode, max_iters, want):
    """A CUDA table, and no deep walk of a launch an iteration (the host
    reads the device flag there)."""
    from types import SimpleNamespace
    assert tbeam._capturable(SimpleNamespace(is_cuda=cuda),
                             tbeam.WalkPlan("block", mode),
                             max_iters) is want


def test_replay_cache_captures_on_the_second_sighting(fake_capture):
    """Sighting, capture (and replay), replays: each answer equals the
    eager chain's bit for bit; a chain whose answer is unfetched sends its
    key eager; an unfetched answer dropped frees the chain."""
    qp, args = _topk_inputs()
    qs = [qp + np.float32(0.01) * i for i in range(4)]
    want = [_host(tbeam.beam_search_topk(torch.from_numpy(q), *args))
            for q in qs]
    cache = tbeam.ReplayCache()
    before = _replay_counts()
    out = cache.search_topk(qs[0], *args)
    assert isinstance(out, tuple) and len(cache) == 0
    _assert_same(_host(out), want[0])
    assert (_replay_counts() - before).tolist() == [0, 0, 1]
    out = cache.search_topk(qs[1], *args)
    assert isinstance(out, tbeam.Replayed) and len(cache) == 1
    _assert_same(_host(out), want[1])
    assert (_replay_counts() - before).tolist() == [1, 1, 1]
    held = cache.search_topk(qs[2], *args)
    busy = cache.search_topk(qs[3], *args)
    assert isinstance(busy, tuple)
    _assert_same(_host(busy), want[3])
    _assert_same(_host(held), want[2])
    assert (_replay_counts() - before).tolist() == [2, 1, 2]
    cache.search_topk(qs[0], *args)
    out = cache.search_topk(qs[3], *args)  # the first one was dropped
    _assert_same(_host(out), want[3])
    assert (_replay_counts() - before).tolist() == [4, 1, 2]
    cache.clear()
    assert len(cache) == 0
    assert isinstance(cache.search_topk(qs[0], *args), tuple)


def test_replay_cache_evicts_the_least_recently_used(fake_capture):
    qp, args = _topk_inputs()
    cache = tbeam.ReplayCache()

    def call(k):  # key k: a beam width of its own
        return _host(cache.search_topk(qp, *args[:6], 16 + k, *args[7:]))

    for k in range(tbeam.REPLAY_CHAINS):
        call(k)
        call(k)
    assert len(cache) == tbeam.REPLAY_CHAINS
    call(0)  # key 0 is now the most recent: key 1 goes next
    before = _replay_counts()
    call(99)
    call(99)
    assert len(cache) == tbeam.REPLAY_CHAINS
    call(0)
    call(1)  # evicted: a sighting again
    assert (_replay_counts() - before).tolist() == [2, 1, 2]


def test_replay_cache_refuses_a_key_whose_capture_raises(monkeypatch,
                                                         fake_capture):
    def refuse(chain, qp):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(tbeam, "_capture", refuse)
    qp, args = _topk_inputs()
    want = _host(tbeam.beam_search_topk(torch.from_numpy(qp), *args))
    cache = tbeam.ReplayCache()
    before = _replay_counts()
    for _ in range(4):
        _assert_same(_host(cache.search_topk(qp, *args)), want)
    assert (_replay_counts() - before).tolist() == [0, 0, 4]
    assert len(cache) == 0


def test_replay_cache_skips_inputs_that_do_not_repeat(fake_capture):
    qp, args = _topk_inputs()
    cache = tbeam.ReplayCache()
    before = _replay_counts()
    for _ in range(3):
        assert isinstance(cache.search_topk(qp, *args, repeats=False), tuple)
    assert (_replay_counts() - before).tolist() == [0, 0, 3]


@pytest.fixture
def graph_table(tmp_path):
    """A 1,000-row graph-indexed table on the CPU (the graph branch of
    Table.dispatch_dense_search serves its queries); (table, rows)."""
    import vectordb_tpu_torch as tvdb
    from vectordb_tpu_torch.config import global_config

    saved = dict(vars(global_config))
    tvdb.set_device("cpu")
    tvdb.update_config({"AutoTuneSearch": False})
    x = np.random.default_rng(8).normal(size=(1000, 16)).astype(np.float32)
    assert tvdb.load_db("rp", str(tmp_path / "rp"), vector_scale=2000) == 0
    tvdb.use_db("rp")
    tvdb.create_table("t", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "Emb", "dataType": "VECTOR_FLOAT", "dimensions": 16,
         "metricType": "EUCLIDEAN"}])
    assert tvdb.insert_columns("t", {"ID": np.arange(1000), "Emb": x})[0] == 0
    assert tvdb.rebuild() == 0
    table = tvdb._db.databases["rp"].tables["t"]
    assert table.graphs["Emb"] is not None
    yield table, x
    tvdb._reset_for_tests()
    vars(global_config).update(saved)


def _query_ids(x, i):
    import vectordb_tpu_torch as tvdb
    code, rows = tvdb.query("t", "Emb", x[i].tolist(), ["ID"], 5, "", True)
    assert code == 0 and len(rows) == 5
    return [r["ID"] for r in rows]


def test_graph_branch_runs_eager_on_the_cpu(graph_table):
    table, x = graph_table
    before = _replay_counts()
    for i in range(3):
        assert _query_ids(x, i)[0] == i
    assert (_replay_counts() - before).tolist() == [0, 0, 3]
    assert len(table._replays) == 0


def test_table_drops_chains_on_a_new_mask_and_a_new_index(graph_table,
                                                          fake_capture):
    import vectordb_tpu_torch as tvdb

    table, x = graph_table
    before = _replay_counts()
    eager = [_query_ids(x, i) for i in range(4)]
    assert len(table._replays) == 1
    assert [_query_ids(x, i) for i in range(4)] == eager
    assert (_replay_counts() - before).tolist() == [7, 1, 1]
    assert tvdb.delete_by_pk("t", [2]) == 0  # a new mutation version
    got = _query_ids(x, 2)
    assert 2 not in got and len(table._replays) == 0
    assert _query_ids(x, 3) == eager[3] and len(table._replays) == 1
    assert 2 not in _query_ids(x, 2)
    assert (_replay_counts() - before).tolist() == [9, 2, 2]
    table._install_graph("Emb", table.graphs["Emb"])
    assert len(table._replays) == 0
    assert _query_ids(x, 1) == eager[1]
    assert (_replay_counts() - before).tolist() == [9, 2, 3]
