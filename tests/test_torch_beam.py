"""Beam traversal of vectordb_tpu_torch against vectordb_tpu's on the same
graph: one exact KNN adjacency and one representative set, made with
numpy from a seed, go to both packages' beam_search_grouped (split gather
path with compaction, fused int8 path, the fixed-depth and the deep loop).

Tolerance: after the exact f32 re-rank the top-10 id sets must agree on at
least 99% of queries (traversal scores bf16/int8 rows in f32 in another
summation order, so a near-tie may send a walk elsewhere), distances of the
ids both return within rtol 1e-5, and the port's recall@10 against the
numpy oracle no lower than the JAX package's minus 0.005.
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
