"""The traversal's iteration (ops/beam.beam_iter; on the CPU its plain
version beam_iteration_ref) held against the loop it replaced and against
the JAX package.

- The flag loop (beam.traverse driving beam_iteration_ref: one call an
  iteration for a batch, the device flag for the stop rule, one call for a
  single query's whole walk) equals the port's earlier loop (kept below as
  `_earlier_walk`: the fixed-depth loop with `torch.where` on a device
  scalar, the host-checked loop past UNROLL_MAX_ITERS) bit for bit in
  (beam_d, beam_ids, visited): split path with and without compaction,
  fused path, every metric, deep walks, a single query.
- beam_search_kernel against vectordb_tpu's on the same graph (bf16 rows,
  f32 sums in another order, so a near-tie may send a walk elsewhere): the
  first ten beam ids agree as sets on at least 97% of queries, and their
  distances within rtol 1e-5 plus 1e-5 x (|q|^2 + max |x|^2) (EUCLIDEAN;
  1e-5 for the others) where both hold an id.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vectordb_tpu.ops import beam as jbeam
from vectordb_tpu_torch.ops import beam as tbeam
from vectordb_tpu_torch.ops.gather import gather_rows
from vectordb_tpu_torch.schema import MetricType

METRICS = [MetricType.EUCLIDEAN, MetricType.COSINE, MetricType.DOT_PRODUCT]
_INF = float("inf")


def _earlier_walk(q, q_norms, table, adjacency, fused, scale, state,
                  metric, M, max_iters, tw, cp_all):
    """The port's traversal loop before the kernel, verbatim but for the
    seed scan (the state comes in): body() and its two loops."""
    b, d = q.shape
    R = adjacency.shape[1]
    C = M * R
    cols = torch.arange(C)

    def has_work(state):
        _, exp, bd, _ = state
        return (~exp[:, :tw] & torch.isfinite(bd[:, :tw])).any()

    def body(state, it, cp):
        beam_ids, beam_exp, beam_d, visited = state
        avail = ~beam_exp & torch.isfinite(beam_d)
        pick_idx = tbeam._first_m(avail, M)
        picked_valid = torch.gather(avail, 1, pick_idx)
        picked_ids = torch.gather(beam_ids, 1, pick_idx)
        beam_exp = beam_exp.scatter(1, pick_idx, True)
        visited = torch.cat([
            visited[:, :it * M],
            torch.where(picked_valid, picked_ids, -1),
            visited[:, (it + 1) * M:]], dim=1)
        cand = gather_rows(adjacency, picked_ids).reshape(b, C)
        cand = torch.where(picked_valid.repeat_interleave(R, dim=1), cand, -1)
        in_beam = (cand[:, :, None] == beam_ids[:, None, :]).any(dim=2)
        first = torch.argmax(
            (cand[:, :, None] == cand[:, None, :]).to(torch.uint8), dim=2)
        seen = (cand[:, :, None] == visited[:, None, :]).any(dim=2)
        bad = (cand < 0) | in_beam | (first != cols) | seen
        if fused is not None:
            rows = gather_rows(fused, picked_ids).reshape(b, C, d)
            cand_d = tbeam._cand_scores_q(q, rows, q_norms, scale, metric)
            cand_d = cand_d.masked_fill(bad, _INF)
            cand_ids = torch.where(bad, -1, cand)
        else:
            cand = torch.where(bad, -1, cand)
            if 0 < cp < C:
                order = torch.sort((cand < 0).to(torch.int32), dim=1,
                                   stable=True)[1]
                cand = torch.gather(cand, 1, order[:, :cp])
            vecs = gather_rows(table, cand)
            cand_d = tbeam._cand_scores(q, vecs, q_norms, metric)
            cand_d = cand_d.masked_fill(cand < 0, _INF)
            cand_ids = cand
        L = beam_d.shape[1]
        all_d = torch.cat([beam_d, cand_d], dim=1)
        all_ids = torch.cat([beam_ids, cand_ids], dim=1)
        all_exp = torch.cat([beam_exp, torch.zeros_like(cand_ids,
                                                        dtype=torch.bool)],
                            dim=1)
        sd, order = torch.sort(all_d, dim=1, stable=True)
        keep = order[:, :L]
        return (torch.gather(all_ids, 1, keep),
                torch.gather(all_exp, 1, keep), sd[:, :L], visited)

    done = 0
    if fused is None and 0 < cp_all < C and max_iters > 0:
        state = body(state, 0, 0)
        done = 1
    if max_iters <= tbeam.UNROLL_MAX_ITERS:
        for it in range(done, max_iters):
            live = has_work(state)
            nxt = body(state, it, cp_all)
            state = tuple(torch.where(live, new, old)
                          for new, old in zip(nxt, state))
    else:
        it = done
        while it < max_iters and bool(has_work(state)):
            state = body(state, it, cp_all)
            it += 1
    return state


def _case(seed, n, d, r, b, L, metric, fused, max_iters, integer=False):
    """A random graph (10% padding edges, a fifth of the rows repeating an
    edge), b queries, each beam seeded with 8 random rows at their
    distances, ascending, then -1 / inf. Rows and queries are normal
    (bf16-rounded) or, with `integer`, integers in [-3, 3]."""
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
        q = rng.integers(-3, 4, size=(b, d)).astype(np.float32)
    else:
        x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)
                             ).bfloat16().float().numpy()
        q = rng.normal(size=(b, d)).astype(np.float32)
    adj = rng.integers(0, n, size=(n, r)).astype(np.int32)
    adj[rng.random((n, r)) < 0.1] = -1
    rep = rng.random(n) < 0.2
    adj[rep, 1] = adj[rep, 0]
    ip = q @ x.T
    dist = ((q * q).sum(1)[:, None] - 2 * ip + (x * x).sum(1)[None]
            if metric == MetricType.EUCLIDEAN
            else 1.0 - ip if metric == MetricType.COSINE else -ip)
    ids = np.full((b, L), -1, np.int32)
    dd = np.full((b, L), np.inf, np.float32)
    for i in range(b):
        s = rng.choice(n, min(8, L), replace=False)
        order = np.argsort(dist[i, s], kind="stable")
        ids[i, :len(s)] = s[order]
        dd[i, :len(s)] = dist[i, s[order]]
    kw = dict(q=torch.from_numpy(q).bfloat16(),
              q_norms=torch.from_numpy((q * q).sum(1)),
              table=torch.from_numpy(x).bfloat16(),
              adjacency=torch.from_numpy(adj), fused=None, scale=None)
    if fused:
        f = np.clip(np.round(x[np.clip(adj, 0, n - 1)] * 30), -127, 127)
        kw.update(fused=torch.from_numpy(f.astype(np.int8).reshape(n, -1)),
                  scale=float(np.float32(1 / 30)))
    state = (torch.from_numpy(ids), torch.zeros((b, L), dtype=torch.bool),
             torch.from_numpy(dd),
             torch.full((b, 4 * max_iters), -1, dtype=torch.int32))
    return kw, state


def _both(kw, state, metric, max_iters, tw, compact):
    """(flag loop state, earlier loop state) from the same start."""
    new = tuple(t.clone() for t in state)
    tbeam.traverse(**kw, beam_ids=new[0], beam_exp=new[1], beam_d=new[2],
                   visited=new[3], metric=int(metric), expand=4,
                   max_iters=max_iters, term_width=tw, compact=compact)
    C = 4 * kw["adjacency"].shape[1]
    old = _earlier_walk(**kw, state=state, metric=int(metric), M=4,
                        max_iters=max_iters, tw=min(tw or 10**9,
                                                    state[0].shape[1]),
                        cp_all=compact if compact > 0 else C)
    return new, old


def _assert_same(new, old):
    for name, a, b in zip(("beam_ids", "beam_exp", "beam_d", "visited"),
                          new, old):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("path,compact", [("split", 96), ("split", 0),
                                          ("fused", 0)])
def test_flag_loop_equals_earlier_loop(metric, path, compact):
    """A batch of 24 walks over 600 rows, L 32, R 48, up to 16 iterations,
    tw 4: the batch stops before its last iteration."""
    kw, state = _case(0, 600, 32, 48, 24, 32, metric, path == "fused", 16)
    new, old = _both(kw, state, metric, 16, 4, compact)
    _assert_same(new, old)
    walked = (new[3] >= 0).sum(1)
    assert 8 < int(walked.max()) < 4 * 16


@pytest.mark.parametrize("path", ["split", "fused"])
def test_deep_flag_loop_equals_host_checked_loop(path):
    """Past UNROLL_MAX_ITERS: the host asks the flag every
    DEEP_CHECK_EVERY launches, the earlier loop every iteration."""
    kw, state = _case(1, 800, 32, 16, 8, 48, MetricType.EUCLIDEAN,
                      path == "fused", 48, integer=True)
    new, old = _both(kw, state, MetricType.EUCLIDEAN, 48, 4, 40)
    _assert_same(new, old)
    assert int((new[3] >= 0).sum(1).max()) < 4 * 48  # it stopped early


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("path", ["split", "fused"])
def test_single_query_walk_in_one_call(monkeypatch, metric, path):
    """A batch of one walks in one beam_iter call, equal to the earlier
    loop."""
    kw, state = _case(2, 600, 32, 48, 1, 32, metric, path == "fused", 20,
                      integer=True)
    calls = []
    real = tbeam.beam_iteration_ref
    monkeypatch.setattr(tbeam, "beam_iteration_ref",
                        lambda *a: calls.append(a[-5:-3]) or real(*a))
    new, old = _both(kw, state, metric, 20, 4, 96)
    _assert_same(new, old)
    assert calls == [(0, 20)]
    assert 0 < int((new[3] >= 0).sum()) < 4 * 20  # it stopped early


def test_beam_iter_rejects_what_the_kernel_does_not_take():
    kw, state = _case(3, 200, 32, 16, 4, 16, MetricType.EUCLIDEAN, False, 4)
    flags = torch.zeros(5, dtype=torch.int32)
    args = [kw["q"], kw["q_norms"], kw["table"], kw["adjacency"], None, None,
            *state]

    def call(*a, expand=4, it=(0, 1), variant="block"):
        tbeam.beam_iter(*a, flags, expand, 1, it[0], it[1], 40, 16, False,
                        variant)

    with pytest.raises(TypeError):
        call(kw["q"].float(), *args[1:])
    with pytest.raises(TypeError):
        call(*args[:6], state[0].long(), *state[1:])
    with pytest.raises(ValueError):
        call(*args, variant="thread")  # no such kernel
    wide = [*args[:6], *(torch.cat([t] * 5, dim=1) for t in state[:3]),
            state[3]]
    call(*wide, variant="block")
    with pytest.raises(ValueError):
        call(*wide, variant="warp")  # L 80 past the warp variant's 64
    with pytest.raises(ValueError):
        call(*args, it=(4, 5))  # past visited
    with pytest.raises(ValueError):
        call(*args, expand=17)  # more picks than the beam holds


def test_beam_iter_cost_counts_each_byte_once():
    """2,048 queries, L 64, M 4, R 48, 96 bf16 rows of 128 scored a query,
    16 visited ids a query: about 27 KB a query-iteration."""
    b = 2048
    cost = tbeam.beam_iter_cost(b, 64, 16 * b, 4 * b, 48, 96 * b, 256)
    assert cost == b * (2 * 9 * 64 + 4 * 16 + 4 * 4 * 48 + 96 * 256)
    assert 26_000 < cost / b < 28_000


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("b,L,m,r,d,dtype,fused,vis,resident,want", [
    # the 1M main path's walks: L 18 x 4, 2,048 queries and one
    (2048, 18, 4, 48, 128, BF16, True, 16, {"warp": 32, "block": 4},
     ("warp", "walk")),
    (1, 18, 4, 48, 128, BF16, False, 16, {"warp": 32, "block": 4},
     ("block", "walk")),
    # a query for each multiprocessor at most: the block variant
    (132, 18, 4, 48, 128, BF16, True, 16, {"warp": 32, "block": 2},
     ("block", "walk")),
    (133, 18, 4, 48, 128, BF16, True, 16, {"warp": 32, "block": 2},
     ("warp", "walk")),
    # L at the warp variant's limit and one past it
    (2048, 64, 4, 48, 128, BF16, True, 64, {"warp": 32, "block": 4},
     ("warp", "walk")),
    (2048, 65, 4, 48, 128, BF16, True, 64, {"warp": 32, "block": 4},
     ("block", "iteration")),
    # a batch the card cannot hold at once: one launch an iteration
    (4225, 18, 4, 48, 128, BF16, True, 16, {"warp": 32, "block": 4},
     ("warp", "iteration")),
    (4224, 18, 4, 48, 128, BF16, True, 16, {"warp": 32, "block": 4},
     ("warp", "walk")),
    # a wide filtered beam: the block variant, resident or not
    (1, 16000, 4, 48, 128, BF16, False, 64, {"block": 1},
     ("block", "walk")),
    (16, 1024, 4, 48, 128, BF16, False, 4096, {"block": 2},
     ("block", "walk")),
    (600, 1024, 4, 48, 128, BF16, False, 4096, {"block": 2},
     ("block", "iteration")),
    # C = M * R past 256, rows past 32 chunks, visited past 1,024
    (200, 18, 4, 65, 128, BF16, False, 16, {"block": 2},
     ("block", "walk")),
    (200, 18, 4, 48, 512, BF16, False, 16, {"block": 2},
     ("block", "walk")),
    (200, 18, 4, 48, 512, BF16, True, 16, {"warp": 8, "block": 2},
     ("warp", "walk")),
    (200, 18, 4, 48, 256, F32, False, 16, {"block": 2},
     ("block", "walk")),
    (200, 18, 4, 48, 16, F32, False, 1025, {"block": 2},
     ("block", "walk")),
    # no occupancy known (as on the CPU): a batch an iteration a call
    (7, 18, 4, 48, 128, BF16, False, 16, {}, ("block", "iteration")),
    (700, 18, 4, 48, 128, BF16, False, 16, {}, ("warp", "iteration")),
])
def test_walk_plan_choices(b, L, m, r, d, dtype, fused, vis, resident,
                           want):
    plan = tbeam.walk_plan(b, L, m, r, d, dtype, fused, vis, resident, 132)
    assert plan == tbeam.WalkPlan(*want)


def test_walk_bytes_counts_the_beam_and_visited_once():
    """One query, L 8, M 1, R 2, one iteration: the beam read and written
    once, one visited id, one adjacency row, the two candidates' rows, the
    query and its norm; a batch of two such queries, twice that; a walk
    that cannot start, the beam and the queries alone."""
    d = 16
    x = torch.arange(10 * d, dtype=torch.float32).reshape(10, d).bfloat16()
    adj = torch.tensor([[1, 2]] + [[0, 0]] * 9, dtype=torch.int32)
    q = torch.zeros((2, d), dtype=torch.bfloat16)
    ids = torch.tensor([[0] + [-1] * 7] * 2, dtype=torch.int32)
    bd = torch.tensor([[0.0] + [_INF] * 7] * 2)
    kw = dict(q=q, q_norms=torch.zeros(2), table=x, adjacency=adj,
              fused=None, scale=None, beam_ids=ids,
              beam_exp=torch.zeros((2, 8), dtype=torch.bool), beam_d=bd,
              visited=torch.full((2, 1), -1, dtype=torch.int32),
              metric=int(MetricType.EUCLIDEAN), expand=1, max_iters=1)
    one = 2 * 9 * 8 + 4 + 4 * 2 + 2 * d * 2 + d * 2 + 4
    one_q = {k: v[:1] if isinstance(v, torch.Tensor) and v.shape[0] == 2
             else v for k, v in kw.items()}
    assert tbeam.walk_bytes(**one_q) == one
    assert tbeam.walk_bytes(**kw) == 2 * one
    kw["beam_exp"] = torch.ones((2, 8), dtype=torch.bool)
    assert tbeam.walk_bytes(**kw) == 2 * (2 * 9 * 8 + d * 2 + 4)
    assert torch.equal(kw["beam_ids"], ids)  # the state is left as it is


@pytest.mark.parametrize("path,iters", [("split", 16), ("fused", 16),
                                        ("split", 40)])
def test_walk_in_one_call_equals_a_call_an_iteration(monkeypatch, path,
                                                     iters):
    """A batch's whole walk in one beam_iter call (the flag read after
    every iteration, as the cooperative launch does) equals one call an
    iteration and the earlier loop, also past UNROLL_MAX_ITERS."""
    kw, state = _case(4, 600, 32, 48, 12, 32, MetricType.COSINE,
                      path == "fused", iters, integer=True)
    calls = []
    real = tbeam.beam_iteration_ref
    monkeypatch.setattr(tbeam, "beam_iteration_ref",
                        lambda *a: calls.append(a[-5:-3]) or real(*a))
    runs = {}
    for mode in ("walk", "iteration"):
        new = tuple(t.clone() for t in state)
        tbeam.traverse(**kw, beam_ids=new[0], beam_exp=new[1],
                       beam_d=new[2], visited=new[3],
                       metric=int(MetricType.COSINE), expand=4,
                       max_iters=iters, term_width=4, compact=40,
                       plan=tbeam.WalkPlan("warp", mode))
        runs[mode] = new
    assert calls[0] == (0, iters) and len(calls) > 2
    _assert_same(runs["walk"], runs["iteration"])
    old = _earlier_walk(**kw, state=state, metric=int(MetricType.COSINE),
                        M=4, max_iters=iters, tw=4, cp_all=40)
    _assert_same(runs["walk"], old)
    walked = (runs["walk"][3] >= 0).sum(1)
    assert 4 < int(walked.max()) < 4 * iters  # it stopped early


def _graph(metric, seed):
    """A 32-NN graph of 3,000 clustered bf16 rows (padded to 64 lanes and
    R = 48), 256 representatives, 96 near-duplicate queries."""
    rng = np.random.default_rng(seed)
    n, dim, dp, r = 3000, 32, 64, 48
    centers = rng.normal(size=(20, dim)) * 3
    x = centers[rng.integers(0, 20, n)] + rng.normal(size=(n, dim))
    q = x[rng.integers(0, n, 96)] + 0.1 * rng.normal(size=(96, dim))
    if metric == MetricType.COSINE:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    x = torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()
    ip = x.astype(np.float64) @ x.T.astype(np.float64)
    d = ((x.astype(np.float64) ** 2).sum(1)[:, None] - 2 * ip
         + (x.astype(np.float64) ** 2).sum(1)[None]
         if metric == MetricType.EUCLIDEAN
         else 1 - ip if metric == MetricType.COSINE else -ip)
    np.fill_diagonal(d, np.inf)
    adj = np.full((n, r), -1, np.int32)
    adj[:, :32] = np.argsort(d, axis=1)[:, :32]
    tab = np.zeros((n, dp), np.float32)
    tab[:, :dim] = x
    qp = np.zeros((96, dp), np.float32)
    qp[:, :dim] = q
    scale = np.float32(np.abs(x).max() / 127)
    fused = np.zeros((n, r, dp), np.int8)
    fused[:, :, :dim] = np.clip(np.round(x[np.clip(adj, 0, n - 1)] / scale),
                                -127, 127)
    return dict(tab=tab, qp=qp, adj=adj,
                reps=rng.choice(n, 256, replace=False).astype(np.int32),
                norms=(tab.astype(np.float64) ** 2).sum(1).astype(np.float32),
                fused=fused.reshape(n, -1), scale=scale)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("path", ["split", "fused"])
def test_beam_search_kernel_matches_jax(metric, path):
    g = _graph(metric, seed=int(metric) + 10)
    fused = path == "fused"
    args = dict(metric=int(metric), beam_width=32, expand=4, max_iters=10,
                num_seeds=16, term_width=12, compact=0 if fused else 96)
    jd, ji, _ = jbeam.beam_search_kernel(
        jnp.asarray(g["qp"]), jnp.asarray(g["tab"], jnp.bfloat16),
        jnp.asarray(g["norms"]), jnp.asarray(g["adj"]),
        jnp.asarray(g["reps"]),
        fused=jnp.asarray(g["fused"]) if fused else None,
        scale=g["scale"] if fused else None, **args)
    td, ti, tv = tbeam.beam_search_kernel(
        torch.from_numpy(g["qp"]), torch.from_numpy(g["tab"]).bfloat16(),
        torch.from_numpy(g["norms"]), torch.from_numpy(g["adj"]),
        torch.from_numpy(g["reps"]),
        fused=torch.from_numpy(g["fused"]) if fused else None,
        scale=float(g["scale"]) if fused else None, **args)
    jd, ji = np.asarray(jd), np.asarray(ji)
    td, ti = td.numpy(), ti.numpy()
    assert ti.shape == ji.shape == (96, 32) and tv.shape == (96, 40)
    agree = np.mean([set(a[:10]) == set(b[:10]) for a, b in zip(ti, ji)])
    assert agree >= 0.97, agree
    # |q|^2 - 2 ip + |x|^2 in f32 in another order: within 1e-5 of the
    # magnitudes it cancels.
    mag = ((g["qp"] ** 2).sum(1) + g["norms"].max()
           if metric == MetricType.EUCLIDEAN else np.ones(96))
    for a_i, a_d, b_i, b_d, m in zip(ti, td, ji, jd, mag):
        both, ia, ib = np.intersect1d(a_i[a_i >= 0], b_i,
                                      return_indices=True)
        np.testing.assert_allclose(a_d[ia], b_d[ib], rtol=1e-5,
                                   atol=1e-5 * m)
