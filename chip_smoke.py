"""Smoke run of vectordb_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA libraries from vectordb_tpu_torch/csrc (the partial-min
kernel for ctypes, the gather kernel and the sparse scorer's CSR kernel
each with its PyTorch operator; one nvcc each, in parallel) and holds each
kernel against its plain PyTorch version on the card: the partial-min scan
at the flat-serve shape (B = 8192
queries, N = 262,144 rows, D = 128, bf16) and at the exact-KNN shape
(B = 1,024, N = 1,048,576, exclude_self, n_valid); the row gather, bit for
bit, at every row width the main path gathers (gather.MAIN_PATH_SHAPES:
bf16 store rows, int8 fused rows, int32 adjacency rows, a shard's int32
adjacency rows, f32 re-rank rows, f32 scalars, the build's int8 store
rows, a sparse query's f32 scatter, the IVF build's bf16 candidate rows);
and the query wires' device round trip (ops/qwire.apply_wire, bf16 and
block int8) bit for bit against the host's on 8,192 x 128 queries, with the
prologue's time at a super-chunk of 8,192 x 128.
Each case prints its time beside its
bound on the H100
(bytes moved once each at 3.35 TB/s, FLOPs at the 989 TFLOP/s bf16
tensor-core rate; the share of the bound), the plain version's time, and a
yardstick it is never replaced by: index_select on clamped ids for the
gather (with the host µs a call of both), and for the scan the bf16
matmul that writes the [B, N] scores the scan never stores. Then it drives
the port's paths, each with the launch counts set to 0 just before and
read just after (gathers also by row width):
  - flat-serve: a 250,000 x 128 clustered table, single queries through
    vdb.query, 16,384 queries through Table.grouped_dense_search, then the
    same with a device filter keeping half the rows (partial-min kernel
    with the device mask), then with QueryDtype=int8 (the scan scores the
    wire's values);
  - graph: a 1,000,000 x 128 clustered table with attributes `cat` (INT,
    0-9) and `price` (DOUBLE, [0, 100)), vdb.rebuild() (exact KNN on the
    partial-min kernel, pruning, auto-tune), single queries through
    vdb.query, 16,384 grouped queries with FusedTraversal auto and off and
    with the device filter `cat < 5` (traversal gathers through the
    row-gather kernel), then one grouped program and 20 single queries
    under torch.profiler (device time, the gather's share, idle share);
    then the query wires: 16,384 grouped queries under QueryDtype f32, bf16
    and int8, and under auto after a fresh tune_search_ef (which wire and
    rung it picks);
  - REST in-process over that database: 2,048 single queries from 16
    client threads over four filters (none, `cat < 5`, `price > 80.0`,
    `price < 5.0`), an insert of 2,048 rows served from the flat tail,
    and POST /api/rebuild;
  - the CLI as users start it: `python -m vectordb_tpu_torch` in a child
    process loads a dump of the database, answers queries and statistics,
    and exits 0 on SIGINT;
  - sparse + hybrid (after the 1M database is unloaded): 1,000,000 rows of
    a dense field and a SPLADE-like sparse field over BERT's 30,522-term
    vocabulary (about 120 Zipf(1.1) terms a row), 256 sparse queries
    through vdb.query (64 more under `ID < 500000`) against a float64 CSR
    oracle on the card, the scorer's error and time beside the JAX
    package's prefix difference, 256 hybrid queries (rrf and weighted)
    against the fusion rule recomputed from single-field queries, and 64
    sparse + 64 hybrid requests over REST (the sparse scorer's kernel,
    csr_ip, launched once a query with sparse terms, with the scatter in
    shared memory; no 4-byte gather); then csr_ip against its plain
    version at the 1M x 120M-nnz shape and at a scatter too large for
    shared memory (a query up to term 200,000), timed in turns with the
    plain version, the three-pass route it replaced (gather kernel,
    multiply, segment_reduce), its global-memory variant and cuSPARSE's
    SpMV (the library call for the same function);
  - IVF build: 3,000,000 x 128 clustered rows, vdb.rebuild() at the
    default IvfKnnThreshold (ops/ivf.ivf_knn builds the KNN graph), its
    neighbour recall@64 against the exact top-64 on the card, 16,384
    grouped and 264 single queries;
  - sharded (after the IVF database is unloaded): ShardCount=4 over four
    shards on this card (parallel.set_engine_mesh), 4,000,000 x 128
    clustered rows (seed 4) with `cat`: 64 flat single queries before the
    build, vdb.rebuild() (one graph a shard: exact KNN on the partial-min
    kernel, pruning on the gather kernel), 16,384 grouped and 256 single
    queries (and a profiled grouped program and 20 single queries), the
    16,384 grouped queries again under QueryDtype=int8, 64 under `cat <
    5`, an insert of 2,048 rows found first from the flat tail, then an
    unload and a load of the sharded graph.
Results are checked against exact (masked) oracles: recall@10 >= 0.99
(0.95 for the widened-beam filters; IVF neighbour recall@64 >= 0.90),
every returned row passes its filter, distances equal an f32 (sparse:
float64) recomputation from the f32 query under every query wire. Exits
non-zero on any failure and when no CUDA device is present; the last line
is a JSON object with "ok": true.
"""
from __future__ import annotations

import http.client
import json
import os
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

from typing import Tuple

import numpy as np
import torch

import vectordb_tpu_torch as vdb
from vectordb_tpu_torch import _cuda_build, rest
from vectordb_tpu_torch.expr.parser import parse_expr
from vectordb_tpu_torch.ops import gather, ivf, partial_min, qwire, sparse
from vectordb_tpu_torch.ops.sparse import SparseVector
from vectordb_tpu_torch.schema import MetricType

KERNEL_B, KERNEL_N, KERNEL_D = 8192, 262144, 128
KNN_B, KNN_N, KNN_N_VALID, KNN_Q_BASE = 1024, 1_048_576, 1_000_000, 4096
SLICE_N, SLICE_D, SLICE_Q, SLICE_BATCH = 250_000, 128, 16_384, 2048
GRAPH_N, GRAPH_D, GRAPH_Q, GRAPH_BATCH = 1_000_000, 128, 16_384, 2048
RECALL_FLOOR = 0.99
# Filtered queries that the graph serves with a widened beam (the JAX
# package's selectivity rule, not retuned) are held to this floor.
WIDENED_RECALL_FLOOR = 0.95
# REST phase: requests, client threads, filters (name -> (filter string,
# row predicate over the cat / price columns)), rows inserted over HTTP.
REST_QUERIES, REST_CLIENTS, REST_INSERT = 2048, 16, 2048
REST_FILTERS = (("none", "", None),
                ("cat<5", "cat < 5", lambda c, p: c < 5),
                ("price>80", "price > 80.0", lambda c, p: p > 80.0),
                ("price<5", "price < 5.0", lambda c, p: p < 5.0))
CLI_BOOT_S = 120
# Sparse + hybrid phase: rows, BERT's WordPiece vocabulary, Zipf draws a
# row (about 120 distinct terms), queries (all, filtered, hybrid, REST).
SPARSE_N, SPARSE_VOCAB, SPARSE_DRAWS = 1_000_000, 30_522, 203
SPARSE_Q, SPARSE_FILTERED_Q, HYBRID_Q = 256, 64, 256
REST_SPARSE, REST_HYBRID = 64, 64
# The sparse scorer's kernel at a scatter too large for shared memory: a
# column of rows of 0-239 term ids below 250,000 and a query whose largest
# term is 200,000 (hashed or large term ids; stored ids past it read the
# scatter's trailing 0).
CSR_L2_ROWS, CSR_L2_TERMS, CSR_L2_QMAX = 100_000, 250_000, 200_000
# Kernel vs plain version: the same f32 products added in another order;
# within rtol 1e-5 + 1e-5 * sum |q_i x_i| of the row (PERF.md section 2).
CSR_RTOL, CSR_ATOL_SCALE = 1e-5, 1e-5
# IVF build phase: rows (the default IvfKnnThreshold), rows whose KNN
# lists are held to the exact top-64, grouped and single queries.
IVF_N, IVF_SAMPLE, IVF_Q, IVF_SINGLE = 3_000_000, 4096, 16_384, 256
IVF_RECALL_FLOOR = 0.90  # tests/test_ivf_knn.py holds ivf_knn to it
# Sharded phase: rows over SHARD_COUNT shards on the one card (1M a shard,
# the graph slice's scale), queries grouped, single, before the build and
# under `cat < 5`, rows inserted after the build.
SHARD_N, SHARD_COUNT, SHARD_Q = 4_000_000, 4, 16_384
SHARD_SINGLE, SHARD_PRE, SHARD_FILTERED, SHARD_INSERT = 256, 64, 64, 2048
# Query wires (QueryDtype): rows of the device round trip held bit for bit
# to the host's, and the wires each grouped phase forces.
WIRE_ROWS = 8192
GRAPH_WIRES = ("f32", "bf16", "int8")
# Both sides add exact bf16 x bf16 products in f32 (the kernel on the tensor
# cores), in different orders: an order changes a sum of D terms by at most
# about D * 2^-24 of the sum of magnitudes, which |q|^2 + |x|^2 bounds.
# Values must agree within rtol 1e-5 + 1e-5 * max(|q|^2 + |x|^2).
VAL_RTOL, VAL_ATOL_SCALE = 1e-5, 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def stream_ms(call, inner: int = 50) -> float:
    """ms of one call from a stream: CUDA events around `inner`
    back-to-back calls, over `inner`, so a call shorter than its launch is
    timed from a full queue (its figure is then the host's launch rate)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(inner):
        call()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / inner


def host_us(call, calls: int = 1000) -> float:
    """Host µs of one call: the wall of `calls` back-to-back calls with no
    sync, over `calls`. Where a call's device time is longer, the queue
    fills and this is the device's time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / calls * 1e6


def in_turns(calls: dict, sample, rounds: int) -> dict:
    """{name: median of `rounds` samples of sample(call)}: every round takes
    one sample of each call in turn (after one warm-up call each), so a
    drift in the host's or the card's speed falls on all of them alike."""
    for call in calls.values():
        call()
    torch.cuda.synchronize()
    got = {name: [] for name in calls}
    for _ in range(rounds):
        for name, call in calls.items():
            got[name].append(sample(call))
    return {name: statistics.median(v) for name, v in got.items()}


def cuda_ms(fn, reps: int = 5, inner: int = 1) -> float:
    """Median of `reps` samples of stream_ms after one warm-up."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(stream_ms(fn, inner) for _ in range(reps))


def reset_counts() -> None:
    """Every kernel's launch counts to 0, just before a phase."""
    partial_min.reset_launches()
    gather.reset_launches()
    sparse.reset_launches()


def read_counts() -> dict:
    """The launch counts since reset_counts(), just after a phase."""
    return {"partial_min": partial_min.launches, "gather": gather.launches,
            "gather_by_row_bytes": dict(gather.launches_by_row_bytes),
            "csr_ip": sparse.launches,
            "csr_ip_by_variant": dict(sparse.launches_by_variant)}


def check_wires(dev: torch.device) -> dict:
    """ops/qwire.apply_wire on the card against the host round trip, bit
    for bit, for WIRE_ROWS x 128 queries at mixed scales (all-zero rows,
    hot blocks, block maxima whose scale sits on a bf16 tie) and a dim of
    100; and the prologue's time at the grouped super-chunk's shape
    (4 x GRAPH_BATCH rows of 128)."""
    rng = np.random.default_rng(6)
    q = (rng.normal(size=(WIRE_ROWS, 128))
         * rng.uniform(0.01, 100.0, size=(WIRE_ROWS, 1))).astype(np.float32)
    q[::97] = 0.0
    q[1::89, :qwire.QBLOCK] = 1e4
    # Rows 2, 91, ...: every block's max m makes m / 127 a bf16 tie.
    hi = (0x3C00 + rng.integers(0, 0x300, size=(q[2::89].shape[0], 16))
          ).astype(np.uint32)
    amax = ((hi << 16) | 0x8000).view(np.float32) * np.float32(127.0)
    blocks = q[2::89].reshape(-1, 16, qwire.QBLOCK)
    blocks[:, :, 0] = amax
    blocks[:, :, 1:] = np.clip(blocks[:, :, 1:], -amax[:, :, None],
                               amax[:, :, None])
    q[2::89] = blocks.reshape(-1, 128)
    out = {}
    for wire in ("bf16", "int8"):
        for name, c in (("128", q), ("100", q[:1024, :100])):
            got = qwire.apply_wire(torch.from_numpy(np.ascontiguousarray(c))
                                   .to(dev), wire).cpu().numpy()
            want = qwire.roundtrip(c, wire)
            diff = int(np.count_nonzero(got.view(np.uint32)
                                        != want.view(np.uint32)))
            if got.shape != c.shape or diff:
                raise AssertionError(f"{wire} wire, dim {name}: {diff} values "
                                     "differ from the host round trip")
        out[wire] = {"rows": WIRE_ROWS, "bitwise_equal": True}
    qd = torch.from_numpy(q[:4 * GRAPH_BATCH]).to(dev)
    for wire in ("f32", "bf16", "int8"):
        out.setdefault(wire, {})["prologue_us"] = 1e3 * cuda_ms(
            lambda: qwire.apply_wire(qd, wire), reps=5, inner=20)
    log(f"query wires on the card: {json.dumps(out)}")
    return out


def wire_pass(table, wire: str, queries, valid, batch: int, x, want,
              kernel: str) -> dict:
    """QueryDtype=`wire`, then grouped_dense_search of `queries` (after one
    warm-up call), launch counts at 0 just before and read just after:
    QPS, recall@10 of the first len(want) queries against `want`, held to
    RECALL_FLOOR, distances exact against the f32 query (rtol 1e-5), and
    `kernel` launched."""
    assert vdb.update_config({"QueryDtype": wire}) == 0
    table.grouped_dense_search("Emb", queries[:batch * 4 + 1], valid,
                               MetricType.EUCLIDEAN, 10, batch=batch)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ids, dists = table.grouped_dense_search(
        "Emb", queries, valid, MetricType.EUCLIDEAN, 10, batch=batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    r = {"wire": table._query_wire("Emb"), "qps": queries.shape[0] / wall,
         "wall_s": wall, "counts": read_counts()}
    if r["counts"][kernel] <= 0:
        raise AssertionError(f"QueryDtype={wire}: {kernel} never launched")
    if ids.shape != (queries.shape[0], 10) or not np.isfinite(dists).all():
        raise AssertionError(f"QueryDtype={wire}: result shape {ids.shape}")
    r["recall_at_10"] = float(np.mean([len(set(a) & set(b)) / 10.0
                                       for a, b in zip(ids, want)]))
    if r["recall_at_10"] < RECALL_FLOOR:
        raise AssertionError(f"QueryDtype={wire}: recall@10 "
                             f"{r['recall_at_10']} < {RECALL_FLOOR}")
    exact = ((x[ids] - queries[:, None, :]) ** 2).sum(2)
    if not np.allclose(dists, exact, rtol=1e-5, atol=0.0):
        raise AssertionError(f"QueryDtype={wire}: distances differ from "
                             "the f32 recomputation")
    return r


def device_profile(fn) -> dict:
    """fn() under torch.profiler: its wall, the device time of every kernel
    and copy, the gather kernel's and the csr_ip kernel's parts of it, and
    the device's idle share of the wall (the profiler's own host cost counts
    as idle). The share is not clamped: kernels that overlapped on several
    streams would count twice and show as a negative share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_us = gather_us = csr_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        device_us += us
        if "gather_rows" in ev.key:
            gather_us += us
        if "csr_ip_kernel" in ev.key:
            csr_us += us
    return {"wall_ms": wall_ms, "device_ms": device_us / 1e3,
            "gather_ms": gather_us / 1e3,
            "gather_share": gather_us / device_us if device_us else 0.0,
            "csr_ip_ms": csr_us / 1e3,
            "csr_ip_share": csr_us / device_us if device_us else 0.0,
            "idle_share": 1.0 - device_us / 1e3 / wall_ms}


def make_clustered(n: int, dim: int, n_queries: int, seed: int = 0,
                   n_centers: int = 3000):
    """Clustered table + near-duplicate queries (bench.make_clustered's
    generator, copied so this script imports nothing of the JAX package)."""
    rng = np.random.default_rng(seed)
    centers = (rng.normal(size=(n_centers, dim)) * 2).astype(np.float32)
    x = np.empty((n, dim), dtype=np.float32)
    for s in range(0, n, 1_000_000):
        e = min(s + 1_000_000, n)
        x[s:e] = (centers[rng.integers(0, n_centers, e - s)]
                  + rng.normal(size=(e - s, dim)).astype(np.float32))
    queries = (x[rng.integers(0, n, n_queries)]
               + 0.1 * rng.normal(size=(n_queries, dim)).astype(np.float32))
    return x, queries


def kernel_cases(dev: torch.device, b: int, n: int, d: int):
    """(name, kwargs for partial_min_scan) at the flat-serve shape."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, d), generator=g, device=dev)
    q = x[:b] + 0.1 * torch.randn((b, d), generator=g, device=dev)
    xn = torch.nn.functional.normalize(x, dim=1)
    qn_ = torch.nn.functional.normalize(q, dim=1)
    mask = (torch.rand(n, generator=g, device=dev) >= 0.1).float()
    cases = []
    for name, tab, qq, metric, extra in (
            ("l2", x, q, MetricType.EUCLIDEAN, {}),
            ("cosine", xn, qn_, MetricType.COSINE, {}),
            ("dot", x, q, MetricType.DOT_PRODUCT, {}),
            ("l2_mask_nvalid", x, q, MetricType.EUCLIDEAN,
             {"mask": mask, "n_valid": n - 5000}),
            ("l2_exclude_self", x, x[4096:4096 + b].clone(),
             MetricType.EUCLIDEAN, {"exclude_self": True, "q_base": 4096})):
        tab16 = tab.to(torch.bfloat16)
        kw = {"queries": qq.to(torch.bfloat16), "q_norms": (qq * qq).sum(1),
              "q_base": extra.get("q_base", 0), "table": tab16,
              "norms": (tab16.float() ** 2).sum(1), "metric": int(metric),
              "n_valid": extra.get("n_valid", n),
              "exclude_self": extra.get("exclude_self", False),
              "mask": extra.get("mask")}
        cases.append((name, kw))
    return cases


def compare_scan(dev: torch.device, name: str, kw):
    """partial_min_scan (the kernel) against partial_min_scan_ref on the
    same inputs; returns (max abs error, kernel ms, plain ms)."""
    vk, ik = partial_min.partial_min_scan(**kw)
    vp, ip = partial_min.partial_min_scan_ref(**kw)
    torch.cuda.synchronize()
    scale = float(kw["q_norms"].max() + kw["norms"].max())
    atol = VAL_ATOL_SCALE * scale
    if vk.shape != vp.shape or ik.shape != ip.shape:
        raise AssertionError(f"{name}: shapes {vk.shape} vs {vp.shape}")
    if not torch.allclose(vk, vp, rtol=VAL_RTOL, atol=atol):
        bad = ~torch.isclose(vk, vp, rtol=VAL_RTOL, atol=atol)
        raise AssertionError(f"{name}: {int(bad.sum())} values differ "
                             f"beyond rtol {VAL_RTOL} atol {atol:.3g}")
    fin = torch.isfinite(vp)
    err = float((vk[fin] - vp[fin]).abs().max()) if fin.any() else 0.0
    # Ids may differ only where the group's two candidates tie within
    # the tolerance (the sums' order decides which one wins).
    diff = ik != ip
    near = (vk - vp).abs() <= atol + VAL_RTOL * vp.abs()
    if bool((diff & ~near).any()):
        raise AssertionError(f"{name}: ids differ away from near-ties")
    live = ik[torch.isfinite(vk)]
    if kw["exclude_self"]:
        b = kw["queries"].shape[0]
        rows_self = kw["q_base"] + torch.arange(b, device=dev,
                                                dtype=torch.int32)
        if bool((ik == rows_self[:, None]).any()):
            raise AssertionError(f"{name}: exclude_self kept a query's row")
    if kw["mask"] is not None:
        excluded = (kw["mask"] == 0).nonzero().flatten()
        if bool(torch.isin(live, excluded.to(torch.int32)).any()):
            raise AssertionError(f"{name}: masked rows survived")
    if bool((live >= kw["n_valid"]).any()):
        raise AssertionError(f"{name}: rows past n_valid survived")
    ms = cuda_ms(lambda: partial_min.partial_min_scan(**kw))
    plain_ms = cuda_ms(lambda: partial_min.partial_min_scan_ref(**kw))
    b, d = kw["queries"].shape
    n = kw["table"].shape[0]
    bound, bound_by = partial_min.bound_ms(*partial_min.scan_cost(b, n, d))
    # Context only, not the same function: the bf16 matmul that writes the
    # [B, N] scores the scan never stores. The port never calls it.
    q, tab = kw["queries"], kw["table"]
    gemm_ms = cuda_ms(lambda: torch.matmul(q, tab.T))
    torch.cuda.empty_cache()
    out = {"case": name, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": bound_by, "pct_of_bound": 100.0 * bound / ms,
           "gemm_ms": gemm_ms, "max_abs_err": err, "atol": atol,
           "id_mismatch": int(diff.sum())}
    log(f"kernel partial_min {name}: " + json.dumps(out))
    return out


def check_kernel(dev: torch.device, b: int, n: int, d: int):
    """Kernel vs plain version per flat-serve case; returns {case: the
    numbers of compare_scan}."""
    return {name: compare_scan(dev, name, kw)
            for name, kw in kernel_cases(dev, b, n, d)}


def check_knn_kernel(dev: torch.device):
    """The scan at one exact-KNN block: KNN_B table rows as queries against
    the whole KNN_N-row bf16 table, exclude_self, n_valid = KNN_N_VALID."""
    g = torch.Generator(device=dev).manual_seed(1)
    tab = torch.randn((KNN_N, 128), generator=g,
                      device=dev).to(torch.bfloat16)
    norms = (tab.float() ** 2).sum(1)
    q = slice(KNN_Q_BASE, KNN_Q_BASE + KNN_B)
    kw = {"queries": tab[q], "q_norms": norms[q], "q_base": KNN_Q_BASE,
          "table": tab, "norms": norms,
          "metric": int(MetricType.EUCLIDEAN), "n_valid": KNN_N_VALID,
          "exclude_self": True, "mask": None}
    out = compare_scan(dev, "knn_block", kw)
    del tab, norms, kw
    torch.cuda.empty_cache()
    return out


def check_gather(dev: torch.device):
    """gather_rows (the kernel) against gather_rows_ref, bit for bit, at
    every row width the main path gathers; ids include -1 and ids past the
    end (clamped). Returns {case: {ms, plain_ms, library_ms, host_us, ...}}."""
    g = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for name, dtype, shape, n_ids in gather.MAIN_PATH_SHAPES:
        n = shape[0]
        if dtype.is_floating_point:
            tab = torch.randn(shape, generator=g, device=dev).to(dtype)
        else:
            tab = torch.randint(-100, 100, shape, generator=g, device=dev,
                                dtype=dtype)
        ids = torch.randint(-2, n + 2, (n_ids,), generator=g,
                            device=dev, dtype=torch.int32)
        k = gather.gather_rows(tab, ids)
        p = gather.gather_rows_ref(tab, ids)
        torch.cuda.synchronize()
        if k.shape != p.shape or not torch.equal(k.view(torch.uint8),
                                                 p.view(torch.uint8)):
            raise AssertionError(f"gather {name}: kernel differs from the "
                                 "plain version")
        err = float((k.double() - p.double()).abs().max())
        row_bytes = k[0].numel() * k.element_size()
        del k, p
        # The library call: index_select on ids clamped beforehand.
        ids_c = ids.clamp(0, n - 1).long()
        calls = {"ms": lambda: gather.gather_rows(tab, ids),
                 "plain_ms": lambda: gather.gather_rows_ref(tab, ids),
                 "library_ms": lambda: tab.index_select(0, ids_c)}
        t = in_turns(calls, stream_ms, rounds=7)
        t.update(in_turns({"host_us": calls["ms"],
                           "library_host_us": calls["library_ms"]},
                          host_us, rounds=5))
        bound, bound_by = partial_min.bound_ms(
            0, gather.gather_cost(n_ids, row_bytes))
        out[name] = {**t, "bound_ms": bound, "bound_by": bound_by,
                     "pct_of_bound": 100.0 * bound / t["ms"],
                     "max_abs_err": err, "table": list(shape),
                     "dtype": str(dtype), "ids": n_ids,
                     "row_bytes": row_bytes}
        log(f"kernel gather_rows {name}: " + json.dumps(out[name]))
        del tab, ids, ids_c, calls
        torch.cuda.empty_cache()
    return out


def oracle_top10(x: np.ndarray, q: np.ndarray, k: int = 10) -> np.ndarray:
    """Exact top-k: f32 matmul shortlist of 64, then f64 re-rank."""
    xn = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    out = np.empty((q.shape[0], k), dtype=np.int64)
    for s in range(0, q.shape[0], 256):
        qc = q[s:s + 256]
        d = xn[None, :] - 2.0 * (qc @ x.T)
        cand = np.argpartition(d, 64, axis=1)[:, :64]
        exact = ((x[cand].astype(np.float64) - qc[:, None, :]) ** 2).sum(2)
        order = np.argsort(exact, axis=1, kind="stable")[:, :k]
        out[s:s + 256] = np.take_along_axis(cand, order, axis=1)
    return out


def run_slice(dev: torch.device, n: int, dim: int, n_q: int, batch: int):
    """The flat-serve slice through the library API. Returns its numbers."""
    x, queries = make_clustered(n, dim, n_q, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        assert vdb.load_db("smoke", os.path.join(tmp, "smoke"),
                           vector_scale=n) == 0
        vdb.use_db("smoke")
        vdb.create_table("docs", [
            {"name": "ID", "dataType": "INT", "primaryKey": True},
            {"name": "Doc", "dataType": "STRING"},
            {"name": "Emb", "dataType": "VECTOR_FLOAT", "dimensions": dim,
             "metricType": "EUCLIDEAN"}])
        t0 = time.perf_counter()
        code, res = vdb.insert_columns("docs", {
            "ID": np.arange(n), "Doc": [f"doc{i}" for i in range(n)],
            "Emb": x})
        ingest_s = time.perf_counter() - t0
        if code != 0 or res["inserted"] != n:
            raise AssertionError(f"insert_columns: {code} {res}")
        assert vdb.update_config({"QueryGroupSize": 4}) == 0

        # Single queries through the public API.
        probe = [42, 7, n // 2, n - 1]
        want = oracle_top10(x, x[probe])
        reset_counts()
        for i, row in enumerate(probe):
            code, hits = vdb.query("docs", "Emb", x[row].tolist(),
                                   ["ID", "Doc"], 10, "", True)
            got = [h["ID"] for h in hits]
            if code != 0 or got[0] != row or set(got) != set(want[i]):
                raise AssertionError(f"query X[{row}]: {got} vs "
                                     f"{want[i].tolist()}")
        lo, row = n // 5, n // 4  # "ID < 50000" at the full size
        code, hits = vdb.query("docs", "Emb", x[row].tolist(), ["ID"], 10,
                               f"ID < {lo}", True)
        want_f = oracle_top10(x[:lo], x[row:row + 1])[0]
        single_counts = read_counts()
        got_f = [h["ID"] for h in hits]
        if code != 0 or set(got_f) != set(want_f.tolist()):
            raise AssertionError(f"filtered query: {got_f} vs {want_f}")
        log(f"slice single queries ok: X[42] -> ID 42 first, "
            f"filter 'ID < {lo}' matches the oracle")

        table = vdb._db.databases["smoke"].tables["docs"]
        valid = table.segment.valid_mask()
        store = table.segment.device_view("Emb")
        if not store.buf.is_cuda:
            raise AssertionError("device store is not on the GPU")
        # Warm-up on one super-chunk (f32 mirror, mask upload), then the
        # measured pass over all queries with the launch counter at 0.
        table.grouped_dense_search("Emb", queries[:batch * 4 + 1], valid,
                                   MetricType.EUCLIDEAN, 10, batch=batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        ids, dists = table.grouped_dense_search(
            "Emb", queries, valid, MetricType.EUCLIDEAN, 10, batch=batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        if counts["partial_min"] <= 0:
            raise AssertionError("grouped search never launched the kernel")
        if ids.shape != (n_q, 10) or not np.isfinite(dists).all():
            raise AssertionError(f"grouped result shape {ids.shape}")
        n_rec = min(2048, n_q)
        want = oracle_top10(x, queries[:n_rec])
        recall = float(np.mean([len(set(a) & set(b)) / 10.0
                                for a, b in zip(ids[:n_rec], want)]))
        if recall < RECALL_FLOOR:
            raise AssertionError(f"recall@10 {recall} < {RECALL_FLOOR}")
        exact = ((x[ids] - queries[:, None, :]) ** 2).sum(2)
        if not np.allclose(dists, exact, rtol=1e-5, atol=0.0):
            raise AssertionError("grouped distances differ from f32 "
                                 "recomputation")

        # The same pass with a device filter keeping half the rows: the
        # partial-min kernel reads the composed device mask.
        half = n // 2
        keep = np.arange(n) < half
        filtered = grouped_filtered(
            table, f"ID < {half}", queries, valid, batch, x, keep,
            oracle_top10(x[:half], queries[:min(1024, n_q)]), RECALL_FLOOR)
        if filtered["counts"]["partial_min"] <= 0:
            raise AssertionError("filtered flat-serve never launched "
                                 "partial-min")
        log(f"slice filtered grouped: {json.dumps(filtered)}")

        # The int8 query wire forced: partial-min scans the wire's values.
        int8 = wire_pass(table, "int8", queries, valid, batch, x, want,
                         "partial_min")
        assert vdb.update_config({"QueryDtype": "auto"}) == 0
        log(f"slice grouped QueryDtype=int8: {json.dumps(int8)}")
        vdb.unload_db("smoke")
    return {"rows": n, "dim": dim, "queries": n_q, "batch": batch,
            "group": 4, "recall_at_10": recall, "qps": n_q / wall,
            "wall_s": wall, "counts": counts, "single_counts": single_counts,
            "peak_bytes": peak, "ingest_s": ingest_s, "filtered": filtered,
            "int8": int8}


def device_filter(table, flt: str):
    """Table._device_filter for a filter string (the library path)."""
    ctx = table._device_filter(parse_expr(flt, table.field_type_map),
                               table._compile_filter(flt))
    if ctx is None:
        raise AssertionError(f"{flt!r} did not compile to a device filter")
    return ctx


def grouped_filtered(table, flt: str, queries, valid, batch: int,
                     x: np.ndarray, keep: np.ndarray, want: np.ndarray,
                     floor: float):
    """grouped_dense_search with the device filter `flt`, launch counts at
    0 just before and read just after (after one warm-up call); every row
    must pass `keep`, recall@10 against `want` (the masked oracle of the
    first len(want) queries) reach `floor`, distances be exact."""
    ctx = device_filter(table, flt)
    table.grouped_dense_search("Emb", queries[:batch * 4 + 1], valid,
                               MetricType.EUCLIDEAN, 10, batch=batch,
                               mask_cacheable=True, filter_ctx=ctx)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ids, dists = table.grouped_dense_search(
        "Emb", queries, valid, MetricType.EUCLIDEAN, 10, batch=batch,
        mask_cacheable=True, filter_ctx=ctx)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"filter": flt, "selectivity": float(keep.mean()),
           "qps": queries.shape[0] / wall, "wall_s": wall,
           "counts": read_counts()}
    if ids.shape != (queries.shape[0], 10) or not np.isfinite(dists).all():
        raise AssertionError(f"{flt}: result shape {ids.shape}")
    if not keep[ids].all():
        raise AssertionError(f"{flt}: a returned row fails the filter")
    out["recall_at_10"] = float(np.mean(
        [len(set(a) & set(b)) / 10.0 for a, b in zip(ids, want)]))
    if out["recall_at_10"] < floor:
        raise AssertionError(f"{flt}: recall@10 {out['recall_at_10']} < "
                             f"{floor}")
    exact = ((x[ids] - queries[:, None, :]) ** 2).sum(2)
    if not np.allclose(dists, exact, rtol=1e-5, atol=0.0):
        raise AssertionError(f"{flt}: distances differ from f32 "
                             "recomputation")
    return out


def oracle_top10_gpu(x_dev: torch.Tensor, x: np.ndarray, q: np.ndarray,
                     k: int = 10) -> np.ndarray:
    """Exact top-k by a plain f32 matmul shortlist of 64 on the card (TF32
    off), then an f64 re-rank on the host."""
    xn = (x_dev * x_dev).sum(1)
    out = np.empty((q.shape[0], k), dtype=np.int64)
    for s in range(0, q.shape[0], 256):
        qc = q[s:s + 256]
        d = xn[None, :] - 2.0 * (torch.from_numpy(qc).to(x_dev.device)
                                 @ x_dev.T)
        cand = torch.topk(d, 64, dim=1, largest=False)[1].cpu().numpy()
        exact = ((x[cand].astype(np.float64) - qc[:, None, :]) ** 2).sum(2)
        order = np.argsort(exact, axis=1, kind="stable")[:, :k]
        out[s:s + 256] = np.take_along_axis(cand, order, axis=1)
    return out


def run_graph(dev: torch.device, n: int, dim: int, n_q: int, batch: int):
    """The graph path through the library API: ingest, vdb.rebuild() (the
    partial-min kernel builds the KNN graph), single queries through
    vdb.query, grouped queries with FusedTraversal auto and off and with a
    device filter (the row gather kernel serves traversal); then the REST
    server in-process and the CLI over the same database. Returns its
    numbers."""
    x, queries = make_clustered(n, dim, n_q, seed=0)
    rng = np.random.default_rng(1)
    cat = rng.integers(0, 10, n)
    price = rng.uniform(0.0, 100.0, n)
    out = {"rows": n, "dim": dim, "queries": n_q, "batch": batch,
           "group": 4}
    with tempfile.TemporaryDirectory() as tmp:
        assert vdb.load_db("graph", os.path.join(tmp, "graph"),
                           vector_scale=n + 2 * REST_INSERT) == 0
        vdb.use_db("graph")
        vdb.create_table("docs", [
            {"name": "ID", "dataType": "INT", "primaryKey": True},
            {"name": "cat", "dataType": "INT"},
            {"name": "price", "dataType": "DOUBLE"},
            {"name": "Emb", "dataType": "VECTOR_FLOAT", "dimensions": dim,
             "metricType": "EUCLIDEAN"}])
        t0 = time.perf_counter()
        code, res = vdb.insert_columns("docs", {"ID": np.arange(n),
                                                "cat": cat, "price": price,
                                                "Emb": x})
        out["ingest_s"] = time.perf_counter() - t0
        if code != 0 or res["inserted"] != n:
            raise AssertionError(f"insert_columns: {code} {res}")
        assert vdb.update_config({"QueryGroupSize": 4,
                                  "FusedTraversal": "auto"}) == 0
        table = vdb._db.databases["graph"].tables["docs"]

        # Build: the counts at 0 just before rebuild(), read just after.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        code = vdb.rebuild()
        torch.cuda.synchronize()
        out["rebuild_s"] = time.perf_counter() - t0
        out["build_counts"] = read_counts()
        out["rebuild_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        graph = table.graphs["Emb"]
        if code != 0 or graph is None or graph.num_rows != n:
            raise AssertionError(f"rebuild: code {code}, graph {graph}")
        if out["build_counts"]["partial_min"] <= 0:
            raise AssertionError("the build never launched partial-min")
        out["build_phase_s"] = graph.build_seconds
        out["tuned"] = {k: table._tuned_report["Emb"][k]
                        for k in ("ef", "iters", "recall", "id_recall",
                                  "ood_recall", "qdtype",
                                  "qdtype_wire_recall")}
        out["tune_rungs"] = len(table._tuned_report["Emb"]["tried"])
        log(f"graph build phases (s): {json.dumps(graph.build_seconds)}")
        log(f"graph auto-tune: {json.dumps(out['tuned'])}")

        # Single queries through the public API (fused auto).
        x_dev = torch.from_numpy(x).to(dev)
        probe = [42, 7, n // 2, n - 1]
        want = oracle_top10_gpu(x_dev, x, x[probe])
        reset_counts()
        for i, row in enumerate(probe):
            code, hits = vdb.query("docs", "Emb", x[row].tolist(), ["ID"],
                                   10, "", True)
            got = [h["ID"] for h in hits]
            if code != 0 or got[0] != row or \
                    len(set(got) & set(want[i].tolist())) < 9:
                raise AssertionError(f"query X[{row}]: {got} vs "
                                     f"{want[i].tolist()}")
        lat = []
        for i in range(220):
            t0 = time.perf_counter()
            vdb.query("docs", "Emb", queries[i].tolist(), ["ID"], 10, "",
                      True)
            lat.append(time.perf_counter() - t0)
        out["single_counts"] = read_counts()
        lat = np.asarray(lat[20:]) * 1e3
        out["single_ms"] = {"p50": float(np.percentile(lat, 50)),
                            "p90": float(np.percentile(lat, 90)),
                            "p99": float(np.percentile(lat, 99))}
        log(f"graph single queries (ms): {json.dumps(out['single_ms'])}")

        # Grouped queries, fused and split traversal; oracles of the
        # filtered and REST phases are taken now, while x is on the card.
        n_rec = min(2048, n_q)
        want = oracle_top10_gpu(x_dev, x, queries[:n_rec])
        keep_cat = cat < 5
        want_cat = masked_oracle_gpu(x_dev, x, queries[:n_rec], keep_cat)
        rest_wants = {}
        for fi, (name, _, pred) in enumerate(REST_FILTERS):
            qf = queries[fi:REST_QUERIES:len(REST_FILTERS)]
            rest_wants[name] = (
                oracle_top10_gpu(x_dev, x, qf) if pred is None
                else masked_oracle_gpu(x_dev, x, qf, pred(cat, price)))
        del x_dev
        torch.cuda.empty_cache()
        valid = table.segment.valid_mask()
        out["grouped"] = {}
        for mode in ("auto", "off"):
            assert vdb.update_config({"FusedTraversal": mode}) == 0
            table.grouped_dense_search("Emb", queries[:batch * 4 + 1], valid,
                                       MetricType.EUCLIDEAN, 10, batch=batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            t0 = time.perf_counter()
            ids, dists = table.grouped_dense_search(
                "Emb", queries, valid, MetricType.EUCLIDEAN, 10, batch=batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            r = {"qps": n_q / wall, "wall_s": wall, "counts": read_counts(),
                 "peak_bytes": torch.cuda.max_memory_allocated(dev)}
            if r["counts"]["gather"] <= 0:
                raise AssertionError(f"traversal ({mode}) never launched "
                                     "the gather kernel")
            if ids.shape != (n_q, 10) or not np.isfinite(dists).all():
                raise AssertionError(f"grouped result shape {ids.shape}")
            r["recall_at_10"] = float(np.mean(
                [len(set(a) & set(b)) / 10.0
                 for a, b in zip(ids[:n_rec], want)]))
            if r["recall_at_10"] < RECALL_FLOOR:
                raise AssertionError(f"graph recall@10 ({mode}) "
                                     f"{r['recall_at_10']} < {RECALL_FLOOR}")
            exact = ((x[ids] - queries[:, None, :]) ** 2).sum(2)
            if not np.allclose(dists, exact, rtol=1e-5, atol=0.0):
                raise AssertionError(f"graph distances ({mode}) differ from "
                                     "f32 recomputation")
            out["grouped"][mode] = r
            log(f"graph grouped FusedTraversal={mode}: {json.dumps(r)}")

        # Grouped queries with a device filter (about half the rows): the
        # grouped graph program with a widened beam.
        assert vdb.update_config({"FusedTraversal": "auto"}) == 0
        out["filtered"] = grouped_filtered(
            table, "cat < 5", queries, valid, batch, x, keep_cat, want_cat,
            WIDENED_RECALL_FLOOR)
        if out["filtered"]["counts"]["gather"] <= 0:
            raise AssertionError("filtered grouped graph pass never "
                                 "launched the gather kernel")
        log(f"graph filtered grouped: {json.dumps(out['filtered'])}")

        # Where the device time goes (FusedTraversal auto): one grouped
        # program of 4 x batch queries and 20 single queries, profiled.
        out["profile"] = {
            "grouped": device_profile(lambda: table.grouped_dense_search(
                "Emb", queries[:batch * 4], valid, MetricType.EUCLIDEAN, 10,
                batch=batch)),
            "single": device_profile(lambda: [
                vdb.query("docs", "Emb", queries[i].tolist(), ["ID"], 10, "",
                          True) for i in range(20)])}
        log(f"graph profile: {json.dumps(out['profile'])}")

        # Query wires: each forced, then "auto" after a fresh tuning
        # (FusedTraversal auto), on the grouped graph program.
        out["wires"] = {w: wire_pass(table, w, queries, valid, batch, x,
                                     want, "gather") for w in GRAPH_WIRES}
        assert vdb.update_config({"QueryDtype": "auto"}) == 0
        t0 = time.perf_counter()
        rep = table.tune_search_ef(
            target_recall=table.config.auto_tune_target_recall)["Emb"]
        out["wire_tune"] = {"tune_s": time.perf_counter() - t0,
                            **{k: rep[k] for k in (
                                "qdtype", "ef", "iters", "recall",
                                "qdtype_wire_recall")}}
        out["wires"]["auto"] = wire_pass(table, "auto", queries, valid,
                                         batch, x, want, "gather")
        # The tuner's gate (the JAX package's rule): the per-batch path on
        # queries the host rounded, re-ranked against the rounded values,
        # where the grouped path re-ranks against the f32 query.
        for w in GRAPH_WIRES:
            ids, _ = table.batch_dense_search(
                "Emb", qwire.roundtrip(queries[:n_rec], w), valid,
                MetricType.EUCLIDEAN, 10, mask_cacheable=True)
            out["wires"][w]["gate_recall_at_10"] = float(np.mean(
                [len(set(a) & set(b)) / 10.0 for a, b in zip(ids, want)]))
        for w, r in out["wires"].items():
            log(f"graph grouped QueryDtype={w}: {json.dumps(r)}")
        log(f"graph wire tuning: {json.dumps(out['wire_tune'])}")

        out["rest"], x_new = run_rest(table, x, queries, cat, price,
                                      rest_wants)
        log(f"rest: {json.dumps(out['rest'])}")
        out["cli"] = run_cli(tmp, table, np.concatenate([x, x_new]),
                             np.concatenate([price,
                                             np.arange(len(x_new)) % 100]))
        log(f"cli: {json.dumps(out['cli'])}")
        vdb.unload_db("graph")
    return out


def masked_oracle_gpu(x_dev: torch.Tensor, x: np.ndarray, q: np.ndarray,
                      keep: np.ndarray, k: int = 10) -> np.ndarray:
    """oracle_top10_gpu over the rows where `keep` holds, as global ids."""
    rows = np.nonzero(keep)[0]
    sub = x_dev[torch.from_numpy(rows).to(x_dev.device)]
    return rows[oracle_top10_gpu(sub, x[rows], q, k)]


def _post(conn: http.client.HTTPConnection, path: str, body=None):
    """One request on a kept-alive connection -> (status, JSON, seconds)."""
    data = json.dumps(body).encode() if body is not None else b""
    t0 = time.perf_counter()
    conn.request("POST", path, body=data,
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    raw = r.read()
    return r.status, json.loads(raw), time.perf_counter() - t0


def _get(port: int, path: str, timeout: float = 30.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _query_body(q: np.ndarray, flt: str, limit: int = 10):
    return {"table": "docs", "queryField": "Emb", "queryVector": q.tolist(),
            "limit": limit, "response": ["ID"], "withDistance": True,
            "filter": flt}


def run_rest(table, x: np.ndarray, queries: np.ndarray, cat: np.ndarray,
             price: np.ndarray, wants) -> Tuple[dict, np.ndarray]:
    """The REST server in-process over the database that holds the graph:
    rest.create_server(0, db) on a daemon thread, the device executor loop
    on a second one. REST_QUERIES single queries from REST_CLIENTS client
    threads, spread evenly over REST_FILTERS and checked against masked
    oracles; then an insert over HTTP (the new rows are served from the
    flat tail) and POST /api/rebuild. Returns its numbers and the inserted
    vectors."""
    server = vdb._db
    n = table.segment.record_number
    httpd = rest.create_server(0, server, host="127.0.0.1")
    port = httpd.server_address[1]
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    exec_thread = threading.Thread(target=server.device_executor.run_loop,
                                   daemon=True)
    http_thread.start()
    exec_thread.start()
    path = "/api/graph/data/query"
    out = {"port_requests": REST_QUERIES, "clients": REST_CLIENTS}
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        for fi, (_, flt, _) in enumerate(REST_FILTERS):  # warm-up
            for i in range(4):
                st, body, _ = _post(conn, path, _query_body(
                    queries[-1 - 4 * fi - i], flt))
                if st != 200:
                    raise AssertionError(f"REST warm-up {flt!r}: {st} {body}")
        results = [None] * REST_QUERIES
        errors = []

        def client(tid: int):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            try:
                for i in range(tid, REST_QUERIES, REST_CLIENTS):
                    flt = REST_FILTERS[i % len(REST_FILTERS)][1]
                    results[i] = _post(c, path, _query_body(queries[i], flt))
            except Exception as e:  # reported by the caller below
                errors.append(repr(e))
            finally:
                c.close()

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(REST_CLIENTS)]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        out["counts"] = read_counts()
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"REST clients failed: {errors[:3]}")
        out["qps"] = REST_QUERIES / wall
        out["wall_s"] = wall
        if out["counts"]["gather"] <= 0:
            raise AssertionError("REST queries never launched the gather "
                                 "kernel")
        out["filters"] = {}
        for fi, (name, flt, pred) in enumerate(REST_FILTERS):
            idx = list(range(fi, REST_QUERIES, len(REST_FILTERS)))
            lat_ms = np.asarray([results[i][2] for i in idx]) * 1e3
            hits, checked = 0, 0
            for j, i in enumerate(idx):
                st, body, _ = results[i]
                if st != 200:
                    raise AssertionError(f"REST {flt!r}: {st} {body}")
                ids = np.asarray([r["ID"] for r in body["result"]], np.int64)
                d = np.asarray([r["@distance"] for r in body["result"]])
                if len(ids) != 10:
                    raise AssertionError(f"REST {flt!r}: {len(ids)} rows")
                if pred is not None and not pred(cat[ids], price[ids]).all():
                    raise AssertionError(f"REST {flt!r}: a row fails the "
                                         "filter")
                exact = ((x[ids] - queries[i]) ** 2).sum(1)
                if not np.allclose(d, exact, rtol=1e-5, atol=0.0):
                    raise AssertionError(f"REST {flt!r}: @distance differs "
                                         "from f32 recomputation")
                hits += len(set(ids.tolist()) & set(wants[name][j].tolist()))
                checked += 10
            r = {"filter": flt,
                 "selectivity": (1.0 if pred is None
                                 else float(pred(cat, price).mean())),
                 "recall_at_10": hits / checked,
                 "p50_ms": float(np.percentile(lat_ms, 50)),
                 "p99_ms": float(np.percentile(lat_ms, 99))}
            floor = (RECALL_FLOOR if name in ("none", "price<5")
                     else WIDENED_RECALL_FLOOR)
            if r["recall_at_10"] < floor:
                raise AssertionError(f"REST {flt!r}: recall@10 "
                                     f"{r['recall_at_10']} < {floor}")
            out["filters"][name] = r
            log(f"rest {name}: {json.dumps(r)}")

        # Insert over HTTP: near-copies of existing rows, found first from
        # the flat tail before the rebuild.
        rng = np.random.default_rng(2)
        x_new = (x[rng.integers(0, n, REST_INSERT)] + 0.05 * rng.normal(
            size=(REST_INSERT, x.shape[1]))).astype(np.float32)
        data = [{"ID": n + j, "cat": j % 10, "price": float(j % 100),
                 "Emb": x_new[j].tolist()} for j in range(REST_INSERT)]
        torch.cuda.synchronize()
        reset_counts()
        st, body, secs = _post(conn, "/api/graph/data/insert",
                               {"table": "docs", "data": data})
        if st != 200 or body["result"]["inserted"] != REST_INSERT:
            raise AssertionError(f"REST insert: {st} {body}")
        out["insert_s"] = secs
        if table.graphs["Emb"].num_rows != n:
            raise AssertionError("the graph changed before the rebuild")
        for j in range(0, REST_INSERT, REST_INSERT // 16):
            st, body, _ = _post(conn, path, _query_body(x_new[j], ""))
            if st != 200 or body["result"][0]["ID"] != n + j:
                raise AssertionError(f"tail query of new row {n + j}: "
                                     f"{st} {body}")
        torch.cuda.synchronize()
        out["insert_counts"] = read_counts()

        # POST /api/rebuild: DBServer.rebuild, as the rebuild thread calls
        # it; the graph then covers every row.
        torch.cuda.synchronize()
        reset_counts()
        st, body, secs = _post(conn, "/api/rebuild")
        torch.cuda.synchronize()
        out["rebuild_s"] = secs
        out["rebuild_counts"] = read_counts()
        graph = table.graphs["Emb"]
        if st != 200 or graph is None or graph.num_rows != n + REST_INSERT:
            raise AssertionError(f"REST rebuild: {st} {body}")
        if out["rebuild_counts"]["partial_min"] <= 0:
            raise AssertionError("REST rebuild never launched partial-min")
        st, body, _ = _post(conn, path, _query_body(x_new[1], ""))
        if st != 200 or body["result"][0]["ID"] != n + 1:
            raise AssertionError(f"query after rebuild: {st} {body}")
        conn.close()
    finally:
        server.device_executor.stop()
        exec_thread.join(timeout=60)
        httpd.shutdown()
        httpd.server_close()
    return out, x_new


def run_cli(tmp: str, table, x: np.ndarray, price: np.ndarray) -> dict:
    """`python -m vectordb_tpu_torch -p <free port> -r false` in a child
    process, as users start it: wait for GET /state, POST /api/load a dump
    of the database, a query of X[42], a filtered query against the
    oracle, GET statistics, then SIGINT and exit code 0, with the card
    named in its log. `x` and `price` cover every row of the table. Only
    the child's own PID is signalled."""
    n_total = table.segment.record_number
    dump = os.path.join(tmp, "dump")
    if vdb.dump_db("graph", dump) != 0:
        raise AssertionError("dump_db failed")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    log_path = os.path.join(tmp, "cli.log")
    out = {}
    with open(log_path, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "vectordb_tpu_torch", "-p", str(port),
             "-r", "false"], stdout=f, stderr=subprocess.STDOUT, cwd=root,
            env=dict(os.environ, PYTHONPATH=root))
    try:
        t0 = time.perf_counter()
        while True:
            if proc.poll() is not None:
                raise AssertionError("the CLI exited while starting")
            try:
                if _get(port, "/state", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            if time.perf_counter() - t0 > CLI_BOOT_S:
                raise AssertionError(f"no GET /state in {CLI_BOOT_S} s")
            time.sleep(0.5)
        out["boot_s"] = time.perf_counter() - t0
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        st, body, secs = _post(conn, "/api/load", {
            "name": "cli", "path": dump,
            "vectorScale": n_total + REST_INSERT})
        if st != 200:
            raise AssertionError(f"CLI load: {st} {body}")
        out["load_s"] = secs
        path = "/api/cli/data/query"
        st, body, secs = _post(conn, path, _query_body(x[42], ""))
        if st != 200 or body["result"][0]["ID"] != 42:
            raise AssertionError(f"CLI query X[42]: {st} {body}")
        out["first_query_s"] = secs
        rows = np.nonzero(price < 50.0)[0]
        want = rows[oracle_top10(x[rows], x[7:8])[0]]
        st, body, _ = _post(conn, path, _query_body(x[7], "price < 50.0"))
        got = [r["ID"] for r in body.get("result", [])]
        if st != 200 or set(got) != set(want.tolist()):
            raise AssertionError(f"CLI filtered query: {got} vs {want}")
        conn.close()
        st, body = _get(port, "/api/cli/statistics")
        if st != 200 or body["result"]["tables"][0]["totalRecordCount"] \
                != n_total:
            raise AssertionError(f"CLI statistics: {st} {body}")
        proc.send_signal(signal.SIGINT)
        out["exit_code"] = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    with open(log_path) as f:
        text = f.read()
    if out.get("exit_code") != 0:
        raise AssertionError(f"CLI exit code {out.get('exit_code')}:\n"
                             + text[-2000:])
    name = torch.cuda.get_device_name(0)
    line = next((ln for ln in text.splitlines()
                 if "serving device: " + name in ln), None)
    if line is None:
        raise AssertionError("the CLI log names no CUDA card:\n"
                             + text[-2000:])
    out["device_line"] = line.strip()
    return out


def make_sparse(dev: torch.device, n: int, vocab: int, seed: int = 3):
    """SPLADE-like rows over a `vocab`-term vocabulary, generated on the
    card in bulk: SPARSE_DRAWS Zipf(1.1) term draws a row (about 120
    distinct terms), each term id mapped through a fixed permutation of the
    vocabulary, sorted and deduplicated; values gamma(1, 1). Returns host
    CSR arrays (indices int64, values f32, offsets int64)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    p = torch.arange(1, vocab + 1, dtype=torch.float64, device=dev) ** -1.1
    cdf = torch.cumsum(p, 0)
    cdf /= cdf[-1].clone()
    perm = torch.randperm(vocab, generator=g, device=dev)
    idx_parts, counts = [], []
    for s in range(0, n, 100_000):
        m = min(100_000, n - s)
        u = torch.rand((m, SPARSE_DRAWS), generator=g, device=dev,
                       dtype=torch.float64)
        t = perm[torch.searchsorted(cdf, u).clamp_(max=vocab - 1)]
        t = torch.sort(t, dim=1).values
        keep = torch.ones_like(t, dtype=torch.bool)
        keep[:, 1:] = t[:, 1:] != t[:, :-1]
        idx_parts.append(t[keep].cpu())
        counts.append(keep.sum(1).cpu())
    indices = torch.cat(idx_parts).numpy().astype(np.int64)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(torch.cat(counts).numpy(), out=offsets[1:])
    values = torch.empty(len(indices), dtype=torch.float32,
                         device=dev).exponential_(generator=g).cpu().numpy()
    return indices, values, offsets


def sparse_queries(indices, offsets, n_q: int, rng, terms: int = 32):
    """Queries of `terms` terms of a random stored row (rows with at least
    that many), values drawn again from gamma(1, 1), as REST-style dicts."""
    out = []
    lens = np.diff(offsets)
    rows = np.nonzero(lens >= terms)[0]
    for r in rng.choice(rows, n_q, replace=False):
        row = indices[offsets[r]:offsets[r + 1]]
        pick = np.sort(rng.choice(len(row), terms, replace=False))
        out.append({"indices": row[pick].tolist(),
                    "values": rng.gamma(1.0, 1.0, terms).astype(
                        np.float32).tolist()})
    return out


def _query_dense(q: dict, vocab: int, dev) -> torch.Tensor:
    col = torch.zeros(vocab, dtype=torch.float64)
    col[torch.tensor(q["indices"])] = torch.tensor(q["values"],
                                                   dtype=torch.float64)
    return col.to(dev)


def sparse_oracle(csr: torch.Tensor, qs, vocab: int, k: int = 10,
                  rows_below: int = 0):
    """float64 inner products of every row with each query on the card (a
    torch.sparse_csr_tensor [N, vocab] f64 times a dense [vocab, B] f64
    block), independent of the port. Returns (top-k ids by largest inner
    product [B, k], the [N, B] inner products of the first block of 8);
    rows_below > 0 keeps only rows below it."""
    top, first = [], None
    for s in range(0, len(qs), 64):
        block = torch.stack([_query_dense(q, vocab, csr.device)
                             for q in qs[s:s + 64]], dim=1)
        ip = csr @ block
        if first is None:
            first = ip[:, :8].clone()
        if rows_below:
            ip[rows_below:] = -float("inf")
        top.append(torch.topk(ip, k, dim=0).indices.T.cpu().numpy())
        del ip
    return np.concatenate(top), first


def _sparse_rows_ip(q: dict, indices, values, offsets, rows):
    """float64 (sum q_i x_i, sum |q_i x_i|) of `rows` on the host."""
    qi = np.asarray(q["indices"], np.int64)
    qv = np.asarray(q["values"], np.float64)
    out = []
    for r in rows:
        ri = indices[offsets[r]:offsets[r + 1]]
        rv = values[offsets[r]:offsets[r + 1]].astype(np.float64)
        _, a, b = np.intersect1d(qi, ri, assume_unique=True,
                                 return_indices=True)
        prod = qv[a] * rv[b]
        out.append((float(prod.sum()), float(np.abs(prod).sum())))
    return out


def check_sparse_results(results, qs, want, indices, values, offsets,
                         what: str, rows_below: int = 0) -> float:
    """Every result row passes the filter, every @distance equals the f64
    -ip within rtol 1e-5 plus 1e-5 * sum |q_i x_i|; returns recall@10."""
    hits = 0
    for res, q, w in zip(results, qs, want):
        ids = [h["ID"] for h in res]
        if len(ids) != 10:
            raise AssertionError(f"{what}: {len(ids)} rows")
        if rows_below and max(ids) >= rows_below:
            raise AssertionError(f"{what}: a row fails the filter")
        for h, (ip, mag) in zip(res, _sparse_rows_ip(q, indices, values,
                                                     offsets, ids)):
            if abs(h["@distance"] + ip) > 1e-5 * abs(ip) + 1e-5 * mag:
                raise AssertionError(f"{what}: @distance {h['@distance']} "
                                     f"vs float64 {-ip}")
        hits += len(set(ids) & set(w.tolist()))
    recall = hits / (10.0 * len(results))
    if recall < RECALL_FLOOR:
        raise AssertionError(f"{what}: recall@10 {recall} < {RECALL_FLOOR}")
    return recall


def prefix_difference_ip(index, qd: torch.Tensor) -> torch.Tensor:
    """The JAX package's scoring (vectordb_tpu/ops/sparse.py:85-109) on the
    card, for comparison only: one f32 prefix sum over the column's
    products, differenced at the row boundaries."""
    idx, val, offs, _ = index._device_arrays()
    c = torch.cumsum(gather.gather_rows(qd, idx) * val, 0)
    c = torch.cat([c.new_zeros(1), c])
    offs = offs.long()
    return c[offs[1:]] - c[offs[:-1]]


def compare_csr_ip(idx, val, offs, q, what: str) -> float:
    """sparse.csr_ip (the kernel) against csr_ip_ref on the same inputs,
    within CSR_RTOL plus CSR_ATOL_SCALE x sum |q_i x_i| of each row; every
    empty row 0. Returns the max abs error."""
    k = sparse.csr_ip(idx, val, offs, q)
    p = sparse.csr_ip_ref(idx, val, offs, q)
    mag = sparse.csr_ip_ref(idx, val.abs(), offs, q.abs())
    torch.cuda.synchronize()
    if k.shape != p.shape:
        raise AssertionError(f"csr_ip {what}: shapes {k.shape} vs {p.shape}")
    bad = (k - p).abs() > CSR_RTOL * p.abs() + CSR_ATOL_SCALE * mag
    if bool(bad.any()):
        raise AssertionError(f"csr_ip {what}: {int(bad.sum())} rows differ "
                             "from the plain version beyond the tolerance")
    if bool((k[offs[1:] == offs[:-1]] != 0).any()):
        raise AssertionError(f"csr_ip {what}: an empty row is not 0")
    return float((k.double() - p.double()).abs().max()) if k.numel() else 0.0


def check_csr_ip(dev: torch.device, index, qd: torch.Tensor) -> dict:
    """The sparse scorer's kernel against its plain version at the main
    path's shape (the index's CSR arrays, a query's scatter over BERT's
    vocabulary with its trailing 0) and at a scatter too large for shared
    memory; at each, in turns: the kernel, the plain version and, at the
    main shape, the route it replaced (the gather kernel, the multiply and
    segment_reduce), the kernel's global-memory variant, and cuSPARSE's
    SpMV (torch.sparse_csr_tensor @ q on the int32 CSR: the library call
    for the same function, never called by the port). Also the host µs of
    a call on a 1,000-row column beside the gather operator's."""
    idx, val, offs, _ = index._device_arrays()
    n_rows, nnz = offs.numel() - 1, idx.numel()
    out = {"rows": n_rows, "nnz": nnz, "len_q": qd.numel(),
           "max_abs_err": compare_csr_ip(idx, val, offs, qd, "main")}
    op = sparse._operator()
    csr = torch.sparse_csr_tensor(offs.int(), idx, val,
                                  size=(n_rows, qd.numel()), device=dev)
    lib = csr @ qd
    want = sparse.csr_ip_ref(idx, val, offs, qd)
    out["library_max_abs_err"] = float((lib.double() - want.double())
                                       .abs().max())
    del lib, want

    def three_pass():
        contrib = gather.gather_rows(qd, idx)
        contrib.mul_(val)
        return torch.segment_reduce(contrib, "sum", offsets=offs)

    out.update(in_turns({
        "ms": lambda: sparse.csr_ip(idx, val, offs, qd),
        "plain_ms": lambda: sparse.csr_ip_ref(idx, val, offs, qd),
        "three_pass_ms": three_pass,
        "l2_variant_ms": lambda: op(idx, val, offs, qd, False),
        "library_ms": lambda: csr @ qd},
        lambda c: stream_ms(c, inner=10), rounds=7))
    del csr
    bound, bound_by = partial_min.bound_ms(
        0, sparse.csr_ip_cost(nnz, n_rows, qd.numel()))
    out.update(bound_ms=bound, bound_by=bound_by,
               pct_of_bound=100.0 * bound / out["ms"],
               l2_variant_pct_of_bound=100.0 * bound / out["l2_variant_ms"])
    log(f"kernel csr_ip main: {json.dumps(out)}")

    # A scatter too large for shared memory, on a column made on the card.
    g = torch.Generator(device=dev).manual_seed(5)
    lens = torch.randint(0, 240, (CSR_L2_ROWS,), generator=g, device=dev)
    offs2 = torch.zeros(CSR_L2_ROWS + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens, 0, out=offs2[1:])
    nnz2 = int(offs2[-1])
    idx2 = torch.randint(0, CSR_L2_TERMS, (nnz2,), generator=g, device=dev,
                         dtype=torch.int32)
    val2 = torch.empty(nnz2, device=dev).exponential_(generator=g)
    q2 = torch.zeros(CSR_L2_QMAX + 2, device=dev)
    terms = torch.randint(0, CSR_L2_QMAX, (2000,), generator=g, device=dev)
    q2[terms] = torch.rand(2000, generator=g, device=dev)
    q2[CSR_L2_QMAX] = 1.0
    if sparse.scatter_variant(q2.numel()) != "l2":
        raise AssertionError("the large scatter fits in shared memory")
    large = {"rows": CSR_L2_ROWS, "nnz": nnz2, "len_q": q2.numel(),
             "max_abs_err": compare_csr_ip(idx2, val2, offs2, q2, "l2")}
    large.update(in_turns({
        "ms": lambda: sparse.csr_ip(idx2, val2, offs2, q2),
        "plain_ms": lambda: sparse.csr_ip_ref(idx2, val2, offs2, q2)},
        lambda c: stream_ms(c, inner=10), rounds=5))
    bound2, _ = partial_min.bound_ms(
        0, sparse.csr_ip_cost(nnz2, CSR_L2_ROWS, q2.numel()))
    large.update(bound_ms=bound2, pct_of_bound=100.0 * bound2 / large["ms"])
    # Host µs of a call whose device time is short: 1,000 rows.
    small = offs2[:1001].clone()
    ids = torch.zeros(1000, dtype=torch.int32, device=dev)
    large.update(in_turns({
        "host_us_1000_rows": lambda: sparse.csr_ip(idx2, val2, small, qd),
        "gather_host_us_1000_ids": lambda: gather.gather_rows(qd, ids)},
        host_us, rounds=5))
    out["large_scatter"] = large
    log(f"kernel csr_ip large scatter: {json.dumps(large)}")
    del idx2, val2, offs2, q2
    torch.cuda.empty_cache()
    return out


def fuse(lists, weights, rerank: str, limit: int):
    """The hybrid fusion rule, recomputed from per-field (ids, distances)
    lists: rrf w / (60 + rank + 1) or weighted w * (1 - (d - lo) / (hi -
    lo)); an id's contributions summed in subquery order, the largest sums
    first (ties to the lower id), scores negated."""
    score = {}
    for (ids, d), w in zip(lists, weights):
        d = np.asarray(d, np.float64)
        if rerank == "weighted":
            fin = np.isfinite(d)
            lo, hi = (d[fin].min(), d[fin].max()) if fin.any() else (0, 0)
            span = (hi - lo) or 1.0
            contrib = (w * (1.0 - (d - lo) / span) if fin.any()
                       else np.zeros_like(d))
        else:
            contrib = w / (60.0 + np.arange(len(ids), dtype=np.float64) + 1)
        for i, c in zip(ids, contrib):
            score[i] = score.get(i, 0.0) + float(c)
    top = sorted(score.items(), key=lambda kv: (-kv[1], kv[0]))[:limit]
    return [i for i, _ in top], [-v for _, v in top]


def check_scorer_counts(counts: dict, n_queries: int, what: str,
                        sparse_only: bool = True) -> None:
    """The sparse scorer's kernel launched once a query with sparse terms,
    with the scatter in shared memory; a phase of sparse queries alone
    launched no gather of 4-byte rows (the scorer's route before csr_ip)."""
    if counts["csr_ip"] != n_queries or \
            counts["csr_ip_by_variant"] != {"shared": n_queries}:
        raise AssertionError(f"{what}: csr_ip launches {counts}, want "
                             f"{n_queries} of the shared-memory variant")
    if sparse_only and counts["gather_by_row_bytes"].get(4, 0):
        raise AssertionError(f"{what}: 4-byte gathers {counts}")


def run_sparse(dev: torch.device) -> dict:
    """Sparse and hybrid search through the library API and REST on a
    SPARSE_N-row table of a dense field (make_clustered, EUCLIDEAN) and a
    SPLADE-like sparse field (DOT_PRODUCT) over BERT's WordPiece vocabulary,
    checked against float64 oracles computed on the card."""
    out = {"rows": SPARSE_N, "vocab": SPARSE_VOCAB}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    indices, values, offsets = make_sparse(dev, SPARSE_N, SPARSE_VOCAB)
    x, dense_q = make_clustered(SPARSE_N, 128, HYBRID_Q, seed=0)
    col = [SparseVector(indices[offsets[r]:offsets[r + 1]],
                        values[offsets[r]:offsets[r + 1]])
           for r in range(SPARSE_N)]
    out["nnz"] = int(len(indices))
    out["datagen_s"] = time.perf_counter() - t0
    log(f"sparse data: {out['nnz']} nnz, "
        f"{out['nnz'] / SPARSE_N:.1f} terms a row")
    rng = np.random.default_rng(4)
    qs = sparse_queries(indices, offsets, SPARSE_Q, rng)
    with tempfile.TemporaryDirectory() as tmp:
        assert vdb.load_db("sparse", os.path.join(tmp, "sparse"),
                           vector_scale=SPARSE_N) == 0
        vdb.use_db("sparse")
        vdb.create_table("docs", [
            {"name": "ID", "dataType": "INT", "primaryKey": True},
            {"name": "emb", "dataType": "VECTOR_FLOAT", "dimensions": 128,
             "metricType": "EUCLIDEAN"},
            {"name": "terms", "dataType": "SPARSE_VECTOR_FLOAT",
             "dimensions": SPARSE_VOCAB, "metricType": "DOT_PRODUCT"}])
        t0 = time.perf_counter()
        code, res = vdb.insert_columns("docs", {"ID": np.arange(SPARSE_N),
                                                "emb": x, "terms": col})
        out["ingest_s"] = time.perf_counter() - t0
        if code != 0 or res["inserted"] != SPARSE_N:
            raise AssertionError(f"insert_columns: {code} {res}")
        table = vdb._db.databases["sparse"].tables["docs"]
        del col

        # The first query builds the CSR snapshot and uploads it.
        t0 = time.perf_counter()
        vdb.query("docs", "terms", qs[-1], ["ID"], 10, "", True)
        out["index_build_s"] = time.perf_counter() - t0
        index = table._sparse_index("terms")

        reset_counts()
        lat, results = [], []
        for q in qs:
            t0 = time.perf_counter()
            code, hits = vdb.query("docs", "terms", q, ["ID"], 10, "", True)
            lat.append(time.perf_counter() - t0)
            results.append(hits)
        torch.cuda.synchronize()
        out["query_counts"] = read_counts()
        check_scorer_counts(out["query_counts"], SPARSE_Q, "sparse queries")
        lat = np.asarray(lat) * 1e3
        out["query_ms"] = {"p50": float(np.percentile(lat, 50)),
                           "p99": float(np.percentile(lat, 99))}
        lo = SPARSE_N // 2
        reset_counts()
        flt_results = [vdb.query("docs", "terms", q, ["ID"], 10,
                                 f"ID < {lo}", True)[1]
                       for q in qs[:SPARSE_FILTERED_Q]]
        torch.cuda.synchronize()
        out["filtered_counts"] = read_counts()
        check_scorer_counts(out["filtered_counts"], SPARSE_FILTERED_Q,
                            "filtered sparse queries")

        # Oracles: float64 CSR products on the card.
        csr = torch.sparse_csr_tensor(
            torch.from_numpy(offsets), torch.from_numpy(indices),
            torch.from_numpy(values.astype(np.float64)),
            size=(SPARSE_N, SPARSE_VOCAB), device=dev)
        want, ip64 = sparse_oracle(csr, qs, SPARSE_VOCAB)
        want_f, _ = sparse_oracle(csr, qs[:SPARSE_FILTERED_Q], SPARSE_VOCAB,
                                  rows_below=lo)
        del csr
        out["recall_at_10"] = check_sparse_results(
            results, qs, want, indices, values, offsets, "sparse")
        out["filtered_recall_at_10"] = check_sparse_results(
            flt_results, qs[:SPARSE_FILTERED_Q], want_f, indices, values,
            offsets, f"sparse ID < {lo}", rows_below=lo)
        log(f"sparse queries: {json.dumps(out)}")

        # Scoring error of every row for 8 queries, and the scorer's time,
        # against the JAX package's prefix difference on the same inputs.
        err, err_prefix = 0.0, 0.0
        for j in range(8):
            q = SparseVector(np.asarray(qs[j]["indices"], np.int64),
                             np.asarray(qs[j]["values"], np.float32))
            ip = -index.device_scores(q, MetricType.DOT_PRODUCT).double()
            err = max(err, float((ip - ip64[:, j]).abs().max()))
            qd = torch.zeros(SPARSE_VOCAB + 1, device=dev)
            qd[torch.from_numpy(q.indices).to(dev)] = torch.from_numpy(
                q.values).to(dev)
            pre = prefix_difference_ip(index, qd).double()
            err_prefix = max(err_prefix, float((pre - ip64[:, j]).abs()
                                               .max()))
        del ip64
        out["max_abs_err_ip"] = err
        out["max_abs_err_ip_prefix_difference"] = err_prefix
        out["max_ip"] = float(-min(h[0]["@distance"] for h in results))
        times = in_turns({
            "scorer_ms": lambda: index.device_scores(
                q, MetricType.DOT_PRODUCT),
            "prefix_difference_ms": lambda: prefix_difference_ip(index, qd)},
            lambda c: stream_ms(c, inner=10), rounds=5)
        out.update(times)
        out["profile"] = device_profile(lambda: [
            vdb.query("docs", "terms", q, ["ID"], 10, "", True)
            for q in qs[:20]])
        out["profile"]["device_ms_per_query"] = \
            out["profile"]["device_ms"] / 20
        scorer = ("max_abs_err_ip", "max_abs_err_ip_prefix_difference",
                  "max_ip", *times)
        log(f"sparse scorer: {json.dumps({k: out[k] for k in scorer})}")
        log(f"sparse profile (20 queries): {json.dumps(out['profile'])}")

        # Hybrid: a dense and a sparse subquery each, rrf and weighted.
        pool = max(4 * 10, 10 + 32)
        hq = [[{"field": "emb", "vector": dense_q[i].tolist(),
                "weight": 1.0},
               {"field": "terms", "vector": qs[i], "weight": 1.0}]
              for i in range(HYBRID_Q)]
        reset_counts()
        lat, hres = [], []
        for i, sub in enumerate(hq):
            rerank = "rrf" if i % 2 == 0 else "weighted"
            t0 = time.perf_counter()
            code, rows = vdb.hybrid_query("docs", sub, ["ID"], 10, "", True,
                                          rerank=rerank)
            lat.append(time.perf_counter() - t0)
            hres.append(rows)
        torch.cuda.synchronize()
        out["hybrid_counts"] = read_counts()
        check_scorer_counts(out["hybrid_counts"], HYBRID_Q, "hybrid queries",
                            sparse_only=False)
        lat = np.asarray(lat) * 1e3
        out["hybrid_ms"] = {"p50": float(np.percentile(lat, 50)),
                            "p99": float(np.percentile(lat, 99))}
        for i, (sub, rows) in enumerate(zip(hq, hres)):
            lists = []
            for s in sub:
                _, r = vdb.query("docs", s["field"], s["vector"], ["ID"],
                                 pool, "", True)
                lists.append(([h["ID"] for h in r],
                              [h["@distance"] for h in r]))
            ids, scores = fuse(lists, [1.0, 1.0],
                               "rrf" if i % 2 == 0 else "weighted", 10)
            got = [h["ID"] for h in rows]
            if got != ids or any(abs(h["@distance"] - sc) > 1e-12
                                 for h, sc in zip(rows, scores)):
                raise AssertionError(
                    f"hybrid {i}: {got} vs the fusion rule's {ids}; "
                    f"{[h['@distance'] for h in rows]} vs {scores}")
        log(f"hybrid: p50/p99 ms {json.dumps(out['hybrid_ms'])} launches "
            f"{json.dumps(out['hybrid_counts'])}")

        out["rest"] = run_rest_sparse(qs, hq, results, hres)
        log(f"rest sparse + hybrid: {json.dumps(out['rest'])}")
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["csr_ip"] = check_csr_ip(dev, index, qd)
        del index
        vdb.unload_db("sparse")
    torch.cuda.empty_cache()
    return out


def run_rest_sparse(qs, hq, results, hres) -> dict:
    """REST_SPARSE sparse and REST_HYBRID hybrid requests through the REST
    server in-process (one keep-alive connection; the requests run on the
    handler thread, library mode): status 200 and the library calls' ids."""
    httpd = rest.create_server(0, vdb._db, host="127.0.0.1")
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    path = "/api/sparse/data/query"
    out = {}
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        reset_counts()
        lat = []
        for i in range(REST_SPARSE):
            st, body, secs = _post(conn, path, {
                "table": "docs", "queryField": "terms", "queryVector": qs[i],
                "limit": 10, "response": ["ID"], "withDistance": True})
            if st != 200 or [r["ID"] for r in body["result"]] != \
                    [h["ID"] for h in results[i]]:
                raise AssertionError(f"REST sparse {i}: {st} {body}")
            lat.append(secs)
        for i in range(REST_HYBRID):
            st, body, secs = _post(conn, path, {
                "table": "docs", "queryVectors": hq[i], "limit": 10,
                "rerank": "rrf" if i % 2 == 0 else "weighted",
                "response": ["ID"], "withDistance": True})
            if st != 200 or [r["ID"] for r in body["result"]] != \
                    [h["ID"] for h in hres[i]]:
                raise AssertionError(f"REST hybrid {i}: {st} {body}")
            lat.append(secs)
        torch.cuda.synchronize()
        out["counts"] = read_counts()
        check_scorer_counts(out["counts"], REST_SPARSE + REST_HYBRID,
                            "REST sparse + hybrid", sparse_only=False)
        conn.close()
        lat = np.asarray(lat) * 1e3
        out["sparse_p50_ms"] = float(np.percentile(lat[:REST_SPARSE], 50))
        out["hybrid_p50_ms"] = float(np.percentile(lat[REST_SPARSE:], 50))
    finally:
        httpd.shutdown()
        httpd.server_close()
    return out


def run_ivf(dev: torch.device) -> dict:
    """The IVF-partitioned graph build: IVF_N x 128 clustered rows,
    vdb.rebuild() at the default IvfKnnThreshold (so ops/ivf.ivf_knn builds
    the KNN graph, its output kept for the recall check), the neighbour
    recall@64 of IVF_SAMPLE rows against the exact top-64 on the card, then
    grouped and single queries against the exact oracle."""
    x, queries = make_clustered(IVF_N, 128, IVF_Q, seed=2)
    out = {"rows": IVF_N, "dim": 128}
    captured = []
    ivf_knn = ivf.ivf_knn

    def keep_ivf_knn(*args, **kwargs):  # the build's own KNN lists
        captured.append(ivf_knn(*args, **kwargs))
        return captured[-1]

    with tempfile.TemporaryDirectory() as tmp:
        assert vdb.load_db("ivf", os.path.join(tmp, "ivf"),
                           vector_scale=IVF_N) == 0
        vdb.use_db("ivf")
        vdb.create_table("docs", [
            {"name": "ID", "dataType": "INT", "primaryKey": True},
            {"name": "Emb", "dataType": "VECTOR_FLOAT", "dimensions": 128,
             "metricType": "EUCLIDEAN"}])
        t0 = time.perf_counter()
        code, res = vdb.insert_columns("docs", {"ID": np.arange(IVF_N),
                                                "Emb": x})
        out["ingest_s"] = time.perf_counter() - t0
        if code != 0 or res["inserted"] != IVF_N:
            raise AssertionError(f"insert_columns: {code} {res}")
        assert vdb.update_config({"QueryGroupSize": 4,
                                  "FusedTraversal": "auto"}) == 0
        if IVF_N < vdb.global_config.ivf_knn_threshold:
            raise AssertionError("the table is below IvfKnnThreshold")
        table = vdb._db.databases["ivf"].tables["docs"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        ivf.ivf_knn = keep_ivf_knn
        try:
            t0 = time.perf_counter()
            code = vdb.rebuild()
            torch.cuda.synchronize()
            out["rebuild_s"] = time.perf_counter() - t0
        finally:
            ivf.ivf_knn = ivf_knn
        out["build_counts"] = read_counts()
        out["rebuild_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        graph = table.graphs["Emb"]
        if code != 0 or graph is None or graph.num_rows != IVF_N:
            raise AssertionError(f"rebuild: code {code}, graph {graph}")
        if len(captured) != 1 or graph.ivf_stats.get("n") != IVF_N:
            raise AssertionError("the build did not go through ivf_knn")
        out["build_phase_s"] = graph.build_seconds
        out["ivf"] = graph.ivf_stats
        log(f"ivf build phases (s): {json.dumps(graph.build_seconds)}")
        log(f"ivf_knn: {json.dumps(graph.ivf_stats)}")

        # Neighbour recall@64 of the build's KNN lists against the exact
        # top-64 of the rows the build indexed (the store's bf16 values,
        # f32 products) and, printed only, of the f32 rows.
        knn_ids = captured[0][0]
        del captured[:]
        k = knn_ids.shape[1]
        rng = np.random.default_rng(5)
        sample = np.sort(rng.choice(IVF_N, IVF_SAMPLE, replace=False))
        store = table.segment.device_view("Emb").buf[:IVF_N]
        for name, tab in (("store", None), ("f32", x)):
            t = (store.float() if tab is None
                 else torch.from_numpy(tab).to(dev))
            tn = (t * t).sum(1)
            hits = 0
            for s in range(0, IVF_SAMPLE, 256):
                rows = torch.from_numpy(sample[s:s + 256]).to(dev)
                d = tn[None, :] - 2.0 * (t[rows] @ t.T)
                d[torch.arange(len(rows), device=dev), rows] = float("inf")
                top = torch.topk(d, k, dim=1, largest=False).indices
                for a, b in zip(knn_ids[sample[s:s + 256]],
                                top.cpu().numpy()):
                    hits += len(set(a.tolist()) & set(b.tolist()))
                del d
            out[f"knn_recall_at_{k}_{name}"] = hits / (IVF_SAMPLE * k)
            del t, tn
        del store
        torch.cuda.empty_cache()
        if out[f"knn_recall_at_{k}_store"] < IVF_RECALL_FLOOR:
            raise AssertionError(f"IVF recall@{k} "
                                 f"{out[f'knn_recall_at_{k}_store']} < "
                                 f"{IVF_RECALL_FLOOR}")
        log(f"ivf knn recall@{k}: store {out[f'knn_recall_at_{k}_store']} "
            f"f32 {out[f'knn_recall_at_{k}_f32']}")

        # Queries: grouped (the graph program) and single.
        x_dev = torch.from_numpy(x).to(dev)
        n_rec = min(2048, IVF_Q)
        want = oracle_top10_gpu(x_dev, x, queries[:n_rec])
        del x_dev
        torch.cuda.empty_cache()
        valid = table.segment.valid_mask()
        table.grouped_dense_search("Emb", queries[:GRAPH_BATCH * 4 + 1],
                                   valid, MetricType.EUCLIDEAN, 10,
                                   batch=GRAPH_BATCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        ids, dists = table.grouped_dense_search(
            "Emb", queries, valid, MetricType.EUCLIDEAN, 10,
            batch=GRAPH_BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["grouped"] = {"qps": IVF_Q / wall, "wall_s": wall,
                          "counts": read_counts(),
                          "peak_bytes": torch.cuda.max_memory_allocated(dev)}
        if ids.shape != (IVF_Q, 10) or not np.isfinite(dists).all():
            raise AssertionError(f"grouped result shape {ids.shape}")
        out["grouped"]["recall_at_10"] = float(np.mean(
            [len(set(a) & set(b)) / 10.0 for a, b in zip(ids[:n_rec], want)]))
        if out["grouped"]["recall_at_10"] < RECALL_FLOOR:
            raise AssertionError(f"IVF graph recall@10 "
                                 f"{out['grouped']['recall_at_10']}")
        exact = ((x[ids] - queries[:, None, :]) ** 2).sum(2)
        if not np.allclose(dists, exact, rtol=1e-5, atol=0.0):
            raise AssertionError("IVF graph distances differ from f32 "
                                 "recomputation")
        log(f"ivf grouped: {json.dumps(out['grouped'])}")
        # Single queries: recall over all of them is held to the floor of
        # the other phases; the per-query overlaps (and the grouped recall
        # of the same queries) show the margin.
        reset_counts()
        n_single = IVF_SINGLE + 8
        lat, overlap = [], []
        for i in range(n_single):
            t0 = time.perf_counter()
            code, hits = vdb.query("docs", "Emb", queries[i].tolist(),
                                   ["ID"], 10, "", True)
            lat.append(time.perf_counter() - t0)
            if code != 0 or len(hits) != 10:
                raise AssertionError(f"IVF single query {i}: {hits}")
            overlap.append(len(set(h["ID"] for h in hits)
                               & set(want[i].tolist())))
        out["single_counts"] = read_counts()
        lat = np.asarray(lat[8:]) * 1e3
        overlap = np.asarray(overlap)
        out["single_ms"] = {
            "p50": float(np.percentile(lat, 50)),
            "p99": float(np.percentile(lat, 99)),
            "queries": n_single,
            "recall_at_10": float(overlap.sum() / (10.0 * n_single)),
            "min_overlap": int(overlap.min()),
            "below_10": [[i, int(o)] for i, o in enumerate(overlap)
                          if o < 10],
            "grouped_recall_at_10_same_queries": float(np.mean(
                [len(set(a) & set(b)) / 10.0
                 for a, b in zip(ids[:n_single], want)]))}
        if out["single_ms"]["recall_at_10"] < RECALL_FLOOR:
            raise AssertionError(f"IVF single queries: recall@10 "
                                 f"{out['single_ms']['recall_at_10']}")
        log(f"ivf single queries (ms): {json.dumps(out['single_ms'])}")
        vdb.unload_db("ivf")
    torch.cuda.empty_cache()
    return out


def _single_queries(qs: np.ndarray, want: np.ndarray, flt: str = "",
                    keep=None, warm: int = 8) -> dict:
    """vdb.query of each query (limit 10, `flt`): p50 / p99 after `warm`
    warm-up queries, recall@10 against `want`, every row passing `keep`,
    launch counts (set to 0 just before, read just after)."""
    for q in qs[:warm]:
        vdb.query("docs", "Emb", q.tolist(), ["ID"], 10, flt, True)
    torch.cuda.synchronize()
    reset_counts()
    lat, overlap = [], []
    for i, q in enumerate(qs):
        t0 = time.perf_counter()
        code, hits = vdb.query("docs", "Emb", q.tolist(), ["ID"], 10, flt,
                               True)
        lat.append(time.perf_counter() - t0)
        ids = [h["ID"] for h in hits]
        if code != 0 or len(ids) != 10:
            raise AssertionError(f"single query {i} {flt!r}: {hits}")
        if keep is not None and not keep[ids].all():
            raise AssertionError(f"single query {i}: a row fails {flt!r}")
        overlap.append(len(set(ids) & set(want[i].tolist())))
    lat = np.asarray(lat) * 1e3
    return {"queries": len(qs), "filter": flt, "counts": read_counts(),
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "recall_at_10": float(np.sum(overlap) / (10.0 * len(qs))),
            "min_overlap": int(np.min(overlap))}


def run_sharded(dev: torch.device) -> dict:
    """The sharded data plane on one card: ShardCount=4 over
    set_engine_mesh(make_mesh([cuda:0] * 4)), SHARD_N x 128 clustered rows
    (seed 4, 1M a shard in cap_s 1,048,576 slots) with `cat` (INT 0-9).
    SHARD_PRE flat queries through vdb.query before the build; vdb.rebuild()
    (each shard's exact KNN on the partial-min kernel, pruning on the
    gather kernel; phase seconds summed over the shards) and its auto-tune;
    SHARD_Q grouped queries and SHARD_SINGLE single queries against the
    exact oracle over all rows; `cat < 5` through the device filter; an
    insert of SHARD_INSERT rows that single queries find first (the flat
    tail); an unload and a load that finds the sharded graph; peak device
    memory."""
    from vectordb_tpu_torch.parallel import engine, make_mesh, set_engine_mesh

    x, queries = make_clustered(SHARD_N, 128, SHARD_Q, seed=4)
    rng = np.random.default_rng(5)
    cat = rng.integers(0, 10, SHARD_N)
    out = {"rows": SHARD_N, "dim": 128, "shards": SHARD_COUNT,
           "batch": GRAPH_BATCH, "group": 4}
    set_engine_mesh(make_mesh([dev] * SHARD_COUNT))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "sharded")
            assert vdb.update_config({"ShardCount": SHARD_COUNT,
                                      "QueryGroupSize": 4,
                                      "FusedTraversal": "auto"}) == 0
            assert vdb.load_db("sharded", path,
                               vector_scale=SHARD_N + SHARD_INSERT) == 0
            vdb.use_db("sharded")
            vdb.create_table("docs", [
                {"name": "ID", "dataType": "INT", "primaryKey": True},
                {"name": "cat", "dataType": "INT"},
                {"name": "Emb", "dataType": "VECTOR_FLOAT", "dimensions": 128,
                 "metricType": "EUCLIDEAN"}])
            t0 = time.perf_counter()
            code, res = vdb.insert_columns("docs", {
                "ID": np.arange(SHARD_N), "cat": cat, "Emb": x})
            out["ingest_s"] = time.perf_counter() - t0
            if code != 0 or res["inserted"] != SHARD_N:
                raise AssertionError(f"insert_columns: {code} {res}")
            table = vdb._db.databases["sharded"].tables["docs"]
            if table.mesh is None or table.mesh.size != SHARD_COUNT:
                raise AssertionError(f"the table is not sharded: {table.mesh}")

            # Exact oracles over all rows, while x is on the card.
            x_dev = torch.from_numpy(x).to(dev)
            n_rec = min(2048, SHARD_Q)
            want = oracle_top10_gpu(x_dev, x, queries[:n_rec])
            keep_cat = cat < 5
            want_cat = masked_oracle_gpu(x_dev, x, queries[:SHARD_FILTERED],
                                         keep_cat)
            del x_dev
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

            # Before the build: the sharded flat scan.
            out["pre_build"] = _single_queries(queries[:SHARD_PRE],
                                               want[:SHARD_PRE])
            log(f"sharded pre-build queries: {json.dumps(out['pre_build'])}")
            if out["pre_build"]["recall_at_10"] < RECALL_FLOOR:
                raise AssertionError("sharded flat recall@10 "
                                     f"{out['pre_build']['recall_at_10']}")

            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            code = vdb.rebuild()
            torch.cuda.synchronize()
            out["rebuild_s"] = time.perf_counter() - t0
            out["build_counts"] = read_counts()
            graph = table.sharded_fields["Emb"].graph
            if code != 0 or graph is None or graph.num_rows != SHARD_N:
                raise AssertionError(f"rebuild: code {code}, graph {graph}")
            if (out["build_counts"]["partial_min"] <= 0
                    or out["build_counts"]["gather"] <= 0):
                raise AssertionError("the sharded build did not launch both "
                                     f"kernels: {out['build_counts']}")
            out["build_phase_s"] = graph.build_seconds
            out["tuned"] = {k: table._tuned_report["Emb"][k]
                            for k in ("ef", "iters", "recall", "id_recall",
                                      "ood_recall", "qdtype",
                                      "qdtype_wire_recall")}
            out["tune_rungs"] = len(table._tuned_report["Emb"]["tried"])
            log(f"sharded build phases (s, summed over the shards): "
                f"{json.dumps(graph.build_seconds)}; rebuild "
                f"{out['rebuild_s']:.2f} s; tuned {json.dumps(out['tuned'])}")

            valid = table.segment.valid_mask()
            table.grouped_dense_search("Emb", queries[:GRAPH_BATCH * 4 + 1],
                                       valid, MetricType.EUCLIDEAN, 10,
                                       batch=GRAPH_BATCH)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            ids, dists = table.grouped_dense_search(
                "Emb", queries, valid, MetricType.EUCLIDEAN, 10,
                batch=GRAPH_BATCH)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            r = {"qps": SHARD_Q / wall, "wall_s": wall,
                 "counts": read_counts()}
            if r["counts"]["gather"] <= 0:
                raise AssertionError("sharded grouped queries never launched "
                                     "the gather kernel")
            if ids.shape != (SHARD_Q, 10) or not np.isfinite(dists).all():
                raise AssertionError(f"grouped result shape {ids.shape}")
            r["recall_at_10"] = float(np.mean(
                [len(set(a) & set(b)) / 10.0
                 for a, b in zip(ids[:n_rec], want)]))
            if r["recall_at_10"] < RECALL_FLOOR:
                raise AssertionError(f"sharded grouped recall@10 "
                                     f"{r['recall_at_10']}")
            exact = ((x[ids] - queries[:, None, :]) ** 2).sum(2)
            if not np.allclose(dists, exact, rtol=1e-5, atol=0.0):
                raise AssertionError("sharded distances differ from f32 "
                                     "recomputation")
            out["grouped"] = r
            log(f"sharded grouped: {json.dumps(r)}")
            out["profile"] = {
                "grouped": device_profile(lambda: table.grouped_dense_search(
                    "Emb", queries[:GRAPH_BATCH * 4], valid,
                    MetricType.EUCLIDEAN, 10, batch=GRAPH_BATCH)),
                "single": device_profile(lambda: [
                    vdb.query("docs", "Emb", queries[i].tolist(), ["ID"], 10,
                              "", True) for i in range(20)])}
            log(f"sharded profile: {json.dumps(out['profile'])}")
            out["int8"] = wire_pass(table, "int8", queries, valid,
                                    GRAPH_BATCH, x, want, "gather")
            assert vdb.update_config({"QueryDtype": "auto"}) == 0
            log(f"sharded grouped QueryDtype=int8: {json.dumps(out['int8'])}")

            out["single"] = _single_queries(queries[:SHARD_SINGLE],
                                            want[:SHARD_SINGLE])
            log(f"sharded single queries: {json.dumps(out['single'])}")
            if out["single"]["recall_at_10"] < RECALL_FLOOR:
                raise AssertionError("sharded single recall@10 "
                                     f"{out['single']['recall_at_10']}")

            out["filtered"] = _single_queries(
                queries[:SHARD_FILTERED], want_cat, "cat < 5", keep_cat,
                warm=2)
            log(f"sharded cat < 5: {json.dumps(out['filtered'])}")
            if out["filtered"]["recall_at_10"] < WIDENED_RECALL_FLOOR:
                raise AssertionError("sharded filtered recall@10 "
                                     f"{out['filtered']['recall_at_10']}")

            # Rows inserted after the build: near-copies of stored rows
            # that single queries find first (the per-shard flat tail).
            x_new = (x[rng.integers(0, SHARD_N, SHARD_INSERT)]
                     + 0.05 * rng.normal(size=(SHARD_INSERT, 128))
                     ).astype(np.float32)
            code, res = vdb.insert_columns("docs", {
                "ID": np.arange(SHARD_N, SHARD_N + SHARD_INSERT),
                "cat": np.arange(SHARD_INSERT) % 10, "Emb": x_new})
            if code != 0 or res["inserted"] != SHARD_INSERT:
                raise AssertionError(f"insert after the build: {res}")
            torch.cuda.synchronize()
            reset_counts()
            for j in range(0, SHARD_INSERT, SHARD_INSERT // 64):
                _, hits = vdb.query("docs", "Emb", x_new[j].tolist(), ["ID"],
                                    10, "", True)
                if hits[0]["ID"] != SHARD_N + j:
                    raise AssertionError(f"tail row {SHARD_N + j}: {hits[:2]}")
            out["insert_counts"] = read_counts()
            out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)

            # Unload and load: the sharded graph comes back from its .npz.
            assert vdb.unload_db("sharded") == 0
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            assert vdb.load_db("sharded", path,
                               vector_scale=SHARD_N + SHARD_INSERT) == 0
            vdb.use_db("sharded")
            out["load_s"] = time.perf_counter() - t0
            table = vdb._db.databases["sharded"].tables["docs"]
            g = table.sharded_fields["Emb"].graph
            if g is None or g.num_rows != SHARD_N:
                raise AssertionError(f"the sharded graph did not load: {g}")
            torch.cuda.synchronize()
            reset_counts()
            for row in (42, SHARD_N - 1, SHARD_N + 7):
                v = x[row] if row < SHARD_N else x_new[row - SHARD_N]
                _, hits = vdb.query("docs", "Emb", v.tolist(), ["ID"], 10, "",
                                    True)
                if hits[0]["ID"] != row:
                    raise AssertionError(f"after the load, X[{row}]: "
                                         f"{hits[:2]}")
            out["reload_counts"] = read_counts()
            vdb.unload_db("sharded")
    finally:
        engine._reset_for_tests()
        assert vdb.update_config({"ShardCount": 0}) == 0
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = _cuda_build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {json.dumps(libs)}")
    for lib in libs.values():
        with open(lib[:-3] + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log("ptxas: " + line.strip())

    pm_cases = check_kernel(dev, KERNEL_B, KERNEL_N, KERNEL_D)
    knn = check_knn_kernel(dev)
    gather_cases = check_gather(dev)
    wires = check_wires(dev)
    sl = run_slice(dev, SLICE_N, SLICE_D, SLICE_Q, SLICE_BATCH)
    log(f"slice: {json.dumps(sl)}")
    gr = run_graph(dev, GRAPH_N, GRAPH_D, GRAPH_Q, GRAPH_BATCH)
    log(f"graph: {json.dumps(gr)}")
    t0 = time.perf_counter()
    sp = run_sparse(dev)
    sp["phase_s"] = time.perf_counter() - t0
    log(f"sparse: {json.dumps(sp)}")
    t0 = time.perf_counter()
    iv = run_ivf(dev)
    iv["phase_s"] = time.perf_counter() - t0
    log(f"ivf: {json.dumps(iv)}")
    t0 = time.perf_counter()
    sh = run_sharded(dev)
    sh["phase_s"] = time.perf_counter() - t0
    log(f"sharded: {json.dumps(sh)}")
    # Launch counts of every main-path phase (the CLI's child process
    # aside), and the gathers by the bytes of a table row.
    phases = {"slice_single": sl["single_counts"],
              "slice_grouped": sl["counts"],
              "slice_filtered": sl["filtered"]["counts"],
              "slice_int8": sl["int8"]["counts"],
              "graph_build": gr["build_counts"],
              "graph_single": gr["single_counts"],
              **{f"graph_grouped_{mode}": r["counts"]
                 for mode, r in gr["grouped"].items()},
              "graph_filtered": gr["filtered"]["counts"],
              **{f"graph_wire_{w}": r["counts"]
                 for w, r in gr["wires"].items()},
              "rest_queries": gr["rest"]["counts"],
              "rest_insert": gr["rest"]["insert_counts"],
              "rest_rebuild": gr["rest"]["rebuild_counts"],
              "sparse_queries": sp["query_counts"],
              "sparse_filtered": sp["filtered_counts"],
              "hybrid": sp["hybrid_counts"],
              "rest_sparse_hybrid": sp["rest"]["counts"],
              "ivf_build": iv["build_counts"],
              "ivf_grouped": iv["grouped"]["counts"],
              "ivf_single": iv["single_counts"],
              "sharded_pre_build": sh["pre_build"]["counts"],
              "sharded_build": sh["build_counts"],
              "sharded_grouped": sh["grouped"]["counts"],
              "sharded_int8": sh["int8"]["counts"],
              "sharded_single": sh["single"]["counts"],
              "sharded_filtered": sh["filtered"]["counts"],
              "sharded_insert": sh["insert_counts"],
              "sharded_reload": sh["reload_counts"]}
    by_width = {}
    for c in phases.values():
        for rb, k in c["gather_by_row_bytes"].items():
            by_width[rb] = by_width.get(rb, 0) + k
    by_variant = {}
    for c in phases.values():
        for v, k in c["csr_ip_by_variant"].items():
            by_variant[v] = by_variant.get(v, 0) + k
    log(f"launches by phase: {json.dumps(phases)}")
    for phase, widths in (("ivf_build", (256,)), ("sharded_grouped", (256,))):
        if not all(phases[phase]["gather_by_row_bytes"].get(w, 0) > 0
                   for w in widths):
            raise AssertionError(f"{phase}: no gathers of {widths}-byte rows")
    main_pm = pm_cases["l2_mask_nvalid"]
    csr = sp["csr_ip"]
    trav = gather_cases["bf16_store"]
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "pct_of_bound",
            "gemm_ms", "max_abs_err")
    print(json.dumps({"kernels": [
        {"name": "partial_min", "route": "cuda",
         "source": "vectordb_tpu_torch/csrc/partial_min.cu",
         "replaces": "vectordb_tpu/ops/pallas_topk.py:45",
         "launches": sum(c["partial_min"] for c in phases.values()),
         "max_abs_err": max(c["max_abs_err"]
                            for c in list(pm_cases.values()) + [knn]),
         "ms": main_pm["ms"], "plain_ms": main_pm["plain_ms"],
         "bound_ms": main_pm["bound_ms"], "bound_by": main_pm["bound_by"],
         "library_ms": None, "pct_of_bound": main_pm["pct_of_bound"],
         "gemm_ms": main_pm["gemm_ms"],
         "knn_block": {k: knn[k] for k in keep}},
        {"name": "gather_rows", "route": "cuda",
         "source": "vectordb_tpu_torch/csrc/gather_rows.cu",
         "binding": "vectordb_tpu_torch/csrc/gather_rows_op.cpp",
         "replaces": "benchmarks/gather_micro.py:30",
         "launches": sum(c["gather"] for c in phases.values()),
         "launches_by_row_bytes": by_width,
         "max_abs_err": max(c["max_abs_err"] for c in gather_cases.values()),
         "ms": trav["ms"], "plain_ms": trav["plain_ms"],
         "bound_ms": trav["bound_ms"], "bound_by": trav["bound_by"],
         "library_ms": trav["library_ms"],
         "pct_of_bound": trav["pct_of_bound"],
         "cases": gather_cases},
        {"name": "csr_ip", "route": "cuda",
         "source": "vectordb_tpu_torch/csrc/csr_ip.cu",
         "binding": "vectordb_tpu_torch/csrc/csr_ip_op.cpp",
         "replaces": "vectordb_tpu/ops/sparse.py:85",
         "replaces_kind": "_sparse_ip_kernel, a jitted XLA program (gather, "
                          "multiply, prefix-sum difference), not a Pallas "
                          "kernel",
         "launches": sum(c["csr_ip"] for c in phases.values()),
         "launches_by_variant": by_variant,
         "max_abs_err": max(csr["max_abs_err"],
                            csr["large_scatter"]["max_abs_err"]),
         "ms": csr["ms"], "plain_ms": csr["plain_ms"],
         "bound_ms": csr["bound_ms"], "bound_by": csr["bound_by"],
         "library_ms": csr["library_ms"],
         "library": "cuSPARSE SpMV (torch.sparse_csr_tensor @ q, int32)",
         "pct_of_bound": csr["pct_of_bound"],
         "three_pass_ms": csr["three_pass_ms"],
         "l2_variant_ms": csr["l2_variant_ms"],
         "large_scatter": csr["large_scatter"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
