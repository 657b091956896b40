"""Where a graph query's time goes on one CUDA card: device time by op,
launches a query, idle share, single-query latency and grouped throughput.

    python3 traversal_profile.py [--tag NAME] [--sharded] [--out DIR]

Run from the root of a checkout, beside chip_smoke.py, whose
make_clustered, launch counters and device_profile it uses (so a parent's
tree can be measured with this file copied into it). It builds
chip_smoke's 1M x 128 graph (make_clustered, seed 0; QueryGroupSize 4,
FusedTraversal auto; vdb.rebuild() with its auto-tune), then:
  - 200 single queries through vdb.query after 20 warm-up ones: p50 / p90
    / p99 ms;
  - 16,384 grouped queries (batch 2,048) with FusedTraversal auto and off:
    QPS;
  - under torch.profiler (chip_smoke.device_profile), one grouped program
    of 8,192 queries and 20 single queries: wall, device time, idle share
    (1 - device / wall), device kernels and copies a query, and the top
    device time by kernel and by aten op (with input shapes), with the
    launch counts;
with --sharded, the same for chip_smoke's 4M x 128 table over 4 shards on
the card (seed 4): single p50 and its profile, grouped QPS.
Prints the card's name and power limit, one JSON line a phase, and writes
the whole record to <--out, default .>/traversal_profile_<tag>.json.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

N_SINGLE, N_WARM, N_PROF_SINGLE = 200, 20, 20
BATCH, GROUPED_Q, PROF_Q = 2048, 16_384, 8192


def _singles(vdb, queries) -> dict:
    for q in queries[:N_WARM]:
        vdb.query("docs", "Emb", q.tolist(), ["ID"], 10, "", True)
    lat = []
    for q in queries[N_WARM:N_WARM + N_SINGLE]:
        t0 = time.perf_counter()
        vdb.query("docs", "Emb", q.tolist(), ["ID"], 10, "", True)
        lat.append((time.perf_counter() - t0) * 1e3)
    return {f"p{p}_ms": float(np.percentile(lat, p)) for p in (50, 90, 99)}


def _grouped_qps(table, queries, valid) -> float:
    from vectordb_tpu_torch.schema import MetricType

    table.grouped_dense_search("Emb", queries[:BATCH * 4 + 1], valid,
                               MetricType.EUCLIDEAN, 10, batch=BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table.grouped_dense_search("Emb", queries, valid, MetricType.EUCLIDEAN,
                               10, batch=BATCH)
    torch.cuda.synchronize()
    return queries.shape[0] / (time.perf_counter() - t0)


def _profile(cs, fn, n_queries: int) -> dict:
    """chip_smoke.device_profile of fn(), with the launch counts."""
    cs.reset_counts()
    out = cs.device_profile(fn, n_queries)
    out["counts"] = cs.read_counts()
    return out


def run(cs, vdb, n: int, seed: int, shards: int, dev) -> dict:
    """Build the table (sharded over `shards` copies of `dev` when > 1),
    then the timings and profiles of the module docstring."""
    from vectordb_tpu_torch.schema import MetricType

    x, queries = cs.make_clustered(n, 128, GROUPED_Q, seed=seed)
    out = {"rows": n, "shards": shards}
    if shards > 1:
        from vectordb_tpu_torch.parallel import make_mesh, set_engine_mesh
        set_engine_mesh(make_mesh([dev] * shards))
    with tempfile.TemporaryDirectory() as tmp:
        assert vdb.update_config({"ShardCount": shards if shards > 1 else 0,
                                  "QueryGroupSize": 4,
                                  "FusedTraversal": "auto"}) == 0
        assert vdb.load_db("prof", os.path.join(tmp, "prof"),
                           vector_scale=n) == 0
        vdb.use_db("prof")
        vdb.create_table("docs", [
            {"name": "ID", "dataType": "INT", "primaryKey": True},
            {"name": "Emb", "dataType": "VECTOR_FLOAT", "dimensions": 128,
             "metricType": "EUCLIDEAN"}])
        code, _ = vdb.insert_columns("docs", {"ID": np.arange(n), "Emb": x})
        assert code == 0
        del x
        t0 = time.perf_counter()
        assert vdb.rebuild() == 0
        torch.cuda.synchronize()
        out["rebuild_s"] = time.perf_counter() - t0
        table = vdb._db.databases["prof"].tables["docs"]
        rep = getattr(table, "_tuned_report", {}).get("Emb", {})
        out["tuned"] = {k: rep.get(k) for k in ("ef", "iters", "recall")}
        valid = table.segment.valid_mask()
        out["single"] = _singles(vdb, queries)
        out["profile_single"] = _profile(cs, lambda: [
            vdb.query("docs", "Emb", q.tolist(), ["ID"], 10, "", True)
            for q in queries[:N_PROF_SINGLE]], N_PROF_SINGLE)
        for mode in ("auto", "off"):
            assert vdb.update_config({"FusedTraversal": mode}) == 0
            out[f"grouped_qps_{mode}"] = _grouped_qps(table, queries, valid)
        assert vdb.update_config({"FusedTraversal": "auto"}) == 0
        out["profile_grouped"] = _profile(
            cs, lambda: table.grouped_dense_search(
                "Emb", queries[:PROF_Q], valid, MetricType.EUCLIDEAN, 10,
                batch=BATCH), PROF_Q)
        vdb.unload_db("prof")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="run")
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--out", default=".",
                    help="directory of the JSON record")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("traversal_profile: no CUDA device")
    import chip_smoke as cs
    import vectordb_tpu_torch as vdb
    from vectordb_tpu_torch import _cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    _cuda_build.build_all()
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    rec = {"tag": args.tag, "card": smi,
           "graph_1m": run(cs, vdb, cs.GRAPH_N, 0, 1, dev)}
    print(json.dumps({"graph_1m": rec["graph_1m"]}), flush=True)
    if args.sharded:
        rec["sharded_4m"] = run(cs, vdb, cs.SHARD_N, 4, cs.SHARD_COUNT, dev)
        print(json.dumps({"sharded_4m": rec["sharded_4m"]}), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out,
                           f"traversal_profile_{args.tag}.json"), "w") as f:
        json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
