"""One run of one cell of BENCHMARK.json.

A cell names a configuration (configs/<config>.json: the generator of its
data, its plain reference and the precision of its control, the engine's
settings, the guarantees and the limits of the comparison) and a traffic
mix (traffic/<traffic>.json, which loadgen reads). run_cell makes the data
on the device from the seed, ingests it and builds the index through the
public API, warms the cell's shapes, drives the traffic for the window,
frees the program's state and judges what the timed path returned against
the plain reference. In a traced run the per-layer metrics are read by
layer_metrics/<metric>.py, each a function read(ctx) that returns a number
or None when it finds nothing to read. An end-to-end metric is the window's
quantity its name starts with (qps, p95_ms, recall_at_10, setup_s):
"qps.single" is the qps of the cells it lists.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DB = "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "vectordb_tpu")
PERCENTILE = 95


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_spec() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def entry(items: list, name: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no entry named {name!r}")


def load_module(*parts: str):
    """The module in perfbench/<parts>.py, loaded from its file (names may
    hold dots)."""
    path = os.path.join(HERE, *parts) + ".py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + "_".join(parts).replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(spec: dict, workload: str):
    """(cell, configuration, traffic mix) of a workload, found by name."""
    cell = entry(spec["workloads"], workload)
    return (cell, load_json(HERE, "configs", cell["config"] + ".json"),
            load_json(HERE, "traffic", cell["traffic"] + ".json"))


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def sync(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def ingest_columns(data: dict, cfg: dict) -> dict:
    """The generated rows as vdb.insert_columns takes them."""
    cols = {"ID": np.arange(data["n"], dtype=np.int64), **data["attributes"]}
    raw = data["raw"]
    if data["kind"] == "dense":
        cols[cfg["field"]] = raw["x"]
    else:
        from vectordb_tpu_torch.ops.sparse import SparseVector

        o, idx, val = raw["offsets"], raw["indices"], raw["values"]
        cols[cfg["field"]] = [SparseVector(idx[o[r]:o[r + 1]],
                                           val[o[r]:o[r + 1]])
                              for r in range(data["n"])]
    return cols


def run_cell(workload: str, seed: int, seconds: float, trace: bool, dev,
             t_start: float, spec: dict = None, cfg: dict = None,
             mix: dict = None, control: bool = False) -> dict:
    """One run of `workload`; returns the result line as a dict (with
    "control": the control's checks when `control`). spec, cfg and mix
    default to BENCHMARK.json and the cell's files."""
    import torch

    import vectordb_tpu_torch as vdb
    from vectordb_tpu_torch.metrics import metrics as program_metrics

    from perfbench import loadgen
    from perfbench.trace import Tracer, read

    spec = spec or load_spec()
    cell, cfg0, mix0 = cell_files(spec, workload)
    cfg, mix = cfg or cfg0, mix or mix0
    seed = int(seed) % (1 << 63)
    t0 = time.monotonic()
    data = load_module("generators", cfg["generator"]).make(
        cfg, seed, dev, mix["pool"])
    log(f"{workload}: data made in {time.monotonic() - t0:.3f} s (process "
        f"start to here {time.monotonic() - t_start:.3f} s), "
        f"{json.dumps(data['stats'])}")
    tmp = tempfile.mkdtemp(prefix="perfbench-")
    traffic = None
    vdb.set_device(dev.type)
    try:
        if vdb.update_config(cfg["engine"]) != 0:
            raise ValueError(f"engine settings refused: {cfg['engine']}")
        if vdb.load_db(DB, os.path.join(tmp, DB), vector_scale=data["n"],
                       wal_enabled=cfg["wal"]) != 0:
            raise RuntimeError("load_db failed")
        vdb.use_db(DB)
        vdb.create_table(loadgen.TABLE, data["schema"])
        t0 = time.monotonic()
        code, res = vdb.insert_columns(loadgen.TABLE,
                                       ingest_columns(data, cfg))
        if code != 0 or res["inserted"] != data["n"]:
            raise RuntimeError(f"insert_columns: {code} {res}")
        log(f"{workload}: ingest {time.monotonic() - t0:.3f} s")
        build_phases = None
        if cfg["rebuild"]:
            sync(dev)
            t0 = time.monotonic()
            if vdb.rebuild() != 0:
                raise RuntimeError("rebuild failed")
            sync(dev)
            build_s = time.monotonic() - t0
            graph = vdb._db.databases[DB].tables[loadgen.TABLE].graphs.get(
                cfg["field"])
            build_phases = dict(graph.build_seconds) if graph else None
            tuned = vdb._db.databases[DB].tables[loadgen.TABLE] \
                ._tuned_report.get(cfg["field"], {})
            log(f"{workload}: rebuild {build_s:.3f} s, phases "
                f"{json.dumps(build_phases)}, tuned "
                f"{json.dumps({k: tuned.get(k) for k in ('ef', 'iters', 'qdtype')})}")
        t0 = time.monotonic()
        traffic = loadgen.make(mix, cfg, data, seed)
        traffic.warmup()
        sync(dev)
        setup_s = time.monotonic() - t_start
        log(f"{workload}: warm-up {time.monotonic() - t0:.3f} s, set-up "
            f"{setup_s:.3f} s")
        tracer = Tracer(trace, seconds)
        c0, load0 = program_metrics.snapshot()["counters"], os.getloadavg()
        win = traffic.run(seconds, tracer)
        c1 = program_metrics.snapshot()["counters"]
        counters = {k: c1[k] - c0.get(k, 0.0) for k in c1}
        log(f"{workload}: window load average {load0[0]:.2f} -> "
            f"{os.getloadavg()[0]:.2f}, program counters "
            f"{json.dumps(counters)}")
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        reading = read(tracer.prof) if trace else None
    finally:
        if traffic is not None:
            traffic.close()
        traffic = None
        if vdb._db is not None and DB in vdb._db.databases:
            vdb.unload_db(DB)
        vdb._reset_for_tests()
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    e2e = window_metrics(win, seconds)
    if len(win.t1):
        quarter = np.floor((win.t1 - win.start) / (seconds / 4)).clip(0, 3)
        log(f"{workload}: queries/s by quarter of the window "
            f"{[round(float(win.nq[quarter == i].sum()) * 4 / seconds, 1) for i in range(4)]}")
    e2e["setup_s"] = setup_s
    ref = load_module("reference", cfg["reference"])
    t0 = time.monotonic()
    reference = ref.Reference(data["raw"], data["queries"], dev)
    checks, recall = judge(reference, data, cfg, mix, win)
    log(f"{workload}: reference and comparison {time.monotonic() - t0:.3f} s"
        f" for {int(win.ok.sum())} answers")
    e2e["recall_at_10"] = recall
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": int(len(win.ok)), "failed": int((~win.ok).sum())}
    if trace:
        ctx = types.SimpleNamespace(
            reading=reading, window=win, tracer=tracer, data=data,
            build_phases=build_phases, traced=traced_requests(win, tracer))
        picked = [m for m in spec["per_layer"] if applies(m, workload)]
        values = {m["name"]: load_module("layer_metrics", m["name"]).read(ctx)
                  for m in picked}
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in picked if values[m["name"]] is not None}
    else:
        out["metrics"] = {m["name"]: {"value": e2e[m["name"].split(".")[0]],
                                      "unit": m["unit"]}
                          for m in spec["end_to_end"]
                          if applies(m, workload)}
    out["device"] = device_info(dev, cell["chips"], peak)
    if trace:
        out["device"].update(
            busy_s=reading.busy_s if reading else 0.0,
            window_s=reading.window_s if reading else 0.0)
        if reading is not None:
            out["breakdown"] = reading.breakdown()
    if win.first_error:
        log(f"{workload}: first failed request: {win.first_error}")
    if control:
        low = ref.Reference(data["raw"], data["queries"], dev,
                            precision=cfg["control"])
        out["control"], _ = judge(reference, data, cfg, mix,
                                  control_window(low, data, cfg, mix, win))
    out["checks"] = checks
    return out


def window_metrics(win, seconds: float) -> dict:
    """qps over all the window's work and time (from its start to the last
    answer), and the PERCENTILE-th latency of its requests in ms."""
    if not len(win.t1):
        return {"qps": 0.0, "p95_ms": float("nan")}
    span = max(float(win.t1.max()) - win.start, seconds * 1e-3)
    lat = (win.t1 - win.t0) * 1e3
    return {"qps": float(win.nq[win.ok].sum()) / span,
            "p95_ms": float(np.percentile(lat, PERCENTILE))}


def traced_requests(win, tracer) -> np.ndarray:
    """Indices of the window's requests issued and answered inside the
    traced part of the window."""
    if tracer.t0 is None:
        return np.zeros(0, np.int64)
    return np.nonzero((win.t0 >= tracer.t0) & (win.t1 <= tracer.t1))[0]


def device_info(dev, chips: int, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": int(peak)}
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": int(chips), "memory_peak_bytes": int(peak)}


OPS = {"<": np.less, "<=": np.less_equal, ">": np.greater,
       ">=": np.greater_equal, "=": np.equal, "!=": np.not_equal}


def keep_mask(where: list, attributes: dict, n: int) -> np.ndarray:
    """Rows that pass every [column, op, value] of a filter."""
    keep = np.ones(n, bool)
    for col, op, value in where:
        keep &= OPS[op](attributes[col], value)
    return keep


def _blocks(ref, qidx: np.ndarray, keep: np.ndarray, k: int, pairs=None):
    """For each block of the unique pool queries in qidx: the reference's
    distances, and the k nearest rows that `keep` passes (ids and their
    distances at the reference's precision). With pairs = (rows' pool
    queries [m], ids [m, k]), also each pair's distance and scale."""
    import torch

    uq = np.unique(qidx)
    top_ids = np.empty((len(uq), k), np.int64)
    top_d = np.empty((len(uq), k))
    if pairs is not None:
        pq, pids = pairs
        exact = np.full(pids.shape, np.nan)
        scale = np.full(pids.shape, np.nan)
    for s in range(0, len(uq), ref.block):
        b = uq[s:s + ref.block]
        d, sc = ref.distances(b)
        if pairs is not None:
            sel = np.nonzero(np.isin(pq, b))[0]
            col = torch.from_numpy(np.searchsorted(b, pq[sel])).to(d.device)
            rows = torch.from_numpy(np.clip(pids[sel], 0, d.shape[0] - 1)).to(
                d.device)
            exact[sel] = d[rows, col[:, None]].double().cpu().numpy()
            if sc is not None:
                scale[sel] = sc[rows, col[:, None]].double().cpu().numpy()
        mask = torch.from_numpy(~keep).to(d.device)
        d.masked_fill_(mask[:, None], float("inf"))
        v, i = torch.topk(d, k, dim=0, largest=False)
        top_ids[s:s + len(b)] = i.T.cpu().numpy()
        top_d[s:s + len(b)] = v.T.double().cpu().numpy()
        del d, sc, v, i
    if pairs is None:
        return uq, top_ids, top_d
    if np.isnan(scale).all():
        scale = np.abs(exact)
    return uq, top_ids, top_d, exact, scale


def judge(ref, data: dict, cfg: dict, mix: dict, win) -> tuple:
    """The numbers compared, each with its limit, and the mean recall@10:
    failed (requests that failed or returned other than k rows), bad_rows
    (returned rows out of range, repeated in an answer, or failing the
    request's filter), dist_err (the largest |reported - reference distance
    of that row| / scale: the distance itself for L2, sum |q_i x_i| for an
    inner product) and recall_miss (1 - mean recall@k against the
    reference's k nearest rows that pass the filter)."""
    n, k, limits = data["n"], cfg["k"], cfg["limits"]
    ok = win.ok
    failed = int((~win.ok).sum())
    bad = 0
    hits = 0
    err = 0.0
    checked = 0
    for fi, f in enumerate(mix["filters"]):
        rows = np.nonzero(ok & (win.filt == fi))[0]
        if not len(rows):
            continue
        keep = keep_mask(f["where"], data["attributes"], n)
        ids, qidx = win.ids[rows], win.pool[rows]
        inr = (ids >= 0) & (ids < n)
        srt = np.sort(ids, axis=1)
        dup = np.zeros_like(inr)
        dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
        bad += int((~inr).sum() + dup.sum()
                   + (inr & ~keep[np.clip(ids, 0, n - 1)]).sum())
        uq, top, _, exact, scale = _blocks(ref, qidx, keep, k, (qidx, ids))
        want = top[np.searchsorted(uq, qidx)]
        hits += int((ids[:, :, None] == want[:, None, :]).any(2).sum())
        checked += len(rows)
        gap = np.abs(win.dists[rows] - exact)
        rel = np.where(gap == 0, 0.0, gap / np.where(scale > 0, scale, 1e-300))
        rel = np.where(inr, rel, 0.0)
        if rel.size:
            err = max(err, float(np.nan_to_num(rel, nan=np.inf).max()))
    recall = hits / (k * checked) if checked else 0.0
    values = {"failed": failed, "bad_rows": bad, "dist_err": err,
              "recall_miss": 1.0 - recall}
    return ({name: {"value": values[name], "limit": limits[name]}
             for name in ("failed", "bad_rows", "dist_err", "recall_miss")},
            recall)


def control_window(low, data: dict, cfg: dict, mix: dict, win):
    """The window with every checked answer replaced by the control's: the
    reference at the configuration's lower precision, put in the program's
    place for the same pool queries and filters."""
    import dataclasses

    k = cfg["k"]
    ids = np.full(win.ids.shape, -1, np.int64)
    dists = np.full(win.dists.shape, np.nan)
    for fi, f in enumerate(mix["filters"]):
        rows = np.nonzero(win.ok & (win.filt == fi))[0]
        if not len(rows):
            continue
        keep = keep_mask(f["where"], data["attributes"], data["n"])
        uq, top, top_d = _blocks(low, win.pool[rows], keep, k)
        at = np.searchsorted(uq, win.pool[rows])
        ids[rows], dists[rows] = top[at], top_d[at]
    return dataclasses.replace(win, ids=ids, dists=dists)
