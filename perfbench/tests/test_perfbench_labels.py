"""cohere1m.label50p at CPU sizes: every query of the window folds its
STRING filter on the host and walks the graph under the folded mask, the
comparison passes the program and fails the TF32 control at the
configuration's 768 columns, a broken timed path fails it, a traced run
reads the fold's and the filter's stages (fold_us.single,
filter_us.single) and no replay, and latent_labels gives latent's
rows and queries bit for bit with labels at their stated shares."""
import copy
import json
import math
import time

import numpy as np
import torch

from perfbench import harness
from perfbench.tests.conftest import spec, tiny
from perfbench.tests.test_perfbench_cells import _alter_search_ids, failing

CELL = "cohere1m.label50p"
ROUTE = ("host_filter_folds_total", "host_fold_route_walk_total",
         "host_fold_route_flat_total")
STAGES = ("api_self_us.single", "project_us.single", "mask_us.single",
          "dispatch_us.single", "rerank_us.single", "normalize_us.single",
          "filter_us.single", "fold_us.single")


def _walk_cut():
    """The cell cut as conftest.tiny cuts a latent cell (4,000 x 32, 30
    centres, FlatServe off), so the graph serves and label_50p walks."""
    cfg, mix = tiny(CELL)
    cfg.update(rows=4000, dim=32, latent_dim=8, centers=30)
    cfg["engine"] = dict(cfg["engine"], FlatServe="off")
    return cfg, mix


def _run(cfg, mix, seed=2 ** 32 + 5, trace=False, control=False):
    return harness.run_cell(CELL, seed, 1.0, trace, torch.device("cpu"),
                            time.monotonic(), spec=spec(), cfg=cfg, mix=mix,
                            control=control)


def _counters():
    from vectordb_tpu_torch.metrics import metrics

    c = metrics.snapshot()["counters"]
    return np.array([c.get(name, 0.0) for name in ROUTE])


def test_every_query_folds_and_walks():
    cfg, mix = _walk_cut()
    before = _counters()
    out = _run(cfg, mix)
    assert out["correct"], out["checks"]
    queries = out["attempted"] + mix["warmup_requests"]
    assert (_counters() - before).tolist() == [queries, queries, 0]


def test_a_broken_timed_path_fails(monkeypatch):
    _alter_search_ids(monkeypatch)
    out = _run(*_walk_cut())
    assert not out["correct"] and failing(out["checks"])


def test_the_full_width_agrees_and_its_control_fails():
    """768 columns, as the configuration states, at 2,000 rows: the
    program's distances pass the comparison, the TF32 control's fail
    dist_err."""
    cfg, mix = tiny(CELL)
    full = harness.cell_files(spec(), CELL)[1]
    cfg = copy.deepcopy(cfg)
    cfg.update(rows=2000, dim=full["dim"])
    mix["pool"] = 64
    out = _run(cfg, mix, seed=2 ** 33 + 9, control=True)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert "dist_err" in failing(out["control"]), out["control"]


def test_traced_run_reads_the_fold_stage():
    out = _run(*_walk_cut(), trace=True)
    assert out["correct"]
    got = {n: out["metrics"][n]["value"] for n in STAGES}
    assert all(v > 0 for v in got.values()), got
    # Every walk runs eager: the folded mask is not cacheable.
    assert out["metrics"]["cuda_graph_replay_pct.single"]["value"] == 0.0
    assert out["device"]["busy_s"] == 0.0  # no device on the CPU


def test_rows_and_queries_are_latents_and_labels_keep_their_shares():
    cfg, _ = _walk_cut()
    dev = torch.device("cpu")
    gen = harness.load_module("generators", "latent_labels")
    a = gen.make(cfg, 2 ** 31 + 3, dev, 64)
    b = harness.load_module("generators", "latent").make(cfg, 2 ** 31 + 3,
                                                         dev, 64)
    assert a["raw"]["x"].tobytes() == b["raw"]["x"].tobytes()
    assert a["queries"].tobytes() == b["queries"].tobytes()
    assert a["schema"][:-1] == b["schema"]
    assert a["schema"][-1] == {"name": "labels", "dataType": "STRING"}
    labels = a["attributes"]["labels"]
    assert labels.dtype == object and {type(s) for s in labels} == {str}
    full = harness.cell_files(spec(), CELL)[1]
    n = full["rows"]
    drawn = gen.draw_labels(full["labels"], n, full["data_seed"])
    assert math.isclose(sum(full["labels"].values()), 1.0)
    for label, share in full["labels"].items():
        got = float(np.count_nonzero(drawn == label)) / n
        # 1% of the share, or four binomial deviations for the rarest.
        tol = max(0.01, 4 * math.sqrt((1 - share) / (n * share)))
        assert abs(got / share - 1) <= tol, (label, got)


def test_the_traffic_filters_on_the_label_half_the_rows_carry():
    cfg = harness.cell_files(spec(), CELL)[1]
    mix = harness.cell_files(spec(), CELL)[2]
    ((_, op, value),) = mix["filters"][0]["where"]
    assert op == "=" and cfg["labels"][value] == 0.5
    assert json.dumps(value) in mix["filters"][0]["filter"].replace("'", '"')
