"""cohere1m.filter99 at CPU sizes: every query of the window takes the exact
masked flat scan under the device filter, the comparison passes the program
and fails the TF32 control at the configuration's 768 columns, and a traced
run reads the filter's stage (filter_us.single); the filtered scan's
roofline (filter_scan_roofline) is read from a device trace, so it is
checked here on a made-up reading and on the card by the gpu test."""
import copy
import time
import types

import numpy as np
import pytest

from perfbench import harness, trace
from perfbench.tests.conftest import run_tiny, spec, tiny
from perfbench.tests.test_perfbench_cells import _alter_search_ids, failing

CELL = "cohere1m.filter99"
STAGES = ("api_self_us.single", "project_us.single", "mask_us.single",
          "dispatch_us.single", "device_wait_us.single", "rerank_us.single",
          "normalize_us.single", "filter_us.single")
ROUTE = ("filter_route_flat_total", "filter_route_walk_total",
         "filter_match_rows_total")


def _counters():
    from vectordb_tpu_torch.metrics import metrics

    c = metrics.snapshot()["counters"]
    return np.array([c.get(name, 0.0) for name in ROUTE])


def _kept():
    """Rows of the tiny cell's data that its one filter keeps."""
    import torch

    cfg, mix = tiny(CELL)
    data = harness.load_module("generators", cfg["generator"]).make(
        cfg, 1, torch.device("cpu"), 8)
    (f,) = mix["filters"]
    return int(harness.keep_mask(f["where"], data["attributes"],
                                 data["n"]).sum())


def test_every_query_takes_the_flat_scan_under_the_filter():
    cfg, mix = tiny(CELL)
    kept = _kept()
    assert 10 <= kept and kept * 8 < cfg["rows"]
    before = _counters()
    out = run_tiny(CELL)
    assert out["correct"], out["checks"]
    queries = out["attempted"] + mix["warmup_requests"]
    assert (_counters() - before).tolist() == [queries, 0, kept * queries]


def test_a_broken_timed_path_fails(monkeypatch):
    _alter_search_ids(monkeypatch)
    out = run_tiny(CELL)
    assert not out["correct"] and failing(out["checks"])


def test_the_full_width_agrees_and_its_control_fails():
    """768 columns, as the configuration states, at 2,000 rows: the
    program's distances pass the comparison, the TF32 control's fail
    dist_err."""
    import torch

    cfg, mix = tiny(CELL)
    full = harness.cell_files(spec(), CELL)[1]
    cfg = copy.deepcopy(cfg)
    cfg.update(rows=2000, dim=full["dim"])
    mix["pool"] = 64
    out = harness.run_cell(CELL, 2 ** 33 + 7, 1.0, False, torch.device("cpu"),
                           time.monotonic(), spec=spec(), cfg=cfg, mix=mix,
                           control=True)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert "dist_err" in failing(out["control"]), out["control"]


def test_traced_run_reads_the_filter_stage():
    out = run_tiny(CELL, trace=True)
    assert out["correct"]
    got = {n: out["metrics"][n]["value"] for n in STAGES}
    assert all(v > 0 for v in got.values()), got
    # No device on the CPU: no device time, so no roofline.
    assert "filter_scan_roofline" not in out["metrics"]
    assert out["device"]["busy_s"] == 0.0


def _profile(names):
    """A stopped CPU profiler holding the window span around `names`,
    nested in that order."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            with contextlib.ExitStack() as stack:
                for name in names:
                    stack.enter_context(torch.profiler.record_function(name))
                torch.zeros(4).sum()
    return prof


def _ctx(prof, busy_s, doc_id, dim=768, queries=4):
    return types.SimpleNamespace(
        tracer=types.SimpleNamespace(prof=prof),
        reading=trace.Reading(1.0, busy_s, {}, {}, []),
        window=types.SimpleNamespace(nq=np.ones(queries, np.int64)),
        traced=np.arange(queries),
        data={"attributes": {"doc_id": doc_id}, "stats": {"dim": dim}})


def test_readers_find_nothing_where_no_filter_ran():
    doc_id = np.arange(1_000_000)
    plain = _profile(["vdb.search"])
    for name in ("filter_us.single", "filter_scan_roofline"):
        mod = harness.load_module("layer_metrics", name)
        assert mod.read(_ctx(plain, 0.5, doc_id)) is None
    roof = harness.load_module("layer_metrics", "filter_scan_roofline")
    filtered = _profile(["vdb.search", "vdb.table.filter"])
    assert roof.read(_ctx(filtered, 0.0, doc_id)) is None  # no device time
    assert roof.read(types.SimpleNamespace(**{
        **vars(_ctx(filtered, 0.5, doc_id)),
        "data": {"attributes": {}, "stats": {"dim": 768}}})) is None


def test_roofline_reads_the_kept_rows_bytes():
    roof = harness.load_module("layer_metrics", "filter_scan_roofline")
    doc_id = np.arange(1_000_000)  # keeps 10,000 rows
    prof = _profile(["vdb.search", "vdb.table.filter"])
    least_s = (2 * 10_000 * 768 + 4 * 768) / 3.35e12
    # Four queries in 4 * least_s of device time: the bound itself.
    assert roof.read(_ctx(prof, 4 * least_s, doc_id)) == pytest.approx(100.0)
    # A scan of every row takes at least every row's bytes: about the kept
    # share of the bound.
    every_s = 2 * 1_000_000 * 768 / 3.35e12
    assert roof.read(_ctx(prof, 4 * every_s, doc_id)) == pytest.approx(
        1.0, rel=1e-3)


@pytest.mark.gpu
def test_traced_run_on_the_card_reads_the_roofline():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, mix = tiny(CELL)
    out = harness.run_cell(CELL, 2 ** 31 + 9, 2.0, True,
                           torch.device("cuda", 0), time.monotonic(),
                           spec=spec(), cfg=cfg, mix=mix)
    assert out["correct"]
    assert out["metrics"]["filter_us.single"]["value"] > 0
    assert 0 < out["metrics"]["filter_scan_roofline"]["value"] <= 100
