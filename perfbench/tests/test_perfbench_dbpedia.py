"""dbpedia1m.single at CPU sizes: a traced run reports the query's
normalization (normalize_us.single) beside the other stages, the walk's
device time (walk_us.single) is read from the kernels' names, and the
comparison fails the TF32 control and a broken timed path, at the tiny
width and at the configuration's 1,536 columns."""
import copy
import time
import types

import numpy as np
import pytest

from perfbench import harness, spans, trace
from perfbench.tests.conftest import run_tiny, spec, tiny
from perfbench.tests.test_perfbench_cells import _alter_search_ids, failing

CELL = "dbpedia1m.single"
STAGES = ("api_self_us.single", "project_us.single", "mask_us.single",
          "dispatch_us.single", "device_wait_us.single", "rerank_us.single",
          "normalize_us.single")


def test_traced_run_reads_the_normalization(monkeypatch):
    read = spans.read
    seen = []
    monkeypatch.setattr(spans, "read",
                        lambda prof: seen.append(read(prof)) or seen[-1])
    out = run_tiny(CELL, trace=True)
    assert out["correct"]
    got = {n: out["metrics"][n]["value"] for n in STAGES}
    assert all(v > 0 for v in got.values()), got
    s = seen[-1]
    total = sum(got.values()) + s.per_query_us("vdb.gc")
    assert total == pytest.approx(s.search_ns / s.queries / 1e3, rel=0.01)
    assert "walk_us.single" not in out["metrics"]  # no device on the CPU


def test_readers_find_nothing_where_nothing_ran():
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            with torch.profiler.record_function("vdb.search"):
                torch.zeros(4).sum()
    ctx = types.SimpleNamespace(tracer=types.SimpleNamespace(prof=prof))
    assert harness.load_module("layer_metrics",
                               "normalize_us.single").read(ctx) is None
    walk = harness.load_module("layer_metrics", "walk_us.single")
    window = types.SimpleNamespace(nq=np.ones(4, np.int64))
    none = trace.Reading(1.0, 0.5, {"void gemv2T_kernel_val<int>": 0.5},
                         {"void gemv2T_kernel_val<int>": 4}, [])
    assert walk.read(types.SimpleNamespace(
        reading=none, window=window, traced=[0, 1, 2, 3])) is None
    assert walk.read(types.SimpleNamespace(
        reading=None, window=window, traced=[0, 1])) is None


def test_walk_reader_sums_both_variants():
    walk = harness.load_module("layer_metrics", "walk_us.single")
    ns = "void (anonymous namespace)::"
    names = {ns + "beam_block_kernel<__nv_bfloat16, false>(Args)": 3e-4,
             ns + "beam_warp_kernel<__nv_bfloat16, false>(Args)": 1e-4,
             "void gemv2T_kernel_val<int, int, float>()": 5e-4}
    r = trace.Reading(1.0, 0.5, names, {k: 2 for k in names}, [])
    ctx = types.SimpleNamespace(reading=r, window=types.SimpleNamespace(
        nq=np.ones(10, np.int64)), traced=np.arange(4))
    assert walk.read(ctx) == pytest.approx(1e6 * 4e-4 / 4)


def test_a_broken_timed_path_fails(monkeypatch):
    _alter_search_ids(monkeypatch)
    out = run_tiny(CELL)
    assert not out["correct"] and failing(out["checks"])


def test_the_full_width_agrees_and_its_control_fails():
    """1,536 columns, as the configuration states, at 2,000 rows: the
    program's distances pass the comparison, the TF32 control's fail
    dist_err."""
    import torch

    cfg, mix = tiny(CELL)
    full = harness.cell_files(spec(), CELL)[1]
    cfg = copy.deepcopy(cfg)
    cfg.update(rows=2000, dim=full["dim"])
    mix["pool"] = 64
    out = harness.run_cell(CELL, 2 ** 32 + 5, 1.0, False, torch.device("cpu"),
                           time.monotonic(), spec=spec(), cfg=cfg, mix=mix,
                           control=True)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert "dist_err" in failing(out["control"]), out["control"]


@pytest.mark.gpu
def test_traced_run_on_the_card_reads_the_walk():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, mix = tiny(CELL)
    out = harness.run_cell(CELL, 2 ** 31 + 3, 2.0, True,
                           torch.device("cuda", 0), time.monotonic(),
                           spec=spec(), cfg=cfg, mix=mix)
    assert out["correct"]
    assert out["metrics"]["walk_us.single"]["value"] > 0
    assert out["metrics"]["normalize_us.single"]["value"] > 0
