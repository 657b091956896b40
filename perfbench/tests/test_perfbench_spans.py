"""perfbench/spans.py: the self-time arithmetic on a hand-built nesting,
the seven metrics that read the program's spans in a traced run of each
cell, and nothing read (no error) from a program that records no span."""
import types

import pytest

from perfbench import harness, spans
from perfbench.tests.conftest import run_tiny, spec

STAGES = ("api_self_us.single", "project_us.single", "mask_us.single",
          "dispatch_us.single", "device_wait_us.single", "rerank_us.single")
METRICS = STAGES + ("gc_pause_pct.single",)


def test_self_time_arithmetic():
    ranges = [
        # thread 1: a query inside the window, a collection in its re-rank
        (1, 200, 600, "vdb.search"),
        (1, 210, 260, "vdb.table.mask"),
        (1, 260, 290, "vdb.table.dispatch"),
        (1, 300, 500, "vdb.table.rerank"),
        (1, 350, 400, "vdb.gc"),
        # queries cut by the window's edges: not counted
        (1, 50, 150, "vdb.search"),
        (1, 60, 70, "vdb.table.mask"),
        (1, 900, 1100, "vdb.search"),
        # thread 2: a query while thread 1 is idle, a collection cut by
        # the window's end
        (2, 700, 800, "vdb.search"),
        (2, 750, 790, "vdb.table.project"),
        (2, 950, 1050, "vdb.gc"),
        # thread 3: a collection overlapping thread 1's
        (3, 380, 420, "vdb.gc"),
    ]
    s = spans.summarise(ranges, 100, 1000)
    assert (s.queries, s.search_ns, s.window_ns) == (2, 500, 900)
    assert s.self_ns == {"vdb.search": 120 + 60, "vdb.table.mask": 50,
                         "vdb.table.dispatch": 30, "vdb.table.rerank": 150,
                         "vdb.gc": 50, "vdb.table.project": 40}
    assert sum(s.self_ns.values()) == s.search_ns
    assert s.gc_ns == 70 + 50  # [350, 420] and [950, 1000]
    assert s.per_query_us("vdb.table.rerank") == 150 / 2 / 1e3
    assert s.per_query_us("vdb.table.fetch") == 0.0


def test_no_search_inside_the_window_reads_nothing():
    assert spans.summarise([], 0, 10) is None
    assert spans.summarise([(1, 5, 20, "vdb.search"),
                            (1, 6, 7, "vdb.gc")], 0, 10) is None
    assert spans.read(None) is None


def test_a_program_without_spans_reads_nothing():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench.trace import WINDOW_SPAN

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            with torch.profiler.record_function("bench.call"):
                torch.zeros(4).sum()
    ctx = types.SimpleNamespace(tracer=types.SimpleNamespace(prof=prof))
    for name in METRICS:
        assert harness.load_module("layer_metrics", name).read(ctx) is None


@pytest.mark.parametrize("workload", ["sift1m.single", "splade1m.single"])
def test_traced_run_reads_every_stage(monkeypatch, workload):
    read = spans.read
    seen = []

    def keep(prof):
        s = read(prof)
        seen.append(s)
        return s

    monkeypatch.setattr(spans, "read", keep)
    out = run_tiny(workload, trace=True)
    assert out["correct"]
    picked = {m["name"] for m in spec()["per_layer"]
              if harness.applies(m, workload)}
    assert set(METRICS) <= picked & set(out["metrics"])
    got = {n: out["metrics"][n]["value"] for n in METRICS}
    assert all(isinstance(v, float) for v in got.values())
    assert got["gc_pause_pct.single"] >= 0
    assert all(got[n] > 0 for n in STAGES), got
    s = seen[-1]
    assert s.queries > 0
    total = sum(got[n] for n in STAGES) + s.per_query_us("vdb.gc")
    assert total == pytest.approx(s.search_ns / s.queries / 1e3, rel=0.01)
