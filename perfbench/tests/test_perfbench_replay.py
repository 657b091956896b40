"""perfbench/layer_metrics/cuda_graph_replay_pct.single.py: the count of
replay ranges inside the window's queries on hand-built ranges, the share
read from a profile, and nothing read without a profile."""
import types

from perfbench import harness


def test_replay_share_counts_replays_inside_the_window_queries():
    replay = harness.load_module("layer_metrics",
                                 "cuda_graph_replay_pct.single")
    ranges = [
        # thread 1: two queries inside the window, one replayed
        (1, 200, 300, "vdb.search"),
        (1, 210, 290, "vdb.table.dispatch"),
        (1, 250, 260, "vdb.table.replay"),
        (1, 300, 400, "vdb.search"),
        (1, 310, 390, "vdb.table.dispatch"),
        # a query cut by the window's start, replayed: not counted
        (1, 50, 150, "vdb.search"),
        (1, 120, 130, "vdb.table.replay"),
        # thread 2: a replayed query, and a replay outside any query
        (2, 500, 600, "vdb.search"),
        (2, 550, 560, "vdb.table.replay"),
        (2, 700, 710, "vdb.table.replay"),
    ]
    assert replay.count(ranges, 100, 1000) == (3, 2)
    assert replay.count([], 0, 10) == (0, 0)


def test_replay_share_reads_the_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench.trace import WINDOW_SPAN

    rf = torch.profiler.record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rf(WINDOW_SPAN):
            for replayed in (True, False, True, True):
                with rf("vdb.search"), rf("vdb.table.dispatch"):
                    if replayed:
                        with rf("vdb.table.replay"):
                            torch.zeros(4).sum()
    ctx = types.SimpleNamespace(tracer=types.SimpleNamespace(prof=prof))
    read = harness.load_module("layer_metrics",
                               "cuda_graph_replay_pct.single").read
    assert read(ctx) == 75.0
    assert read(types.SimpleNamespace(
        tracer=types.SimpleNamespace(prof=None))) is None
