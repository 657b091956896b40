"""Each cell's traffic at a tiny size on the port's CPU route: the timed
path's answers agree with the plain reference, the control (the reference
in the precision below the configuration's) fails the comparison, and so
does a run with the timed path broken underneath."""
import numpy as np
import pytest

from perfbench import harness
from perfbench.tests.conftest import run_tiny, spec, tiny

WORKLOADS = [w["name"] for w in spec()["workloads"]]


def failing(checks: dict) -> list:
    return [n for n, c in checks.items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_agrees_and_its_control_fails(workload):
    out = run_tiny(workload, control=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    want = {m["name"] for m in spec()["end_to_end"]
            if harness.applies(m, workload)}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["metrics"]["recall_at_10"]["value"] >= 0.99
    assert "dist_err" in failing(out["control"]), out["control"]


def test_same_seed_same_inputs():
    import torch

    cfg, mix = tiny("sift1m.single")
    gen = harness.load_module("generators", cfg["generator"])
    a = gen.make(cfg, 2 ** 31 + 11, torch.device("cpu"), 64)
    b = gen.make(cfg, 2 ** 31 + 11, torch.device("cpu"), 64)
    c = gen.make(cfg, 2 ** 31 + 12, torch.device("cpu"), 64)
    assert np.array_equal(a["raw"]["x"], b["raw"]["x"])
    assert np.array_equal(a["queries"], b["queries"])
    assert np.array_equal(a["raw"]["x"], c["raw"]["x"])
    assert not np.array_equal(a["queries"], c["queries"])


@pytest.mark.parametrize("workload", ["sift1m.single", "splade1m.single"])
def test_traced_run(workload):
    out = run_tiny(workload, trace=True)
    assert out["correct"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert out["device"]["window_s"] > 0
    assert {"device_ops", "idle_gaps"} == set(out["breakdown"])
    if workload == "sift1m.single":
        assert {"build.knn_s", "build.prune_s"} <= set(out["metrics"])


def _alter_search_ids(monkeypatch):
    """An answer altered where it is produced: each query's last row
    replaced by the next row id."""
    from vectordb_tpu_torch import table as table_mod

    real = table_mod.Table._search_ids

    def altered(self, *a, **kw):
        ids, d = real(self, *a, **kw)
        ids = ids.copy()
        ids[-1] = (ids[-1] + 1) % self.segment.record_number
        return ids, d

    monkeypatch.setattr(table_mod.Table, "_search_ids", altered)


@pytest.mark.parametrize("workload", ["sift1m.single", "splade1m.single"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload):
    _alter_search_ids(monkeypatch)
    out = run_tiny(workload)
    assert not out["correct"]
    assert failing(out["checks"])
