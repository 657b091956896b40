"""BENCHMARK.json against the rules it is checked by, and every file a cell
names found by name."""
import os
import re

import pytest

from perfbench import harness, loadgen

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               and os.path.isdir(os.path.join(harness.ROOT, p))
               for p in SPEC["paths"])
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(line_ok(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_entry_keys():
    assert all(set(c) == {"name", "source", "file", "reduced", "why"}
               for c in SPEC["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"}
               for w in SPEC["workloads"])
    assert all(set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
               for m in SPEC["end_to_end"])
    assert all(set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
               for m in SPEC["per_layer"])


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in SPEC[group]:
            assert NAME.match(item["name"]), item["name"]
            names.append((group, item["name"]))
            for key in ("why", "layer", "source"):
                if key in item:
                    assert line_ok(item[key]), (item["name"], key)
    assert len(set(names)) == len(names)
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert harness.entry(SPEC["end_to_end"], "setup_s")["bound"] <= 0.25


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_are_found(workload):
    cell, cfg, mix = harness.cell_files(SPEC, workload)
    for kind in ("generators", "reference"):
        key = "generator" if kind == "generators" else "reference"
        assert os.path.isfile(os.path.join(harness.HERE, kind,
                                           cfg[key] + ".py"))
    assert os.path.isfile(os.path.join(harness.HERE, "modes",
                                       mix["mode"] + ".py"))
    mod = loadgen.mode_module(mix["mode"])
    assert set(mix) == loadgen.COMMON_KEYS | mod.KEYS
    e2e = [m["name"] for m in SPEC["end_to_end"]
           if harness.applies(m, workload)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in SPEC["per_layer"] if harness.applies(m, workload)]
    assert layer
    for m in layer:
        assert os.path.isfile(os.path.join(harness.HERE, "layer_metrics",
                                           m["name"] + ".py"))
        assert m["moves"] in e2e


def test_configs_match_their_files():
    for c in SPEC["configs"]:
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        cfg = harness.load_json(harness.ROOT, c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
        assert set(cfg["limits"]) == {"failed", "bad_rows", "dist_err",
                                      "recall_miss"}
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_layer_names_agree():
    by_layer = {}
    for m in SPEC["per_layer"]:
        by_layer.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_committed_file_names():
    for p in SPEC["paths"]:
        for dirpath, dirs, files in os.walk(os.path.join(harness.ROOT, p)):
            dirs[:] = [d for d in dirs if d not in ("__pycache__", "_cache")]
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), harness.ROOT)
                assert PATH.match(rel), rel
