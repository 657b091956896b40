"""What the harness and the references load, by whole top-level module name:
never JAX or the JAX package, and the references nothing of the program."""
import json
import subprocess
import sys
import types

from perfbench import harness

LOAD_ALL = """
import json, os, sys
sys.path.insert(0, {root!r})
from perfbench import harness, loadgen, run, control, trace
for kind in ("generators", "reference", "layer_metrics", "modes"):
    for f in sorted(os.listdir(os.path.join(harness.HERE, kind))):
        if f.endswith(".py") and f != "__init__.py":
            harness.load_module(kind, f[:-3])
import vectordb_tpu_torch
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCES = """
import json, os, sys
sys.path.insert(0, {root!r})
import importlib.util
d = os.path.join({root!r}, "perfbench", "reference")
for f in sorted(os.listdir(d)):
    if f.endswith(".py"):
        spec = importlib.util.spec_from_file_location("ref_" + f[:-3],
                                                      os.path.join(d, f))
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(script: str) -> set:
    out = subprocess.run([sys.executable, "-c",
                          script.format(root=harness.ROOT)],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = loaded(LOAD_ALL)
    assert "vectordb_tpu_torch" in names
    assert not names & set(harness.FORBIDDEN)


def test_references_load_nothing_of_the_program():
    names = loaded(LOAD_REFERENCES)
    assert "torch" in names
    assert not names & (set(harness.FORBIDDEN) | {"vectordb_tpu_torch",
                                                  "perfbench"})


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "vectordb_tpu_torch_like",
                        types.ModuleType("vectordb_tpu_torch_like"))
    monkeypatch.setitem(sys.modules, "jaxlibrary",
                        types.ModuleType("jaxlibrary"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vectordb_tpu.ops",
                        types.ModuleType("vectordb_tpu.ops"))
    assert harness.forbidden_modules() == ["vectordb_tpu"]
