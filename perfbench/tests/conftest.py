"""CPU tests of the benchmark (python -m pytest perfbench/tests -q). Cells
run here at tiny sizes on the port's CPU route; tests marked gpu skip
without a card."""
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


def spec() -> dict:
    from perfbench import harness

    return copy.deepcopy(harness.load_spec())


def tiny(workload: str):
    """The cell's configuration and traffic mix cut to a CPU test's size
    (the widths too: these are no cells)."""
    from perfbench import harness

    _, cfg, mix = harness.cell_files(spec(), workload)
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    if cfg["generator"] == "latent":
        cfg.update(rows=4000, dim=32, latent_dim=8, centers=30)
        cfg["engine"] = dict(cfg["engine"], FlatServe="off")
    else:
        cfg.update(rows=2000, vocab=500, draws_per_row=40, query_terms=8)
    mix["pool"] = 512
    return cfg, mix


def run_tiny(workload: str, seed: int = 1234567890123, trace: bool = False,
             seconds: float = 1.0, control: bool = False) -> dict:
    import time

    import torch

    from perfbench import harness

    cfg, mix = tiny(workload)
    return harness.run_cell(workload, seed, seconds, trace,
                            torch.device("cpu"), time.monotonic(),
                            spec=spec(), cfg=cfg, mix=mix, control=control)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
