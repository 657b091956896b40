"""The benchmark of vectordb_tpu_torch: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cell's NVIDIA GPUs. The
cell's configuration, traffic and metrics are found by name from
BENCHMARK.json (harness.py). Prints, as the last line of standard output,
{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
"checks"}: with --trace 0 the cell's end-to-end metrics, with --trace 1 its
per-layer metrics from a profiler trace of the window's first seconds;
"checks" holds each number compared with the plain reference beside its
limit, which also end standard error. Exits non-zero without a result when
PyTorch sees fewer CUDA devices than the cell asks for, or when JAX or the
JAX package was loaded. Build and kernel caches stay in the checkout.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}
# Few host threads, so that a run's load is one process's and steady.
HOST_THREADS = 4
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def pin_caches() -> None:
    """Every build and kernel cache at a fixed directory of the checkout,
    and HOST_THREADS host threads for numpy's and PyTorch's CPU work."""
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "perfbench", "_cache", sub)
    for var in THREAD_VARS:
        os.environ[var] = str(HOST_THREADS)


def print_checks(checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_caches()
    sys.path.insert(0, ROOT)
    from perfbench import harness

    cell = harness.entry(harness.load_spec()["workloads"], args.workload)
    import torch

    torch.set_num_threads(HOST_THREADS)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              "device(s); PyTorch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0), T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: modules the benchmark must not load: {bad}",
              file=sys.stderr)
        return 3
    print_checks(out["checks"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
