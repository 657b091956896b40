"""The row-gather kernel as built against another source of it, on one CUDA
card, in device time only.

    python3 gather_variants.py [--baseline FILE.cu]

Run it from the root of a checkout, as beam_profile.py: it imports that
checkout's vectordb_tpu_torch. Builds vectordb_tpu_torch/csrc/
gather_rows.cu and, with --baseline, another source with the same
`vdb_gather_rows` C entry point (an earlier design of the kernel, say)
as plain-C libraries (nvcc, sm_90a, into _build/; one nvcc each, started
together). At each shape of ops/gather.MAIN_PATH_SHAPES (ids from -2 to
N + 1, so the clamp works) both are held bit for bit against
gather_rows_ref. Prints the card's name and power limit, then one JSON line
a shape with `<name>_ms`, the device time of one launch (the median of 5
replays of a CUDA graph of 20 launches, so no host time is in it), and
`<name>_pct`, its share of `bound_ms`, for `built`, `baseline`, `op` (the
port's operator, ops/gather.gather_rows) and `index_select` on clamped ids.
chip_smoke.py times the operator from a stream and its host time a call.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from vectordb_tpu_torch import _cuda_build
from vectordb_tpu_torch.ops import gather, partial_min

GRAPH_LAUNCHES = 20


def build(name: str, src: str):
    """The vdb_gather_rows entry point of `src`, built as `name`, typed."""
    os.makedirs(_cuda_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_cuda_build.BUILD_DIR, f"gather-{name}.so")
    proc = subprocess.run([_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS,
                           "-o", out, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-3000:]}")
    fn = ctypes.CDLL(out).vdb_gather_rows
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [
        ctypes.c_void_p]
    return fn


def graph_ms(call) -> float:
    """Device ms of one call: the median of 5 replays of a CUDA graph of
    GRAPH_LAUNCHES calls, over GRAPH_LAUNCHES."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(GRAPH_LAUNCHES):
            call()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / GRAPH_LAUNCHES)
    del g
    return statistics.median(times)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", help="another gather_rows.cu to time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gather_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    sources = {"built": os.path.join(_cuda_build.CSRC_DIR, "gather_rows.cu")}
    if args.baseline:
        sources["baseline"] = args.baseline
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        op_built = pool.submit(_cuda_build.build_all)
        futs = {name: pool.submit(build, name, src)
                for name, src in sources.items()}
        fns = {name: f.result() for name, f in futs.items()}
        op_built.result()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    g = torch.Generator(device=dev).manual_seed(2)
    for name, dtype, shape, n_ids in gather.MAIN_PATH_SHAPES:
        n = shape[0]
        if dtype.is_floating_point:
            tab = torch.randn(shape, generator=g, device=dev).to(dtype)
        else:
            tab = torch.randint(-100, 100, shape, generator=g, device=dev,
                                dtype=dtype)
        ids = torch.randint(-2, n + 2, (n_ids,), generator=g, device=dev,
                            dtype=torch.int32)
        ids_c = ids.clamp(0, n - 1).long()
        ref = gather.gather_rows_ref(tab, ids)
        rb = gather._row_bytes(tab)
        bound, _ = partial_min.bound_ms(0, gather.gather_cost(n_ids, rb))
        row = {"shape": name, "table": list(shape), "dtype": str(dtype),
               "ids": n_ids, "row_bytes": rb, "bound_ms": bound}
        out = torch.empty_like(ref)
        calls = {}
        for variant, fn in fns.items():
            def call(fn=fn, variant=variant):
                rc = fn(tab.data_ptr(), ids.data_ptr(), out.data_ptr(), n_ids,
                        n, rb, torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{variant}: CUDA error {rc}")
            calls[variant] = call
            out.view(torch.uint8).fill_(0x7F)  # no row of the tables
            call()
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.uint8), ref.view(torch.uint8)):
                raise AssertionError(f"{variant} at {name} differs from the "
                                     "plain version")
        calls["op"] = lambda: gather.gather_rows(tab, ids)
        calls["index_select"] = lambda: tab.index_select(0, ids_c)
        for variant, call in calls.items():
            ms = graph_ms(call)
            row[f"{variant}_ms"] = ms
            row[f"{variant}_pct"] = 100.0 * bound / ms
        print(json.dumps(row), flush=True)
        del tab, ids, ids_c, ref, out, calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
