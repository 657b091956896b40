"""Where the partial-min kernel's time goes, on one CUDA card.

    python -m vectordb_tpu_torch.partial_min_attribution

Builds csrc/partial_min.cu four times (nvcc, sm_90a, into _build/): as it
is, without the tensor-core product (VDB_ATTRIBUTION_NO_PRODUCT), without
the fold (VDB_ATTRIBUTION_NO_FOLD) and without both, which leaves the TMA
ring, the barriers and the survivor stores. The variants without a part
compute wrong survivors; only their times mean something. Checks the
full build against partial_min_scan_ref, then prints the card's name and
power limit and one JSON line per variant: the median of 7 CUDA-event
timings of one launch at the flat-serve shape (B = 8192, N = 262,144) and
at one exact-KNN block (B = 1,024, N = 1,048,576), D = 128 and 256, L2.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from . import _cuda_build
from .ops import partial_min

VARIANTS = {"full": [], "no_product": ["-DVDB_ATTRIBUTION_NO_PRODUCT"],
            "no_fold": ["-DVDB_ATTRIBUTION_NO_FOLD"],
            "neither": ["-DVDB_ATTRIBUTION_NO_PRODUCT",
                        "-DVDB_ATTRIBUTION_NO_FOLD"]}
SHAPES = {"flat_serve": (8192, 262_144, 128), "knn_block": (1024, 1_048_576,
                                                          128),
          "flat_serve_d256": (8192, 262_144, 256)}


def build(name: str) -> ctypes.CDLL:
    os.makedirs(_cuda_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_cuda_build.BUILD_DIR, f"attribution-{name}.so")
    src = os.path.join(_cuda_build.CSRC_DIR, "partial_min.cu")
    proc = subprocess.run([_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS,
                           *VARIANTS[name], "-o", out, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-3000:]}")
    fn = ctypes.CDLL(out).vdb_partial_min
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    return fn


def launcher(fn, dev, b: int, n: int, d: int, seed: int = 0):
    """A no-argument call of `fn` on seeded bf16 data (L2, every row
    valid) and the tensors it writes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=dev).bfloat16()
    q = x[:b].clone()
    qn = (q.float() ** 2).sum(1)
    nrm = (x.float() ** 2).sum(1)
    mask = torch.ones(n, device=dev)
    metric = 1
    term = partial_min.column_term(nrm, mask, n, metric)
    tc = partial_min.pick_tile_c(d)
    gcols = n // (tc // 128)
    vals = torch.empty((b, 2 * gcols), device=dev)
    ids = torch.empty((b, 2 * gcols), device=dev, dtype=torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        rc = fn(q.data_ptr(), qn.data_ptr(), x.data_ptr(), nrm.data_ptr(),
                mask.data_ptr(), term.data_ptr(), vals.data_ptr(),
                ids.data_ptr(), b, n, d, tc, n, metric, 0, 0, 1, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    return call, (q, qn, x, nrm, mask), (vals, ids)


def median_ms(call, reps: int = 7) -> float:
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        call()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[reps // 2]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("partial_min_attribution: no CUDA device")
    dev = torch.device("cuda", 0)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        fns = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    call, (q, qn, x, nrm, mask), (vals, ids) = launcher(
        fns["full"], dev, 256, 16384, 128, seed=1)
    call()
    vp, ip = partial_min.partial_min_scan_ref(q, qn, 0, x, nrm, 1, 16384,
                                              mask=mask)
    atol = 1e-5 * float(qn.max() + nrm.max())
    if not torch.allclose(vals, vp, rtol=1e-5, atol=atol):
        raise AssertionError("the full build differs from the plain scan")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for shape, (b, n, d) in SHAPES.items():
        row = {"shape": shape, "b": b, "n": n, "d": d}
        for name, fn in fns.items():
            row[name + "_ms"] = median_ms(launcher(fn, dev, b, n, d)[0])
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
