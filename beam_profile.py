"""Where the beam-iteration kernel's time goes on one CUDA card.

    python3 beam_profile.py [--source FILE.cu] [--tag NAME] [--out DIR]

Builds a beam-iteration source (default vectordb_tpu_torch/csrc/
beam_iter.cu; a parent's copy from its `git archive` to profile the
parent) twice with nvcc, as plain-C libraries loaded with ctypes (its
extern "C" vdb_beam_iter, no PyTorch headers, so each build takes
seconds):
  - as it is: each kernel's registers, local (stack) bytes, static shared
    memory and resident blocks a multiprocessor at the walk's dynamic
    shared memory (cudaFuncGetAttributes,
    cudaOccupancyMaxActiveBlocksPerMultiprocessor, through the source's
    vdb_beam_iter_attrs; a source without one gets PARENT_PROBE), and
    ptxas' -v report;
  - stamped: every `--stamp` token (default `__syncthreads();`) followed
    by a clock64() / %globaltimer stamp of thread 0 of the first STAMP_BLOCKS
    blocks, so the cycles between consecutive stamps are the time of the
    phase between two barriers, by source line. This build is a
    measurement aid only; the shipped library has no stamps.
At the 1M graph phase's walks (chip_smoke.beam_case over 1,000,000
integer-valued bf16 rows of 128, R 48: L 18 x 4 iterations, tw 12, fused
and split cp 96) and at chip_smoke.BEAM_WALK (L 64 x 16), for 2,048
queries and for one, it times one iteration (iteration 1, from the state
after iteration 0) by CUDA-graph replay of a single launch, the restore
of that state replayed alone and subtracted, and reads the stamped
build's phases over the whole walk. Prints the card's name and power
limit and one JSON line a case, and writes the record to
<--out, default .>/beam_profile_<tag>.json.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import tempfile

import torch

import chip_smoke as cs
from vectordb_tpu_torch import _cuda_build

STAMP_BLOCKS, STAMP_CAP = 32, 4096
MAIN_WALK = {"beam_width": 18, "max_iters": 4, "term_width": 12,
             "compact": 96, "expand": 4, "degree": 48, "seeds": 18}
REPLAYS = 200

STAMP_PRELUDE = f"""
#define VDB_NB {STAMP_BLOCKS}
#define VDB_CAP {STAMP_CAP}
__device__ int vdb_stamp_n[VDB_NB];
__device__ long long vdb_stamp_clk[VDB_NB * VDB_CAP];
__device__ long long vdb_stamp_ns[VDB_NB * VDB_CAP];
__device__ int vdb_stamp_line[VDB_NB * VDB_CAP];
__device__ __forceinline__ void vdb_stamp(int line) {{
  if (threadIdx.x == 0 && blockIdx.x < VDB_NB) {{
    const int i = vdb_stamp_n[blockIdx.x]++;
    if (i < VDB_CAP) {{
      long long ns;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
      vdb_stamp_clk[blockIdx.x * VDB_CAP + i] = clock64();
      vdb_stamp_ns[blockIdx.x * VDB_CAP + i] = ns;
      vdb_stamp_line[blockIdx.x * VDB_CAP + i] = line;
    }}
  }}
}}
"""

STAMP_READ = """
extern "C" int vdb_stamp_read(int* n, long long* clk, long long* ns,
                              int* line) {
  cudaError_t e = cudaMemcpyFromSymbol(n, vdb_stamp_n, sizeof(vdb_stamp_n));
  if (!e) e = cudaMemcpyFromSymbol(clk, vdb_stamp_clk, sizeof(vdb_stamp_clk));
  if (!e) e = cudaMemcpyFromSymbol(ns, vdb_stamp_ns, sizeof(vdb_stamp_ns));
  if (!e) e = cudaMemcpyFromSymbol(line, vdb_stamp_line,
                                   sizeof(vdb_stamp_line));
  if (!e) {
    static const int zero[VDB_NB] = {};
    e = cudaMemcpyToSymbol(vdb_stamp_n, zero, sizeof(zero));
  }
  return (int)e;
}
"""

# vdb_beam_iter_attrs for the earlier one-block-a-query source (kernel
# beam_iter_kernel<T, kFused>, helpers smem_bytes and table_slots), which
# has none: regs, local bytes, static smem, resident blocks a SM, threads a
# block, queries a block, dynamic smem of a block.
PARENT_PROBE = """
extern "C" int vdb_beam_iter_attrs(int variant, int bf16, int fused, int l,
                                   int d, int m, int r, int v, int* out) {
  (void)variant; (void)v;
  const void* k =
      bf16 ? (fused ? (const void*)beam_iter_kernel<__nv_bfloat16, true>
                    : (const void*)beam_iter_kernel<__nv_bfloat16, false>)
           : (fused ? (const void*)beam_iter_kernel<float, true>
                    : (const void*)beam_iter_kernel<float, false>);
  const size_t smem = smem_bytes(l, d, m * r, m, table_slots(m * r), true);
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, k);
  if (!e && smem > 48 * 1024) {
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  }
  int blocks = 0;
  if (!e) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads,
                                                      smem);
  }
  out[0] = fa.numRegs; out[1] = (int)fa.localSizeBytes;
  out[2] = (int)fa.sharedSizeBytes; out[3] = blocks; out[4] = kThreads;
  out[5] = 1; out[6] = (int)smem;
  return (int)e;
}
"""


def build(src_text: str, name: str, workdir: str) -> tuple:
    """nvcc of src_text into workdir/<name>.so with _cuda_build's flags;
    returns (ctypes handle, ptxas' report)."""
    path = os.path.join(workdir, name + ".cu")
    with open(path, "w") as f:
        f.write(src_text)
    out = os.path.join(workdir, name + ".so")
    proc = subprocess.run([_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS,
                           "-o", out, path], capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    return ctypes.CDLL(out), proc.stdout + proc.stderr


def bind(lib, has_variant: bool) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.vdb_beam_iter.argtypes = ([p] * 5 + [ctypes.c_float] + [p] * 5
                                  + [ll] * 3 + [i] * 14 + [p, p]
                                  + ([i, p] if has_variant else []))
    lib.vdb_beam_iter.restype = i
    lib.vdb_beam_iter_attrs.argtypes = [i] * 8 + [p]
    lib.vdb_beam_iter_attrs.restype = i


def launch(lib, kw, flags, it_begin, it_end, peel, cp, tw, variant):
    """One vdb_beam_iter launch on the current stream; raises on an error."""
    fused = kw["fused"]
    b, L = kw["beam_ids"].shape
    args = [kw["q"].data_ptr(), kw["q_norms"].data_ptr(),
            kw["table"].data_ptr(), kw["adjacency"].data_ptr(),
            fused.data_ptr() if fused is not None else None,
            float(kw["scale"] or 0.0), kw["beam_ids"].data_ptr(),
            kw["beam_exp"].data_ptr(), kw["beam_d"].data_ptr(),
            kw["visited"].data_ptr(), flags.data_ptr(),
            kw["table"].shape[0], kw["adjacency"].shape[0],
            fused.shape[0] if fused is not None else 0, b,
            kw["q"].shape[1], L, kw["expand"], kw["adjacency"].shape[1],
            kw["visited"].shape[1], cp, tw, kw["metric"], it_begin, it_end,
            int(peel), flags.shape[0], 1, None,
            torch.cuda.current_stream().cuda_stream]
    if variant is not None:
        args += [variant, None]
    rc = lib.vdb_beam_iter(*args)
    if rc != 0:
        raise RuntimeError(f"vdb_beam_iter: CUDA error {rc}")


def read_stamps(lib) -> list:
    n = (ctypes.c_int * STAMP_BLOCKS)()
    size = STAMP_BLOCKS * STAMP_CAP
    clk, ns = (ctypes.c_longlong * size)(), (ctypes.c_longlong * size)()
    line = (ctypes.c_int * size)()
    rc = lib.vdb_stamp_read(n, clk, ns, line)
    if rc != 0:
        raise RuntimeError(f"vdb_stamp_read: CUDA error {rc}")
    return [[(line[b * STAMP_CAP + i], clk[b * STAMP_CAP + i],
              ns[b * STAMP_CAP + i]) for i in range(min(n[b], STAMP_CAP))]
            for b in range(STAMP_BLOCKS)]


def phases(lib, kw, variant, src_lines) -> dict:
    """Cycles between consecutive stamps of a block within a launch, by
    (line before, line after), summed over the walk and averaged over the
    stamped blocks; the SM clock from cycles over globaltimer ns."""
    state = {k: kw[k].clone() for k in ("beam_ids", "beam_exp", "beam_d",
                                        "visited")}
    one = {**kw, **state}
    read_stamps(lib)  # resets the counts
    b, L = kw["beam_ids"].shape
    C = kw["expand"] * kw["adjacency"].shape[1]
    cp = kw["compact"] if 0 < kw["compact"] < C else C
    tw = min(kw["term_width"] or L, L)
    iters = kw["max_iters"]
    peel = kw["fused"] is None and 0 < cp < C
    flags = torch.zeros(iters + 1, dtype=torch.int32, device="cuda")
    if not peel:
        flags[0] = 1
    spans = [(0, iters)] if b == 1 else [(i, i + 1) for i in range(iters)]
    per = {}
    cyc = ns_total = 0
    blocks = 0
    for it0, it1 in spans:
        launch(lib, one, flags, it0, it1, peel and it0 == 0, cp, tw, variant)
        torch.cuda.synchronize()
        for stamps in read_stamps(lib):
            if len(stamps) < 2:
                continue
            blocks += 1 if it0 == 0 else 0
            for (la, ca, na), (lb, cb, nb) in zip(stamps, stamps[1:]):
                key = f"{la}->{lb}"
                per[key] = per.get(key, 0) + (cb - ca)
            cyc += stamps[-1][1] - stamps[0][1]
            ns_total += stamps[-1][2] - stamps[0][2]
    blocks = max(blocks, 1)
    ghz = cyc / ns_total if ns_total else None
    out = {}
    for key, c in sorted(per.items(), key=lambda kv: -kv[1]):
        lb = int(key.split("->")[1])
        out[key] = {"cycles_a_walk": c / blocks,
                    "us_a_walk": c / blocks / ghz / 1e3 if ghz else None,
                    "line": src_lines[lb - 1].strip()[:80]}
    return {"sm_ghz": ghz, "stamped_blocks": blocks,
            "walk_cycles": cyc / blocks, "phases": out}


def iteration_us(lib, kw, variant) -> float:
    """µs of one launch of iteration 1 (from the state after iteration
    0) by CUDA-graph replay, the state's restore replayed alone and
    subtracted."""
    b, L = kw["beam_ids"].shape
    C = kw["expand"] * kw["adjacency"].shape[1]
    cp = kw["compact"] if 0 < kw["compact"] < C else C
    tw = min(kw["term_width"] or L, L)
    peel = kw["fused"] is None and 0 < cp < C
    names = ("beam_ids", "beam_exp", "beam_d", "visited")
    live = {**kw, **{k: kw[k].clone() for k in names}}
    flags = torch.ones(kw["max_iters"] + 1, dtype=torch.int32, device="cuda")
    launch(lib, live, flags, 0, 1, peel, 0 if peel else cp, tw, variant)
    saved = {k: live[k].clone() for k in names}
    saved_flags = flags.clone()
    torch.cuda.synchronize()

    def restore():
        for k in names:
            live[k].copy_(saved[k])
        flags.copy_(saved_flags)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graphs = {}
    with torch.cuda.stream(side):
        for what in ("restore", "restore+launch"):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=side):
                restore()
                if what != "restore":
                    launch(lib, live, flags, 1, 2, False, cp, tw, variant)
            graphs[what] = g
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()

    def replay_ms(g):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        g.replay()
        e0.record()
        for _ in range(REPLAYS):
            g.replay()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / REPLAYS

    got = {k: [] for k in graphs}
    for _ in range(5):
        for k, g in graphs.items():
            got[k].append(replay_ms(g))
    med = {k: statistics.median(v) for k, v in got.items()}
    return 1e3 * (med["restore+launch"] - med["restore"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default=os.path.join(
        _cuda_build.CSRC_DIR, "beam_iter.cu"))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--out", default=".")
    ap.add_argument("--stamp", default="__syncthreads();")
    ap.add_argument("--variants", default="",
                    help="comma-separated variant numbers to profile "
                         "(sources with a variant argument)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("beam_profile: no CUDA device")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with open(args.source) as f:
        src = f.read()
    has_variant = "vdb_beam_iter_attrs" in src
    variants = ([int(v) for v in args.variants.split(",") if v]
                if has_variant else [None])
    plain = src + ("" if has_variant else PARENT_PROBE)
    stamped = (STAMP_PRELUDE + '#line 1 "beam_iter.cu"\n'
               + src.replace(args.stamp, args.stamp + " vdb_stamp(__LINE__);")
               + ("" if has_variant else PARENT_PROBE) + STAMP_READ)
    src_lines = src.splitlines()
    record = {"card": smi, "source": args.source, "tag": args.tag}
    with tempfile.TemporaryDirectory() as tmp:
        lib, report = build(plain, "beam_plain", tmp)
        slib, _ = build(stamped, "beam_stamped", tmp)
        for h in (lib, slib):
            bind(h, has_variant)
        slib.vdb_stamp_read.argtypes = [ctypes.c_void_p] * 4
        record["ptxas"] = [ln.strip() for ln in report.splitlines()
                           if "registers" in ln or "spill" in ln
                           or "Function properties" in ln
                           or "Compiling entry" in ln]
        for ln in record["ptxas"]:
            print("ptxas: " + ln, flush=True)
        dev = torch.device("cuda", 0)
        cases = {}
        for wname, wk in (("main", MAIN_WALK), ("wide", cs.BEAM_WALK)):
            for b in (cs.GRAPH_BATCH, 1):
                for fused in (True, False):
                    kw = cs.beam_case(dev, b, fused, seed=7 + b + fused,
                                      walk=wk)
                    for variant in variants:
                        name = (f"{wname}_{'fused' if fused else 'split'}"
                                f"_b{b}" + ("" if variant is None
                                            else f"_v{variant}"))
                        attrs = (ctypes.c_int * 7)()
                        rc = lib.vdb_beam_iter_attrs(
                            variant or 0, 1, int(fused), wk["beam_width"],
                            128, wk["expand"], wk["degree"],
                            kw["visited"].shape[1], attrs)
                        if rc != 0:
                            raise RuntimeError(f"attrs: CUDA error {rc}")
                        keys = ("registers", "local_bytes", "static_smem",
                                "resident_blocks_per_sm", "threads",
                                "queries_per_block", "dynamic_smem")
                        case = {"walk": wk, "queries": b,
                                **dict(zip(keys, list(attrs)))}
                        case["resident_queries_per_sm"] = (
                            attrs[3] * attrs[5])
                        case["iteration_us"] = iteration_us(lib, kw, variant)
                        case["stamped"] = phases(slib, kw, variant, src_lines)
                        cases[name] = case
                        print(json.dumps({name: case}), flush=True)
                    del kw
                    torch.cuda.empty_cache()
        record["cases"] = cases
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"beam_profile_{args.tag}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
