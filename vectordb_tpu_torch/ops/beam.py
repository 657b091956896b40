"""Batched best-first beam search over a fixed-degree graph (counterpart of
vectordb_tpu/ops/beam.py).

A batch of queries each holds a beam of L (distance, row, expanded) entries
kept sorted by distance, advanced in lockstep:

  iteration = pick the M best unexpanded beam entries
            -> read their adjacency rows
            -> drop padding, beam members, duplicates and visited rows
            -> read the candidates' rows and score them against the query
            -> merge with the beam, stable sort by distance, keep L

On CUDA tensors the walk runs in the hand-written kernel
csrc/beam_iter.cu (torch.ops.vdb.beam_iter, through beam_iter): a warp a
query for narrow beams, a block a query for wide ones (walk_plan), the
whole walk in one launch where the batch is resident on the card (a
cooperative launch), else one launch an iteration; on CPU tensors
beam_iter runs beam_iteration_ref, its plain version (about 50 torch ops an
iteration, the port's loop body before the kernel). The seed scan, the
masked top-k and the re-rank stay torch ops, their row gathers on
ops/gather.gather_rows (csrc/gather_rows.cu). Scores are f32: bf16 and int8
operands are upcast before each product (their products are exact in f32,
TF32 is off), matching the JAX package's f32-accumulating einsums up to
summation order.

Translation notes:
  - `lax.sort` of (distance, id, expanded) becomes a stable sort (the
    kernel's merge: ties to the beam, then to the lower candidate column);
    the stable compaction stays stable (survivors in column order).
  - Pick rule: the beam is always sorted, so the M best unexpanded finite
    entries are the first M of them in beam order; the pick takes them in
    position order (and unavailable positions after them, also in order).
    Equal scores therefore go to the lower beam position, which is
    `lax.top_k`'s rule, and the pick is deterministic on the card too.
    The masked top-k of beam_search_topk uses the same rule.
  - Duplicate detection keeps a candidate's first occurrence (the plain
    version: `torch.argmax` of a uint8 equality matrix, jnp.argmax's
    first-maximum rule; the kernel: a hash table of first columns).
  - Seeding from >= 4,096 representatives uses exact `torch.topk` where the
    JAX package takes `approx_min_k` (exact on the CPU).
  - The stop rule is JAX's `cond` (no query of the batch has work). Each
    iteration writes "some query has work" to a device flag. In a walk in
    one launch a query with work goes on at once and one without waits on
    the flag and a count of queries done (the warp variant), or every
    block waits on a grid sync (the block variant); a launch of one
    iteration reads the previous one's flag first, a no-op when it is 0,
    so the loop never waits for the device, except that a walk deeper than
    UNROLL_MAX_ITERS asks the host every DEEP_CHECK_EVERY launches whether
    to go on.
  - The state (beam, flags, visited) is updated in place, one copy a
    traversal, where JAX's loop carries new arrays.
  - beam_search_grouped takes f32 queries and a query wire (ops/qwire):
    traversal runs on the wire's values, as JAX's decoded `packed_gb`
    buffer, and the exact re-rank on the f32 queries, where JAX re-ranks
    against the wire's values.

A table's dense graph queries go through a ReplayCache: the whole device
chain of a query (upload, seed scan, walk, masked top-k, copy back) is
captured once as a CUDA graph and replayed, in place of its ~60 eager
launches, for inputs that repeat (JAX compiles the chain into one program
instead).
"""
from __future__ import annotations

import ctypes
import threading
import weakref
from collections import OrderedDict
from typing import Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..logger import logger
from ..metrics import metrics, span
from ..schema import MetricType
from . import gather, qwire
from .gather import gather_rows

DEFAULT_EXPAND = 4  # beam entries expanded per iteration (M)
# Traversals at or below this depth run the fixed-depth masked loop.
UNROLL_MAX_ITERS = 16

_INF = float("inf")


def unpack_wire(packed: np.ndarray, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Decode the packed int32 result wire: rows are [..., 2w] int32 with
    f32 distance BITS in [:w] and ids in [w:]. Returns (d [..., w] f32
    view, ids [..., w] int64 with -1 where the distance is non-finite)."""
    d = packed[..., :w].view(np.float32)
    ids = packed[..., w:].astype(np.int64)
    ids[~np.isfinite(d)] = -1
    return d, ids


def _cand_scores(q: torch.Tensor, vecs: torch.Tensor, q_norms: torch.Tensor,
                 metric: int, v_norms: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """q [B, D] (table dtype), vecs [B, C, D] -> [B, C] f32 distances.
    Candidate norms come from the gathered rows unless v_norms [B, C] is
    given (a second gather costs as much as the rows' own norms)."""
    vf = vecs.float()
    ip = torch.bmm(vf, q.float()[:, :, None])[:, :, 0]
    if metric == int(MetricType.EUCLIDEAN):
        if v_norms is None:
            v_norms = (vf * vf).sum(dim=2)
        return q_norms[:, None] - 2.0 * ip + v_norms
    if metric == int(MetricType.COSINE):
        return 1.0 - ip
    return -ip


def _cand_scores_q(q: torch.Tensor, vecs_q: torch.Tensor,
                   q_norms: torch.Tensor, scale: float,
                   metric: int) -> torch.Tensor:
    """Int8-grid variant of _cand_scores for the fused traversal layout:
    products are accumulated on the quantized grid and rescaled after, in
    f32 (`scale` is the dequant step)."""
    vf = vecs_q.float()
    ip = torch.bmm(vf, q.float()[:, :, None])[:, :, 0]
    s = np.float32(scale)
    if metric == int(MetricType.EUCLIDEAN):
        vn = (vf * vf).sum(dim=2)
        return (q_norms[:, None] - float(np.float32(2.0) * s) * ip
                + float(s * s) * vn)
    if metric == int(MetricType.COSINE):
        return 1.0 - float(s) * ip
    return -(float(s) * ip)


def _first_m(avail: torch.Tensor, m: int) -> torch.Tensor:
    """Positions [B, m] of the first m True entries of each row, then of
    the False ones, each in position order (distinct keys: no ties)."""
    width = avail.shape[1]
    pos = torch.arange(width, device=avail.device)
    key = pos + width * (~avail).to(pos.dtype)
    return torch.topk(key, m, dim=1, largest=False, sorted=True)[1]


# Kernel launches since the last reset (CPU calls of the plain version are
# not counted), in all and by "variant/mode" ("walk": a launch of more than
# one iteration): a run reads them to show the traversal went through the
# kernel, and which variant and mode each walk took.
launches = 0
launches_by_plan: dict = {}


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_plan.clear()


# The kernel's variants, by the operator's number, and the shapes the warp
# variant (a warp a query) takes; the block variant (a block a query) takes
# any.
VARIANTS = ("block", "warp")
WARP_MAX_L, WARP_MAX_M, WARP_MAX_C = 64, 32, 256
WARP_MAX_CHUNKS, WARP_MAX_VISITED = 32, 1024


class WalkPlan(NamedTuple):
    """How traverse runs a walk on the card: the kernel variant ("warp" or
    "block") and the mode ("walk": the whole walk in one launch,
    cooperative for a batch of several blocks; "iteration": one launch an
    iteration, each reading the previous one's flag)."""
    variant: str
    mode: str


def warp_takes(beam_width: int, expand: int, degree: int, d: int,
               dtype: torch.dtype, fused: bool, visited: int) -> bool:
    """Whether the warp variant takes a walk's shape: L <= 64, M <= 32,
    C = M * R <= 256, rows of at most 32 16-byte chunks (a lane each), at
    most 1,024 visited ids (its state in shared memory)."""
    chunks = d // (16 if fused else 16 // dtype.itemsize)
    return (beam_width <= WARP_MAX_L and expand <= WARP_MAX_M
            and expand * degree <= WARP_MAX_C and chunks <= WARP_MAX_CHUNKS
            and visited <= WARP_MAX_VISITED)


def walk_plan(b: int, beam_width: int, expand: int, degree: int, d: int,
              dtype: torch.dtype, fused: bool, visited: int,
              resident_per_sm: Mapping[str, int], sms: int) -> WalkPlan:
    """The variant and mode of a walk of b queries: the warp variant where
    it takes the shape (warp_takes) and the batch has more queries than the
    card has multiprocessors (`sms`), else the block variant, whose eight
    warps share one query's chain of loads (faster while each query can
    have a multiprocessor: 0.065 vs 0.10 ms for one query's 1M walk on an
    H100, PERF.md section 6); the whole walk in one
    launch for one query and for a batch that the card holds at once (b <=
    resident queries a multiprocessor of that variant x multiprocessors),
    else one launch an iteration. resident_per_sm[v] is what the runtime
    reports for variant v at this shape (0 where unknown, as on the
    CPU)."""
    variant = ("warp" if b > sms and warp_takes(
        beam_width, expand, degree, d, dtype, fused, visited) else "block")
    whole = b == 1 or b <= resident_per_sm.get(variant, 0) * sms
    return WalkPlan(variant, "walk" if whole else "iteration")


def kernel_library() -> ctypes.CDLL:
    """The operator library's C interface (csrc/beam_iter.cu), built and
    registered on first use: vdb_beam_iter_resident (resident queries a
    multiprocessor) and vdb_beam_iter_attrs (a kernel's registers, stack,
    shared memory and occupancy at a shape)."""
    from .. import _cuda_build

    lib = _cuda_build.operator_cdll("beam_iter_op")
    i = ctypes.c_int
    lib.vdb_beam_iter_resident.argtypes = [i] * 8
    lib.vdb_beam_iter_resident.restype = ctypes.c_longlong
    lib.vdb_beam_iter_attrs.argtypes = [i] * 8 + [ctypes.POINTER(i)]
    lib.vdb_beam_iter_attrs.restype = i
    return lib


_resident_cache: dict = {}


def resident_per_sm(device: torch.device, variant: str, dtype: torch.dtype,
                    fused: bool, beam_width: int, d: int, expand: int,
                    degree: int, visited: int) -> int:
    """Queries of a walk's shape that one multiprocessor of the card holds
    at once with kernel `variant` (cudaOccupancyMaxActiveBlocksPerMultiprocessor
    x queries a block, csrc/beam_iter.cu's vdb_beam_iter_resident); 0 where
    the variant does not take the shape. Cached by shape."""
    key = (device, variant, dtype, fused, beam_width, d, expand, degree,
           visited)
    got = _resident_cache.get(key)
    if got is None:
        with torch.cuda.device(device):
            got = kernel_library().vdb_beam_iter_resident(
                VARIANTS.index(variant), int(dtype == torch.bfloat16),
                int(fused), beam_width, d, expand, degree, visited)
        if got < 0 and got != -1:  # 1: cudaErrorInvalidValue, not taken
            raise RuntimeError(f"beam_iter: CUDA error {-got} reading the "
                               "card's occupancy")
        got = _resident_cache[key] = max(int(got), 0)
    return got


_sms_cache: dict = {}


def _occupancy(beam_width: int, expand: int, degree: int, d: int,
               dtype: torch.dtype, fused: bool, visited: int,
               device: torch.device):
    """(resident queries a multiprocessor by variant that takes the shape,
    multiprocessors) of the card; ({}, 0) on the CPU."""
    if device.type != "cuda":
        return {}, 0
    sms = _sms_cache.get(device)
    if sms is None:
        sms = _sms_cache[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    shape = (dtype, fused, beam_width, d, expand, degree, visited)
    return ({v: resident_per_sm(device, v, *shape) for v in VARIANTS
             if v == "block" or warp_takes(beam_width, expand, degree, d,
                                           dtype, fused, visited)}, sms)


def _plan(b: int, beam_width: int, expand: int, degree: int, d: int,
          dtype: torch.dtype, fused: bool, visited: int,
          device: torch.device) -> WalkPlan:
    """walk_plan with the card's occupancy and multiprocessors (none on the
    CPU: a batch there runs an iteration a call)."""
    shape = (beam_width, expand, degree, d, dtype, fused, visited)
    return walk_plan(b, *shape, *_occupancy(*shape, device))


def walk_plans(b: int, beam_width: int, expand: int, degree: int, d: int,
               dtype: torch.dtype, fused: bool, visited: int,
               device: torch.device) -> list:
    """Every plan the kernel can run a walk of this shape in on the card
    (walk_plan picks one): each variant that takes the shape; the whole
    walk in one launch for one query or a batch the card holds at once,
    and one launch an iteration for a batch."""
    resident, sms = _occupancy(beam_width, expand, degree, d, dtype, fused,
                               visited, device)
    plans = []
    for variant, per_sm in resident.items():
        if b == 1 or b <= per_sm * sms:
            plans.append(WalkPlan(variant, "walk"))
        if b > 1:
            plans.append(WalkPlan(variant, "iteration"))
    return plans


def beam_iter_cost(b: int, beam_width: int, visited: int, picks: int,
                   degree: int, rows: int, row_bytes: int) -> int:
    """Bytes one launch of beam_iter must move, each counted once: the beam
    of b queries (int32 id, f32 distance, bool flag a slot) read and
    written, `visited` ids read or written in all, the adjacency rows of
    `picks` valid picks (degree int32 each), and the `rows` candidate rows
    it scored (row_bytes each: d elements of the table, or a fused row's d
    int8 slice). Its 2 FMAs a candidate element stay under 4 flops a byte,
    so the bound is these bytes at the HBM rate
    (partial_min.bound_ms(0, bytes))."""
    return (2 * 9 * b * beam_width + 4 * visited + 4 * degree * picks
            + rows * row_bytes)


def walk_bytes(q, q_norms, table, adjacency, fused, scale, beam_ids,
               beam_exp, beam_d, visited, metric: int, expand: int,
               max_iters: int, term_width: int = 0, compact: int = 0) -> int:
    """Bytes that traverse's walk from this state must move, counted from
    its data (beam_iter_cost's terms, each byte once): the queries and
    their norms, the beam read once and written once, every visited id
    written once, and, for each iteration the walk runs (JAX's stop rule,
    the peel), the valid picks' adjacency rows and the rows of the
    candidates it scores (not padded, not in the beam, not repeated, not
    visited; at most cp on the split path after the peel). The same for a
    batch as for one query, whatever the launches. Leaves the state as it
    is."""
    b, L = beam_ids.shape
    M, R = expand, adjacency.shape[1]
    C, d = M * R, q.shape[1]
    cp = compact if 0 < compact < C else C
    tw = min(term_width if term_width > 0 else L, L)
    peel = fused is None and 0 < cp < C and max_iters > 0
    row = d if fused is not None else d * table.element_size()
    state = (beam_ids.clone(), beam_exp.clone(), beam_d.clone(),
             visited.clone())
    picks = rows = written = 0
    for it in range(max_iters):
        peeled = peel and it == 0
        if not peeled and not bool(_has_work(state[1], state[2], tw)):
            break
        ids, exp, bd, vis = state
        avail = ~exp & torch.isfinite(bd)
        pick = _first_m(avail, M)
        valid = torch.gather(avail, 1, pick)
        pid = torch.gather(ids, 1, pick)
        cand = gather_rows(adjacency, pid).reshape(b, C)
        cand = torch.where(valid.repeat_interleave(R, dim=1), cand, -1)
        vis_now = torch.cat([vis[:, :it * M], torch.where(valid, pid, -1)],
                            dim=1)
        first = torch.argmax((cand[:, :, None] == cand[:, None, :])
                             .to(torch.uint8), dim=2)
        good = ((cand >= 0) & (first == torch.arange(C, device=cand.device))
                & ~(cand[:, :, None] == ids[:, None, :]).any(2)
                & ~(cand[:, :, None] == vis_now[:, None, :]).any(2))
        scored = good.sum(1)
        if fused is None and not peeled:
            scored = scored.clamp(max=cp)
        picks += int(valid.sum())
        rows += int(scored.sum())
        written += b * M
        state = _iteration(q, q_norms, table, adjacency, fused, scale, state,
                           M, metric, it, 0 if peeled else cp)
    return (beam_iter_cost(b, L, written, picks, R, rows, row)
            + b * (d * q.element_size() + 4))


def _has_work(beam_exp: torch.Tensor, beam_d: torch.Tensor,
              tw: int) -> torch.Tensor:
    """A device scalar: some query has an unexpanded finite entry among its
    first tw beam positions (JAX's `cond`)."""
    return (~beam_exp[:, :tw] & torch.isfinite(beam_d[:, :tw])).any()


def _iteration(q, q_norms, table, adjacency, fused, scale, state, expand: int,
               metric: int, it: int, cp: int):
    """One traversal iteration of the whole batch in torch ops (the port's
    loop body before the kernel): pick, visited, adjacency, dedup, score,
    merge. Returns the new (beam_ids, beam_exp, beam_d, visited)."""
    beam_ids, beam_exp, beam_d, visited = state
    b, d = q.shape
    M, R = expand, adjacency.shape[1]
    C = M * R
    avail = ~beam_exp & torch.isfinite(beam_d)
    pick_idx = _first_m(avail, M)                      # [B, M]
    picked_valid = torch.gather(avail, 1, pick_idx)
    picked_ids = torch.gather(beam_ids, 1, pick_idx)
    beam_exp = beam_exp.scatter(1, pick_idx, True)
    visited = torch.cat([
        visited[:, :it * M],
        torch.where(picked_valid, picked_ids, -1),
        visited[:, (it + 1) * M:]], dim=1)

    cand = gather_rows(adjacency, picked_ids).reshape(b, C)
    cand = torch.where(picked_valid.repeat_interleave(R, dim=1), cand, -1)
    # Invalid: padding edges, beam members, repeats within the
    # candidates (all but the first), rows already expanded.
    in_beam = (cand[:, :, None] == beam_ids[:, None, :]).any(dim=2)
    first = torch.argmax(
        (cand[:, :, None] == cand[:, None, :]).to(torch.uint8), dim=2)
    seen = (cand[:, :, None] == visited[:, None, :]).any(dim=2)
    cols = torch.arange(C, device=cand.device)
    bad = (cand < 0) | in_beam | (first != cols) | seen

    if fused is not None:
        # The neighbour vectors arrive with the adjacency row:
        # duplicates cost only arithmetic, so they are masked after
        # scoring instead of compacted before a second gather.
        rows = gather_rows(fused, picked_ids).reshape(b, C, d)
        cand_d = _cand_scores_q(q, rows, q_norms, scale, metric)
        cand_d = cand_d.masked_fill(bad, _INF)
        cand_ids = torch.where(bad, -1, cand)
    else:
        cand = torch.where(bad, -1, cand)
        if 0 < cp < C:
            # Stable compaction: survivors keep pick-major order, so
            # the best picks' neighbourhoods win when > cp survive.
            order = torch.sort((cand < 0).to(torch.int32), dim=1,
                               stable=True)[1]
            cand = torch.gather(cand, 1, order[:, :cp])
        vecs = gather_rows(table, cand)
        cand_d = _cand_scores(q, vecs, q_norms, metric)
        cand_d = cand_d.masked_fill(cand < 0, _INF)
        cand_ids = cand

    L = beam_d.shape[1]
    all_d = torch.cat([beam_d, cand_d], dim=1)
    all_ids = torch.cat([beam_ids, cand_ids], dim=1)
    all_exp = torch.cat([beam_exp, torch.zeros_like(cand_ids,
                                                    dtype=torch.bool)],
                        dim=1)
    sd, order = torch.sort(all_d, dim=1, stable=True)
    keep = order[:, :L]
    return (torch.gather(all_ids, 1, keep), torch.gather(all_exp, 1, keep),
            sd[:, :L], visited)


def beam_iteration_ref(q, q_norms, table, adjacency, fused, scale,
                       beam_ids, beam_exp, beam_d, visited, flags,
                       expand: int, metric: int, it_begin: int, it_end: int,
                       cp: int, tw: int, peel: bool) -> None:
    """Plain PyTorch version of beam_iter, with its signature and flag
    semantics; updates beam_ids, beam_exp, beam_d, visited and flags in
    place. Iterations it_begin .. it_end - 1 in turn: iteration `it` runs
    when the batch had work (for one query, its own state says so; for a
    batch, flags[it] != 0), except a peeled iteration 0 (peel), which runs
    always and uncompacted; after each, flags[it + 1] is set to 1 when
    some query has work left (_has_work over the first tw positions)."""
    state = (beam_ids, beam_exp, beam_d, visited)
    single = q.shape[0] == 1
    for it in range(it_begin, it_end):
        peeled = peel and it == 0
        if not peeled and not bool(_has_work(state[1], state[2], tw)
                                   if single else flags[it]):
            break
        state = _iteration(q, q_norms, table, adjacency, fused, scale, state,
                           expand, metric, it, 0 if peeled else cp)
        if it + 1 < flags.shape[0] and bool(_has_work(state[1], state[2],
                                                      tw)):
            flags[it + 1] = 1
    for dst, src in zip((beam_ids, beam_exp, beam_d, visited), state):
        dst.copy_(src)


def _check(q, q_norms, table, adjacency, fused, beam_ids, beam_exp, beam_d,
           visited, flags, expand: int, it_begin: int, it_end: int,
           tw: int, variant: str) -> None:
    """The operator's checks, in Python (the kernel also needs rows of a
    multiple of 16 elements, which only the operator checks)."""
    if table.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"beam_iter: table must be bfloat16 or float32, got "
                        f"{table.dtype}")
    if q.dtype != table.dtype:
        raise TypeError(f"beam_iter: q must have the table's dtype "
                        f"{table.dtype}, got {q.dtype}")
    for name, t, dtype in (("q_norms", q_norms, torch.float32),
                           ("beam_d", beam_d, torch.float32),
                           ("adjacency", adjacency, torch.int32),
                           ("beam_ids", beam_ids, torch.int32),
                           ("visited", visited, torch.int32),
                           ("flags", flags, torch.int32),
                           ("beam_exp", beam_exp, torch.bool)):
        if t.dtype != dtype:
            raise TypeError(f"beam_iter: {name} must be {dtype}, got "
                            f"{t.dtype}")
    if fused is not None and fused.dtype != torch.int8:
        raise TypeError(f"beam_iter: fused must be int8, got {fused.dtype}")
    b, d = q.shape
    L, R = beam_ids.shape[1], adjacency.shape[1]
    if (table.shape[1] != d or q_norms.shape != (b,)
            or beam_ids.shape != (b, L) or beam_exp.shape != (b, L)
            or beam_d.shape != (b, L) or visited.shape[0] != b
            or (fused is not None and fused.shape[1] != R * d)):
        raise ValueError("beam_iter: shapes disagree")
    if not (1 <= expand <= L and expand * R <= 4096):
        raise ValueError(f"beam_iter: needs 1 <= expand <= L and expand * R "
                         f"<= 4096, got expand {expand}, L {L}, R {R}")
    if not (0 <= it_begin <= it_end and it_end * expand <= visited.shape[1]
            and it_end <= flags.shape[0]):
        raise ValueError(f"beam_iter: iterations [{it_begin}, {it_end}) do "
                         "not fit visited or flags")
    if not 0 <= tw <= L:
        raise ValueError(f"beam_iter: tw {tw} outside [0, L]")
    if variant not in VARIANTS or (variant == "warp" and not warp_takes(
            L, expand, R, d, table.dtype, fused is not None,
            visited.shape[1])):
        raise ValueError(f"beam_iter: kernel variant {variant!r} does not "
                         f"take L {L}, D {d}, expand {expand}, R {R}, "
                         f"visited {visited.shape[1]}")


_op = None


def _operator():
    """torch.ops.vdb.beam_iter, its library built and registered on first
    use (_cuda_build raises, naming nvcc's output, if it fails)."""
    global _op
    if _op is None:
        from .. import _cuda_build

        _cuda_build.load_operator("beam_iter_op")
        _op = torch.ops.vdb.beam_iter.default
    return _op


def beam_iter(q, q_norms, table, adjacency, fused, scale, beam_ids,
              beam_exp, beam_d, visited, flags, expand: int, metric: int,
              it_begin: int, it_end: int, cp: int, tw: int,
              peel: bool, variant: str = "block") -> None:
    """Traversal iterations [it_begin, it_end) of every query, in place on
    the state (beam_ids [B, L] int32, beam_exp [B, L] bool, beam_d [B, L]
    f32 ascending, visited [B, V] int32, flags [n] int32; see
    beam_iteration_ref for the flag rule). q [B, D] in table's dtype,
    q_norms [B] f32 (of the f32 queries), table [N, D] bf16/f32, adjacency
    [N', R] int32, fused optional [N'', R*D] int8 with its dequant `scale`;
    cp: survivors scored an iteration on the split path (0: all); variant:
    the kernel, "block" (a block a query) or "warp" (a warp a query, for
    the shapes warp_takes). On CUDA tensors the kernel (csrc/beam_iter.cu
    through torch.ops.vdb.beam_iter): a batch of several blocks that runs
    more than one iteration is one cooperative launch, which the card
    refuses (RuntimeError) when it cannot hold every block at once. On CPU
    tensors beam_iteration_ref. Both raise TypeError for a wrong dtype and
    ValueError for the other arguments the kernel does not take."""
    global launches
    if table.is_cuda:
        (_op if _op is not None else _operator())(
            q, q_norms, table, adjacency, fused, float(scale or 0.0),
            beam_ids, beam_exp, beam_d, visited, flags, expand, metric,
            it_begin, it_end, cp, tw, peel,
            VARIANTS.index(variant) if variant in VARIANTS else -1)
        if it_end > it_begin:
            launches += 1
            key = (f"{variant}/"
                   f"{'walk' if it_end > it_begin + 1 else 'iteration'}")
            launches_by_plan[key] = launches_by_plan.get(key, 0) + 1
        return
    if table.device.type != "cpu":
        raise ValueError(f"beam_iter: table on {table.device}; the kernel "
                         "takes CUDA tensors, the plain version CPU ones")
    _check(q, q_norms, table, adjacency, fused, beam_ids, beam_exp, beam_d,
           visited, flags, expand, it_begin, it_end, tw, variant)
    beam_iteration_ref(q, q_norms, table, adjacency, fused, scale, beam_ids,
                       beam_exp, beam_d, visited, flags, expand, metric,
                       it_begin, it_end, cp, tw, peel)


# A batch's deep walk (> UNROLL_MAX_ITERS iterations) asks the host whether
# any query has work left before every DEEP_CHECK_EVERY-th launch.
DEEP_CHECK_EVERY = 4


def traverse(q, q_norms, table, adjacency, fused, scale, beam_ids,
             beam_exp, beam_d, visited, metric: int, expand: int,
             max_iters: int, term_width: int = 0, compact: int = 0,
             plan: Optional[WalkPlan] = None) -> None:
    """Up to max_iters iterations of beam_iter from the given state, in
    place (beam_search_kernel after its seed scan; arguments as there and
    in beam_iter). Iteration 0 of the split path runs uncompacted and
    unconditionally (JAX's peel). `plan` (default: walk_plan from the
    card's occupancy, chosen before the launch) gives the kernel variant
    and the mode: "walk" runs the whole walk in one launch; "iteration"
    launches one iteration at a time, each a no-op once the previous one
    left no query with work (the device flag), so the loop never waits for
    the device, except that a walk deeper than UNROLL_MAX_ITERS stops
    launching when the host, asking every DEEP_CHECK_EVERY launches, finds
    the flag 0."""
    b, L = beam_ids.shape
    C = expand * adjacency.shape[1]
    cp = compact if compact > 0 else C
    tw = min(term_width if term_width > 0 else L, L)
    peel = fused is None and 0 < cp < C and max_iters > 0
    if plan is None:
        plan = _plan(b, L, expand, adjacency.shape[1], q.shape[1],
                     table.dtype, fused is not None, visited.shape[1],
                     beam_ids.device)
    flags = torch.zeros(max_iters + 1, dtype=torch.int32,
                        device=beam_ids.device)

    def run(it_begin: int, it_end: int, first: bool) -> None:
        beam_iter(q, q_norms, table, adjacency, fused, scale, beam_ids,
                  beam_exp, beam_d, visited, flags, expand, metric, it_begin,
                  it_end, cp, tw, first and peel, plan.variant)

    if plan.mode == "walk":
        if b > 1 and not peel:
            flags[:1] = _has_work(beam_exp, beam_d, tw)
        run(0, max_iters, True)
        return
    done = 0
    if peel:
        run(0, 1, True)
        done = 1
    else:
        flags[:1] = _has_work(beam_exp, beam_d, tw)
    deep = max_iters > UNROLL_MAX_ITERS
    for it in range(done, max_iters):
        if (deep and it > done and (it - done) % DEEP_CHECK_EVERY == 0
                and not bool(flags[it])):
            break
        run(it, it + 1, False)


def beam_search_kernel(queries: torch.Tensor, table: torch.Tensor,
                       norms: torch.Tensor, adjacency: torch.Tensor,
                       rep_ids: torch.Tensor, metric: int, beam_width: int,
                       expand: int, max_iters: int, num_seeds: int = 32,
                       term_width: int = 0, compact: int = 0,
                       fused: Optional[torch.Tensor] = None,
                       scale: Optional[float] = None):
    """Seed scan over the representatives, then up to max_iters expansions
    (traverse: beam_iter, the kernel on the card).

    queries:   [B, D] f32 (padded to the table's lane width)
    table:     [N_pad, D] store dtype (bf16/f32); norms [N_pad] f32
    adjacency: [N_pad, R] int32, padded entries < 0
    rep_ids:   [S] int32 representative rows
    fused:     optional [N_pad, R*D] int8: row i inlines the int8-quantized
               vectors of node i's R neighbours, so one [B*M]-row gather
               brings the candidates' vectors with the adjacency; `scale`
               is the dequant step. `compact` is ignored on this path.
    compact:   split path only: after the first iteration, gather the rows
               of at most `compact` surviving candidates per query.

    Returns (beam_d [B, L] f32 ascending, beam_ids [B, L] int32, visited
    [B, M*max_iters] int32: the ids expanded per iteration, -1 padded).
    """
    b = queries.shape[0]
    dev = table.device
    L, M = beam_width, expand
    q = queries.to(table.dtype).contiguous()
    q_norms = (queries.float() ** 2).sum(dim=1)

    # Seed scan: every query scores all representatives and seeds its beam
    # with its own nearest `num_seeds`.
    n_seed = min(num_seeds, rep_ids.shape[0], L)
    rep_vecs = gather_rows(table, rep_ids)
    ip = q.float() @ rep_vecs.float().T
    if metric == int(MetricType.EUCLIDEAN):
        rep_d = (q_norms[:, None] - 2.0 * ip
                 + gather_rows(norms, rep_ids)[None, :])
    elif metric == int(MetricType.COSINE):
        rep_d = 1.0 - ip
    else:
        rep_d = -ip
    seed_d, top_idx = torch.topk(rep_d, n_seed, dim=1, largest=False,
                                 sorted=True)
    seed_ids = gather_rows(rep_ids, top_idx.to(torch.int32))

    pad = L - n_seed
    beam_ids = torch.cat([seed_ids, torch.full((b, pad), -1, dtype=torch.int32,
                                               device=dev)], dim=1)
    beam_d = torch.cat([seed_d, torch.full((b, pad), _INF, device=dev)],
                       dim=1)
    beam_exp = torch.zeros((b, L), dtype=torch.bool, device=dev)
    visited = torch.full((b, M * max_iters), -1, dtype=torch.int32,
                         device=dev)
    traverse(q, q_norms, table, adjacency, fused, scale, beam_ids, beam_exp,
             beam_d, visited, metric, M, max_iters, term_width, compact)
    return beam_d, beam_ids, visited


def beam_search_topk(queries, table, norms, adjacency, rep_ids, valid,
                     metric: int, beam_width: int, expand: int,
                     max_iters: int, num_seeds: int, term_width: int,
                     k_out: int, compact: int = 0, fused=None, scale=None):
    """Beam search + mask-aware selection on the device. `valid` is an
    [N_pad] mask (0/False = deleted or filtered). Masked rows stay
    traversable (they guide navigation, the reference's post-filter
    semantics) but are left out of the returned top-k_out: the first k_out
    valid entries of the sorted beam. Returns ([B, k_out] dists asc,
    [B, k_out] int32 ids), -1/inf padded."""
    beam_d, beam_ids, _ = beam_search_kernel(
        queries, table, norms, adjacency, rep_ids, metric, beam_width,
        expand, max_iters, num_seeds, term_width, compact, fused, scale)
    if valid.element_size() != 4:
        valid = valid.to(torch.int32)  # the gather takes 4-byte rows
    ok = (beam_ids >= 0) & (gather_rows(valid, beam_ids) != 0)
    sel = _first_m(ok, min(k_out, beam_d.shape[1]))
    d = torch.gather(beam_d.masked_fill(~ok, _INF), 1, sel)
    ids = torch.gather(beam_ids, 1, sel)
    return d, torch.where(torch.isfinite(d), ids, -1)


# The range around a chain's replay (metrics.span), inside
# "vdb.table.dispatch".
REPLAY_SPAN = "vdb.table.replay"
# Chains a ReplayCache keeps captured (the least recently used goes first),
# and keys it remembers having seen once or having failed to capture.
REPLAY_CHAINS = 4
REPLAY_SIGHTINGS = 64

# One capture at a time in the process (a CUDA graph capture owns the
# caching allocator's routing to its pool while it runs).
_CAPTURE_LOCK = threading.Lock()


def _ident(t: Optional[torch.Tensor]):
    return None if t is None else (t.device, t.data_ptr(), tuple(t.shape),
                                   t.dtype)


def replay_key(qp_shape, table, norms, adjacency, rep_ids, valid,
               metric: int, beam_width: int, expand: int, max_iters: int,
               num_seeds: int, term_width: int, k_out: int, compact: int,
               fused, scale, plan: WalkPlan) -> tuple:
    """What a captured beam_search_topk chain depends on: the queries'
    shape, every scalar of the walk and its plan, and the identity (device,
    address, shape, dtype) of every device input. A chain holds the tensors
    it read, so an equal identity is the same memory."""
    return (tuple(qp_shape), int(metric), int(beam_width), int(expand),
            int(max_iters), int(num_seeds), int(term_width), int(k_out),
            int(compact), plan, _ident(table), _ident(norms),
            _ident(adjacency), _ident(rep_ids), _ident(valid), _ident(fused),
            None if scale is None else float(scale))


def _capturable(table: torch.Tensor, plan: WalkPlan, max_iters: int) -> bool:
    """A chain can be captured on a CUDA table whose walk reads nothing
    back to the host: not a deep walk of a launch an iteration (traverse
    asks the host for the flag every DEEP_CHECK_EVERY launches)."""
    return table.is_cuda and (plan.mode == "walk"
                              or max_iters <= UNROLL_MAX_ITERS)


def _launch_counts() -> tuple:
    return (launches, dict(launches_by_plan), gather.launches,
            dict(gather.launches_by_row_bytes))


def _add_launch_counts(counts: tuple, sign: int = 1) -> None:
    """Adds (or with sign -1 takes away) a _launch_counts() difference to
    this module's and ops/gather's launch counters."""
    global launches
    n, by_plan, g, by_row = counts
    launches += sign * n
    gather.launches += sign * g
    for into, add in ((launches_by_plan, by_plan),
                      (gather.launches_by_row_bytes, by_row)):
        for k, v in add.items():
            into[k] = into.get(k, 0) + sign * v


def _launch_diff(a: tuple, b: tuple) -> tuple:
    return (b[0] - a[0], {k: v - a[1].get(k, 0) for k, v in b[1].items()},
            b[2] - a[2], {k: v - a[3].get(k, 0) for k, v in b[3].items()})


class _Chain:
    """One captured beam_search_topk: `inputs` (its arguments after the
    queries, held so that no address it reads is freed while it lives),
    the pinned query it uploads (`q_np`) into `q_dev`, its CUDA `graph`,
    the pinned (d, ids) it copies back (`d_np`, `ids_np`; each numpy view
    holds its tensor), the
    event `done` that the graph's last node records, the kernel launches
    a replay makes (`launches`, a _launch_counts() difference), `owner`:
    a weak reference to the Replayed of a replay not yet fetched, and
    `unfetched`: the last replay's Replayed was dropped unfetched."""

    def __init__(self, inputs: tuple):
        self.inputs = inputs
        self.owner = None
        self.unfetched = False
        self.q_np = self.q_dev = self.graph = None
        self.d_np = self.ids_np = self.done = self.launches = None

    def busy(self) -> bool:
        return self.owner is not None and self.owner() is not None

    def claim(self) -> "Replayed":
        token = Replayed(self)
        self.unfetched = self.owner is not None  # not busy: it died
        self.owner = weakref.ref(token)
        return token

    def launch(self, qp: np.ndarray) -> None:
        if self.unfetched:  # that replay may still read the pinned query
            self.done.synchronize()
        self.q_np[...] = qp
        with span(REPLAY_SPAN):
            self.graph.replay()
        _add_launch_counts(self.launches)
        metrics.inc("cuda_graph_replays_total")


class Replayed:
    """A replay of a captured chain: fetch() waits for it and returns
    copies of its ([b, k_out] f32 distances, [b, k_out] int32 ids), as
    numpy, so the next replay cannot overwrite an unread answer."""

    def __init__(self, chain: _Chain):
        self.chain = chain

    def fetch(self) -> Tuple[np.ndarray, np.ndarray]:
        c = self.chain
        c.done.synchronize()
        out = (c.d_np.copy(), c.ids_np.copy())
        c.owner = None
        return out


def _capture(chain: _Chain, qp: np.ndarray) -> None:
    """Warm up beam_search_topk(qp, *chain.inputs) on a side stream, then
    capture there, into a CUDA graph with a private memory pool, the
    query's upload from a pinned buffer, the search, the copy of its
    (d, ids) into pinned buffers, and the record of `done` (an event
    record node: no record call a replay). Raises RuntimeError where the
    card will not capture the chain."""
    dev = chain.inputs[0].device
    chain.done = torch.cuda.Event(external=True)
    q_host = torch.from_numpy(qp).pin_memory()
    chain.q_np = q_host.numpy()
    chain.q_dev = torch.empty(qp.shape, dtype=torch.float32, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        chain.q_dev.copy_(q_host, non_blocking=True)
        d, ids = beam_search_topk(chain.q_dev, *chain.inputs)
        d_host = torch.empty(d.shape, dtype=d.dtype, pin_memory=True)
        ids_host = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
        before = _launch_counts()
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            chain.q_dev.copy_(q_host, non_blocking=True)
            d, ids = beam_search_topk(chain.q_dev, *chain.inputs)
            d_host.copy_(d, non_blocking=True)
            ids_host.copy_(ids, non_blocking=True)
            chain.done.record()
        finally:
            # A capture launches nothing: its counts go to each replay.
            chain.launches = _launch_diff(before, _launch_counts())
            _add_launch_counts(chain.launches, -1)
            graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    chain.graph = graph
    chain.d_np, chain.ids_np = d_host.numpy(), ids_host.numpy()


class ReplayCache:
    """beam_search_topk for one table's dense graph queries, replayed from
    a captured CUDA graph where its inputs repeat. A key (replay_key) is
    captured the second time it is seen, so a key seen once never pays for
    a capture, and replayed from then on; a key whose capture raised runs
    eager from then on. A chain has one replay in flight: while its
    answer is unfetched, a call with its key runs eager. At most
    REPLAY_CHAINS chains are kept; dropping one (eviction, clear()) frees
    its graph's memory pool and the tensors it held. Counts every call in
    `metrics`: cuda_graph_replays_total, cuda_graph_captures_total and
    cuda_graph_eager_total (first sightings, busy chains, refused keys,
    inputs that do not repeat, and every call on the CPU)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._chains: "OrderedDict[tuple, _Chain]" = OrderedDict()
        self._seen: "OrderedDict[tuple, bool]" = OrderedDict()
        self._refused: "OrderedDict[tuple, bool]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._chains)

    def clear(self) -> None:
        """Drop every chain and sighting (a new index or a new mask)."""
        with self._lock:
            self._chains.clear()
            self._seen.clear()
            self._refused.clear()

    def search_topk(self, qp: np.ndarray, table, norms, adjacency, rep_ids,
                    valid, metric: int, beam_width: int, expand: int,
                    max_iters: int, num_seeds: int, term_width: int,
                    k_out: int, compact: int = 0, fused=None, scale=None,
                    repeats: bool = True):
        """beam_search_topk of the [b, D] f32 host queries `qp` (the
        arguments after them as there). `repeats`: whether the inputs can
        recur (False for a mask made for this call alone: its address
        would be captured for nothing). Returns the eager chain's device
        (d, ids), or a Replayed: the same values, bit for bit."""
        inputs = (table, norms, adjacency, rep_ids, valid, metric,
                  beam_width, expand, max_iters, num_seeds, term_width,
                  k_out, compact, fused, scale)
        plan = _plan(qp.shape[0], beam_width, expand, adjacency.shape[1],
                     qp.shape[1], table.dtype, fused is not None,
                     expand * max_iters, table.device)
        token = (self._claim(qp, inputs, plan)
                 if repeats and _capturable(table, plan, max_iters) else None)
        if token is None:
            metrics.inc("cuda_graph_eager_total")
            return beam_search_topk(torch.from_numpy(qp).to(table.device),
                                    *inputs)
        token.chain.launch(qp)
        return token

    def _claim(self, qp: np.ndarray, inputs: tuple,
               plan: WalkPlan) -> Optional[Replayed]:
        """The claimed chain of this call's key (captured now on its second
        sighting), or None where the call runs eager."""
        key = replay_key(qp.shape, *inputs, plan)
        with self._lock:
            chain = self._chains.get(key)
            if chain is not None:
                if chain.busy():
                    return None
                self._chains.move_to_end(key)
                return chain.claim()
            if key in self._refused:
                return None
            if self._seen.pop(key, None) is None:
                _remember(self._seen, key)
                return None
            chain = self._chains[key] = _Chain(inputs)
            while len(self._chains) > REPLAY_CHAINS:
                self._chains.popitem(last=False)
            token = chain.claim()
        try:
            with _CAPTURE_LOCK:
                _capture(chain, qp)
        except RuntimeError as e:
            logger.info(f"beam search chain of {qp.shape[0]} queries "
                        f"({plan.variant}/{plan.mode}) not captured, runs "
                        f"eager: {e}")
            with self._lock:
                if self._chains.get(key) is chain:
                    del self._chains[key]
                _remember(self._refused, key)
            return None
        metrics.inc("cuda_graph_captures_total")
        return token


def _remember(keys: "OrderedDict", key) -> None:
    keys[key] = True
    while len(keys) > REPLAY_SIGHTINGS:
        keys.popitem(last=False)


def _exact_rerank_device(q_f32: torch.Tensor, table_f32: torch.Tensor,
                         d_approx: torch.Tensor, ids: torch.Tensor,
                         metric: int, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """On-device exact f32 re-rank of candidate ids: gather the candidate
    rows from an f32 table copy and re-score them ELEMENTWISE (no matmul,
    so no TF32 or reduced-precision operand path can reach it) — the same
    arithmetic as the host flat.exact_rerank, so reported distances are
    exact and bf16 near-ties are ordered correctly on the device. Equal
    distances keep the lower candidate column (stable sort), as
    lax.top_k."""
    cand = gather_rows(table_f32, ids.to(torch.int32))
    if metric == int(MetricType.EUCLIDEAN):
        diff = cand - q_f32[:, None, :]
        d = (diff * diff).sum(dim=2)
    else:
        ip = (cand * q_f32[:, None, :]).sum(dim=2)
        d = 1.0 - ip if metric == int(MetricType.COSINE) else -ip
    d = d.masked_fill((ids < 0) | ~torch.isfinite(d_approx), _INF)
    kk = min(k, d.shape[1])
    vals, sel = torch.sort(d, dim=1, stable=True)
    vals, sel = vals[:, :kk], sel[:, :kk]
    out_ids = torch.gather(ids, 1, sel)
    return vals, torch.where(torch.isfinite(vals), out_ids, -1)


def beam_search_grouped(queries_g, table, norms, adjacency, rep_ids, valid,
                        table_f32, metric: int, beam_width: int, expand: int,
                        max_iters: int, num_seeds: int, term_width: int,
                        k_cand: int, k_out: int, compact: int = 0,
                        fused=None, scale=None, pack_out: bool = False,
                        wire: str = "f32"):
    """Throughput mode: G query batches ([G, B, D] f32) through
    beam_search_topk in order, each followed by the exact f32 re-rank to
    k_out when table_f32 is given (else the k_cand approximate candidates
    go back for the host re-rank). Traversal scores the query wire's
    values (ops/qwire.apply_wire, one prologue over the G batches); the
    re-rank scores the f32 queries. pack_out returns one [G, B, 2w] int32
    array: f32 distance bits in [..., :w], ids in [..., w:]
    (unpack_wire)."""
    g, b, dp = queries_g.shape
    wired = qwire.apply_wire(queries_g.reshape(g * b, dp),
                             wire).reshape(g, b, dp)
    ds, ids = [], []
    for q, qw in zip(queries_g, wired):
        d, i = beam_search_topk(qw, table, norms, adjacency, rep_ids, valid,
                                metric, beam_width, expand, max_iters,
                                num_seeds, term_width, k_cand, compact,
                                fused, scale)
        if table_f32 is not None:
            d, i = _exact_rerank_device(q, table_f32, d, i, metric, k_out)
        ds.append(d)
        ids.append(i)
    ds, ids = torch.stack(ds), torch.stack(ids)
    if pack_out:
        return torch.cat([ds.contiguous().view(torch.int32), ids], dim=-1)
    return ds, ids


def beam_search(graph, queries: np.ndarray, valid: np.ndarray,
                metric: MetricType, beam_width: int = 128,
                expand: int = DEFAULT_EXPAND, max_iters: int = 0,
                num_seeds: int = 32, term_width: int = 0,
                compact: int = 0) -> np.ndarray:
    """Search `graph` (a GraphIndex) for a [B, D] query batch. Returns
    candidate ids [B, beam_width] int64 (unfiltered, -1 padded); the caller
    filters and re-ranks."""
    b, dim = queries.shape
    table = graph.table
    qp = np.zeros((b, table.shape[1]), dtype=np.float32)
    qp[:, :dim] = queries
    if max_iters <= 0:
        max_iters = beam_width
    d, ids, _ = beam_search_kernel(
        torch.from_numpy(qp).to(table.device), table, graph.norms,
        graph.adjacency, graph.rep_ids, int(metric), int(beam_width),
        int(expand), int(max_iters), num_seeds, int(term_width),
        int(compact))
    ids = ids.cpu().numpy().astype(np.int64)
    ids[~np.isfinite(d.cpu().numpy())] = -1
    return ids
