"""Batched best-first beam search over a fixed-degree graph (counterpart of
vectordb_tpu/ops/beam.py).

A batch of queries each holds a beam of L (distance, row, expanded) entries
kept sorted by distance, advanced in lockstep:

  iteration = pick the M best unexpanded beam entries
            -> gather their adjacency rows      (ops/gather: the CUDA kernel)
            -> drop padding, beam members, duplicates and visited rows
            -> gather the candidates' rows and score them against the query
            -> merge with the beam, stable sort by distance, keep L

Every row gather goes through ops/gather.gather_rows, which launches the
hand-written kernel csrc/gather_rows.cu on CUDA tensors. Scores are f32:
bf16 and int8 operands are upcast before each product (their products are
exact in f32, TF32 is off), matching the JAX package's f32-accumulating
einsums up to summation order.

Translation notes:
  - `lax.sort` of (distance, id, expanded) becomes a stable `torch.sort` of
    the distance with ids and flags gathered by its permutation; the stable
    compaction sort stays stable.
  - Pick rule: the beam is always sorted, so the M best unexpanded finite
    entries are the first M of them in beam order; the pick takes them in
    position order (and unavailable positions after them, also in order).
    Equal scores therefore go to the lower beam position, which is
    `lax.top_k`'s rule, and the pick is deterministic on the card too.
    The masked top-k of beam_search_topk uses the same rule.
  - Duplicate detection takes `torch.argmax` of a uint8 equality matrix
    (torch's argmax rejects bool); its first-maximum rule is jnp.argmax's.
  - Seeding from >= 4,096 representatives uses exact `torch.topk` where the
    JAX package takes `approx_min_k` (exact on the CPU).
  - Traversals of at most UNROLL_MAX_ITERS iterations run as a fixed-depth
    loop in which a converged batch keeps its state (`torch.where` on a
    device scalar), so the loop never waits for the device and one
    traversal can later be captured as a CUDA graph. Deeper walks test the
    convergence on the host before each iteration.
  - beam_search_grouped takes f32 queries and a query wire (ops/qwire):
    traversal runs on the wire's values, as JAX's decoded `packed_gb`
    buffer, and the exact re-rank on the f32 queries, where JAX re-ranks
    against the wire's values.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..schema import MetricType
from . import qwire
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


def beam_search_kernel(queries: torch.Tensor, table: torch.Tensor,
                       norms: torch.Tensor, adjacency: torch.Tensor,
                       rep_ids: torch.Tensor, metric: int, beam_width: int,
                       expand: int, max_iters: int, num_seeds: int = 32,
                       term_width: int = 0, compact: int = 0,
                       fused: Optional[torch.Tensor] = None,
                       scale: Optional[float] = None):
    """Seed scan over the representatives, then up to max_iters expansions.

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
    b, d = queries.shape
    dev = table.device
    L, M = beam_width, expand
    R = adjacency.shape[1]
    C = M * R
    cp_all = compact if compact > 0 else C
    q = queries.to(table.dtype)
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
    cols = torch.arange(C, device=dev)
    tw = min(term_width if term_width > 0 else L, L)

    def has_work(state):
        _, exp, bd, _ = state
        return (~exp[:, :tw] & torch.isfinite(bd[:, :tw])).any()

    def body(state, it: int, cp: int):
        beam_ids, beam_exp, beam_d, visited = state
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

        all_d = torch.cat([beam_d, cand_d], dim=1)
        all_ids = torch.cat([beam_ids, cand_ids], dim=1)
        all_exp = torch.cat([beam_exp, torch.zeros_like(cand_ids,
                                                        dtype=torch.bool)],
                            dim=1)
        sd, order = torch.sort(all_d, dim=1, stable=True)
        keep = order[:, :L]
        return (torch.gather(all_ids, 1, keep),
                torch.gather(all_exp, 1, keep), sd[:, :L], visited)

    state = (beam_ids, beam_exp, beam_d, visited)
    done = 0
    if fused is None and 0 < cp_all < C and max_iters > 0:
        # Iteration 0 runs uncompacted: every seed's edges are fresh there,
        # and truncation would drop the lower-ranked seeds' neighbourhoods
        # while marking them expanded.
        state = body(state, 0, 0)
        done = 1
    if max_iters <= UNROLL_MAX_ITERS:
        for it in range(done, max_iters):
            live = has_work(state)
            nxt = body(state, it, cp_all)
            state = tuple(torch.where(live, new, old)
                          for new, old in zip(nxt, state))
    else:
        it = done
        while it < max_iters and bool(has_work(state)):
            state = body(state, it, cp_all)
            it += 1
    beam_ids, _, beam_d, visited = state
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
