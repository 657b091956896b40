"""SPLADE-like sparse rows, and queries of terms drawn from stored rows.

A frozen copy of the repository's validated generators (chip_smoke.
make_sparse and sparse_queries): each row is `draws_per_row` Zipf(zipf_s)
term draws over a `vocab`-term vocabulary, mapped through a fixed
permutation of the vocabulary, sorted and deduplicated (about 126 distinct
terms at 215 draws of Zipf(1.1) over 30,109 terms), values gamma(1, 1), all
drawn on the device from one torch.Generator of the configuration's
data_seed (one fixed table, as the source's passages are one fixed set); a
query is `query_terms` terms of a random stored row of at least that many,
values drawn again from gamma(1, 1), by a numpy Generator of the run's
seed.
"""
from __future__ import annotations

import numpy as np
import torch

ROWS_A_DRAW = 100_000


def make(cfg: dict, seed: int, dev: torch.device, pool: int) -> dict:
    n, vocab, draws = cfg["rows"], cfg["vocab"], cfg["draws_per_row"]
    g = torch.Generator(device=dev).manual_seed(cfg["data_seed"])
    p = torch.arange(1, vocab + 1, dtype=torch.float64,
                     device=dev) ** -cfg["zipf_s"]
    cdf = torch.cumsum(p, 0)
    cdf /= cdf[-1].clone()
    perm = torch.randperm(vocab, generator=g, device=dev)
    idx_parts, counts = [], []
    for s in range(0, n, ROWS_A_DRAW):
        m = min(ROWS_A_DRAW, n - s)
        u = torch.rand((m, draws), generator=g, device=dev,
                       dtype=torch.float64)
        t = perm[torch.searchsorted(cdf, u).clamp_(max=vocab - 1)]
        t = torch.sort(t, dim=1).values
        keep = torch.ones_like(t, dtype=torch.bool)
        keep[:, 1:] = t[:, 1:] != t[:, :-1]
        idx_parts.append(t[keep])
        counts.append(keep.sum(1))
    indices = torch.cat(idx_parts).cpu().numpy().astype(np.int64)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(torch.cat(counts).cpu().numpy(), out=offsets[1:])
    values = torch.empty(len(indices), dtype=torch.float32,
                         device=dev).exponential_(generator=g).cpu().numpy()
    queries = sparse_queries(indices, offsets, pool,
                             np.random.default_rng(seed), cfg["query_terms"])
    schema = [{"name": "ID", "dataType": "INT", "primaryKey": True},
              {"name": cfg["field"], "dataType": "SPARSE_VECTOR_FLOAT",
               "dimensions": vocab, "metricType": cfg["metric"]}]
    return {"kind": "sparse", "n": n, "schema": schema,
            "raw": {"indices": indices, "values": values, "offsets": offsets,
                    "vocab": vocab},
            "queries": queries, "attributes": {},
            "stats": {"rows": n, "nnz": int(len(indices)), "vocab": vocab}}


def sparse_queries(indices: np.ndarray, offsets: np.ndarray, n_q: int,
                   rng: np.random.Generator, terms: int) -> list:
    """Queries of `terms` terms of a random stored row (rows with at least
    that many), values drawn again from gamma(1, 1), as the API's dicts."""
    out = []
    rows = np.nonzero(np.diff(offsets) >= terms)[0]
    for r in rng.choice(rows, n_q, replace=False):
        row = indices[offsets[r]:offsets[r + 1]]
        pick = np.sort(rng.choice(len(row), terms, replace=False))
        out.append({"indices": row[pick].tolist(),
                    "values": rng.gamma(1.0, 1.0, terms).astype(
                        np.float32).tolist()})
    return out
