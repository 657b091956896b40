"""Dense rows of a low intrinsic dimension, held-out queries of the same
process, and uniform attributes.

A point is a draw of `latent_dim` coordinates around one of `centers`
Gaussian centres (centres N(0, center_scale^2), the point its centre +
N(0, 1)), carried into the `dim` columns by a fixed random isometry (the
first `latent_dim` rows of an orthogonal matrix), plus N(0, noise^2) in
every column. The rows are one fixed draw of that process from the
configuration's data_seed, as the source's base set is one
fixed set; the run's seed draws the query pool fresh from the same process.
So a query is never a stored row or a copy of one: its neighbours are other
points of its cluster, as a held-out query's are. Attributes: INT uniform
in [low, high], DOUBLE uniform in [low, high). All drawn on the device from
torch.Generators in a few large calls.
"""
from __future__ import annotations

import torch

ROWS_A_DRAW = 1 << 18


def _points(g, n: int, centers: torch.Tensor, basis: torch.Tensor,
            noise: float) -> torch.Tensor:
    dev = centers.device
    out = torch.empty((n, basis.shape[1]), device=dev)
    for s in range(0, n, ROWS_A_DRAW):
        m = min(ROWS_A_DRAW, n - s)
        z = centers[torch.randint(0, len(centers), (m,), generator=g,
                                  device=dev)]
        z.add_(torch.randn(z.shape, generator=g, device=dev))
        torch.matmul(z, basis, out=out[s:s + m])
        out[s:s + m].add_(torch.randn((m, basis.shape[1]), generator=g,
                                      device=dev), alpha=noise)
    return out


def make(cfg: dict, seed: int, dev: torch.device, pool: int) -> dict:
    g = torch.Generator(device=dev).manual_seed(cfg["data_seed"])
    n, d, r = cfg["rows"], cfg["dim"], cfg["latent_dim"]
    centers = torch.randn((cfg["centers"], r), generator=g,
                          device=dev).mul_(cfg["center_scale"])
    basis = torch.linalg.qr(torch.randn((d, d), generator=g, device=dev,
                                        dtype=torch.float64))[0]
    basis = basis[:r].float().contiguous()
    x = _points(g, n, centers, basis, cfg["noise"])
    attributes = {}
    for a in cfg["attributes"]:
        if a["dataType"] == "INT":
            v = torch.randint(a["low"], a["high"] + 1, (n,), generator=g,
                              device=dev)
        else:
            v = torch.rand((n,), generator=g, device=dev,
                           dtype=torch.float64)
            v = v * (a["high"] - a["low"]) + a["low"]
        attributes[a["name"]] = v.cpu().numpy()
    gq = torch.Generator(device=dev).manual_seed(seed)
    q = _points(gq, pool, centers, basis, cfg["noise"])
    schema = ([{"name": "ID", "dataType": "INT", "primaryKey": True}]
              + [{"name": a["name"], "dataType": a["dataType"]}
                 for a in cfg["attributes"]]
              + [{"name": cfg["field"], "dataType": "VECTOR_FLOAT",
                  "dimensions": d, "metricType": cfg["metric"]}])
    return {"kind": "dense", "n": n, "schema": schema,
            "raw": {"x": x.cpu().numpy()}, "queries": q.cpu().numpy(),
            "attributes": attributes, "stats": {"rows": n, "dim": d}}
