"""k-means over a device table (counterpart of the two functions of
vectordb_tpu/ops/ivf.py that the graph build's representative cover
needs: `_kmeans_iters` and `_assign_all`).

The IVF-partitioned KNN (`ivf_knn`, used from IvfKnnThreshold rows up) is
not ported: a rebuild at that size returns NOT_IMPLEMENTED_ERROR
(table.py) before the build starts.
"""
from __future__ import annotations

import torch


def _kmeans_iters(table: torch.Tensor, norms: torch.Tensor,
                  centroids: torch.Tensor, n_valid: int, block: int,
                  n_iters: int) -> torch.Tensor:
    """Lloyd iterations with one-hot matmul updates (no scatter).

    table [N_pad, D] (bf16 or f32), centroids [C, D] f32; rows >= n_valid
    are left out. Assignment by the largest x.c - |c|^2 / 2, which is the
    nearest centroid. Returns the new centroids; an empty cluster keeps its
    centroid. `norms` is accepted for signature parity and not read. The
    updates are plain f32 matmuls (TF32 off)."""
    n_pad, d = table.shape
    c = centroids.shape[0]
    dev = table.device
    cols = torch.arange(c, device=dev)
    for _ in range(n_iters):
        cn = (centroids * centroids).sum(dim=1)
        sums = torch.zeros((c, d), dtype=torch.float32, device=dev)
        counts = torch.zeros((c,), dtype=torch.float32, device=dev)
        for s in range(0, n_pad, block):
            x = table[s:s + block].float()
            assign = torch.argmax(x @ centroids.T - 0.5 * cn[None, :], dim=1)
            rows_ok = (s + torch.arange(x.shape[0], device=dev)) < n_valid
            onehot = ((assign[:, None] == cols[None, :])
                      & rows_ok[:, None]).float()
            sums = sums + onehot.T @ x
            counts = counts + onehot.sum(dim=0)
        centroids = torch.where(counts[:, None] > 0,
                                sums / counts.clamp(min=1.0)[:, None],
                                centroids)
    return centroids


def _assign_all(table: torch.Tensor, centroids: torch.Tensor, n_valid: int,
                block: int) -> torch.Tensor:
    """Nearest centroid per row: [N_pad] int32 (rows past n_valid are
    assigned too; callers slice them away). argmax returns the first
    maximum, as jnp.argmax."""
    cn = (centroids * centroids).sum(dim=1)
    out = [torch.argmax(table[s:s + block].float() @ centroids.T
                        - 0.5 * cn[None, :], dim=1)
           for s in range(0, table.shape[0], block)]
    return torch.cat(out).to(torch.int32)
