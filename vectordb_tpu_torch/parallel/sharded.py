"""Index sharding over a list of devices (counterpart of
vectordb_tpu/parallel/sharded.py).

The JAX package shards a table row-wise over a `jax.sharding.Mesh` and runs
one program per chip under `shard_map`. The port keeps its single
controller: one process drives every shard in turn, and

  - a mesh is a tuple of `torch.device` (`Mesh`), shard i on devices[i]; a
    device may repeat, so S shards can share one card or the CPU (the
    counterpart of the virtual host devices the JAX tests force on XLA);
  - a shard's tensors live on its device, and its step (a flat scan, a
    beam search, a KNN block) runs there;
  - `all_gather` + the global re-rank is one merge: every shard's [B, w]
    candidates are copied to the merge device (the mesh's first device),
    concatenated in shard order and sorted stably, which is
    `lax.top_k`'s tie rule (the lower column wins);
  - `ppermute` around the KNN ring is indexing the ring's block list.

Here rows are contiguous blocks (shard i holds rows [i*Ns, (i+1)*Ns)); the
engine's interleaved layout is in engine.py. Functions take per-shard
tensors as lists, or one array, which is split into S contiguous blocks
and placed on the shards' devices (what a PartitionSpec("shard") argument
does in the JAX package). These functions are the package's public API;
the engine's path is in engine.py.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import default_device
from ..schema import MetricType

SHARD_AXIS = "shard"

_INF = float("inf")


class Mesh:
    """One mesh axis of shards: `devices[i]` holds shard i. `size` is the
    shard count; results are merged on `devices[0]`."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def merge_device(self) -> torch.device:
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(devices=None) -> Mesh:
    """A mesh over `devices` (a device may repeat). None: every CUDA card,
    or one CPU shard when the engine's device is the CPU. A CUDA device
    without a card raises, as `_device.default_device()` does: no shard
    falls back to the CPU."""
    if devices is None:
        dev = default_device()
        devices = ([dev] if dev.type == "cpu" else
                   [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())])
    out = []
    for d in map(torch.device, devices):
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"mesh device {d}: PyTorch sees no CUDA "
                                   "device")
            if d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            if d.index >= torch.cuda.device_count():
                raise ValueError(f"mesh device {d}: only "
                                 f"{torch.cuda.device_count()} CUDA devices")
        elif d.type != "cpu":
            raise ValueError(f"mesh device {d}: CUDA or CPU only")
        out.append(d)
    return Mesh(out)


def split(mesh: Mesh, x) -> List[torch.Tensor]:
    """Per-shard tensors on the shards' devices: a list of S arrays moves
    each to its shard; one array is cut into S contiguous row blocks."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.size:
            raise ValueError(f"{len(x)} blocks for {mesh.size} shards")
        parts = x
    else:
        x = torch.as_tensor(x)
        if x.shape[0] % mesh.size:
            raise ValueError(f"{x.shape[0]} rows do not split into "
                             f"{mesh.size} shards")
        parts = torch.chunk(x, mesh.size)
    return [torch.as_tensor(p).to(d).contiguous()
            for p, d in zip(parts, mesh.devices)]


def replicate(mesh: Mesh, x) -> dict:
    """{device: x on it}, one copy per distinct device of the mesh."""
    x = torch.as_tensor(x)
    return {d: x.to(d) for d in dict.fromkeys(mesh.devices)}


def merge(mesh: Mesh, ds: List[torch.Tensor], ids: List[torch.Tensor],
          k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The all_gather merge: every shard's [B, w] candidates on the merge
    device, shard after shard, then the k smallest by a stable sort (equal
    distances keep the lower column, as lax.top_k). Returns (d [B, k']
    ascending, ids [B, k']), k' = min(k, total width)."""
    dev = mesh.merge_device
    all_d = torch.cat([d.to(dev) for d in ds], dim=1)
    all_i = torch.cat([i.to(dev) for i in ids], dim=1)
    sd, order = torch.sort(all_d, dim=1, stable=True)
    kk = min(k, all_d.shape[1])
    return sd[:, :kk], torch.gather(all_i, 1, order[:, :kk])


class ShardedTable:
    """Row-sharded table: rows zero-padded to a multiple of S, shard i
    holding rows [i * rows_per_shard, (i + 1) * rows_per_shard) on its
    device, with its f32 squared norms."""

    def __init__(self, mesh: Mesh, table_host: np.ndarray,
                 norms_host: Optional[np.ndarray] = None):
        self.mesh = mesh
        n_shards = mesh.size
        n, d = table_host.shape
        if n % n_shards != 0:
            pad = n_shards - n % n_shards
            table_host = np.concatenate(
                [table_host, np.zeros((pad, d), table_host.dtype)], axis=0)
            n += pad
        self.rows_per_shard = n // n_shards
        self.n_rows = n
        if norms_host is None:
            norms_host = np.einsum("nd,nd->n", table_host,
                                   table_host).astype(np.float32)
        self.table = split(mesh, table_host)
        self.norms = split(mesh, np.asarray(norms_host, np.float32))

    def put_adjacency(self, adjacency_host: np.ndarray) -> List[torch.Tensor]:
        """Per-shard adjacency with LOCAL row ids, stacked row-wise."""
        return split(self.mesh, adjacency_host)


def _local_scores(q: torch.Tensor, tab: torch.Tensor, t_norms: torch.Tensor,
                  metric: int) -> torch.Tensor:
    """[B, D] x [N, D] -> [B, N] f32; operands upcast (bf16 products are
    exact in f32, TF32 is off)."""
    qf = q.float()
    ip = qf @ tab.float().T
    if metric == int(MetricType.EUCLIDEAN):
        return (qf * qf).sum(dim=1, keepdim=True) - 2.0 * ip + t_norms[None, :]
    if metric == int(MetricType.COSINE):
        return 1.0 - ip
    return -ip


def sharded_flat_topk(mesh: Mesh, queries, table, norms, mask, metric, k):
    """[B, D] queries vs a row-sharded table -> global top-k: per shard a
    masked distance + top-k over its rows, then one merge. Returns ([B, k]
    dists, [B, k] global ids) on the merge device."""
    tabs, nrms = split(mesh, table), split(mesh, norms)
    msks = split(mesh, mask)
    qs = replicate(mesh, queries)
    local_n = tabs[0].shape[0]
    kk = min(k, local_n)
    ds, gids = [], []
    for s, dev in enumerate(mesh.devices):
        d = _local_scores(qs[dev], tabs[s], nrms[s], int(metric))
        d = d.masked_fill(~msks[s].bool()[None, :], _INF)
        top_d, ids = torch.topk(d, kk, dim=1, largest=False, sorted=True)
        ds.append(top_d)
        gids.append((ids + s * local_n).to(torch.int32))
    return merge(mesh, ds, gids, min(k, mesh.size * kk))


def sharded_beam_search(mesh: Mesh, queries, table, norms, adjacency,
                        rep_ids, metric, beam_width, expand=4, max_iters=32,
                        num_seeds=16):
    """Queries vs a row-sharded table with one graph a shard: each shard
    runs the single-device beam search (ops/beam, row gathers on the
    gather kernel) over its rows and LOCAL adjacency and rep ids; the
    beams are merged. Returns ([B, beam_width] dists, [B, beam_width]
    global ids) on the merge device."""
    from ..ops.beam import beam_search_kernel

    tabs, nrms = split(mesh, table), split(mesh, norms)
    adjs, reps = split(mesh, adjacency), split(mesh, rep_ids)
    qs = replicate(mesh, queries)
    local_n = tabs[0].shape[0]
    ds, gids = [], []
    for s, dev in enumerate(mesh.devices):
        d, ids, _ = beam_search_kernel(
            qs[dev], tabs[s], nrms[s], adjs[s], reps[s], int(metric),
            int(beam_width), int(expand), int(max_iters), int(num_seeds))
        ds.append(d)
        gids.append(torch.where(ids >= 0, ids + s * local_n, -1))
    return merge(mesh, ds, gids, int(beam_width))


def sharded_knn_round(mesh: Mesh, table, norms, n_valid, metric, k):
    """One round of distributed exact-KNN graph construction: shard i
    scores its rows against the block of shard (i - t) mod S at step t
    (the ppermute ring, here an index into the block list), keeping a
    running top-k with its own rows and rows >= n_valid masked. Returns
    one [rows_per_shard, k] tensor of global ids a shard, on its device."""
    tabs, nrms = split(mesh, table), split(mesh, norms)
    n_shards = mesh.size
    local_n = tabs[0].shape[0]
    out = []
    for i, dev in enumerate(mesh.devices):
        my_rows = torch.arange(local_n, device=dev) + i * local_n
        best_d = torch.full((local_n, k), _INF, device=dev)
        best_i = torch.full((local_n, k), -1, dtype=torch.int32, device=dev)
        for t in range(n_shards):
            j = (i - t) % n_shards
            d = _local_scores(tabs[i], tabs[j].to(dev), nrms[j].to(dev),
                              int(metric))
            blk_ids = torch.arange(local_n, device=dev) + j * local_n
            valid = ((blk_ids[None, :] < n_valid)
                     & (blk_ids[None, :] != my_rows[:, None]))
            d = d.masked_fill(~valid, _INF)
            cat_d = torch.cat([best_d, d], dim=1)
            cat_i = torch.cat([best_i, blk_ids.to(torch.int32).expand(
                local_n, local_n)], dim=1)
            sd, sel = torch.sort(cat_d, dim=1, stable=True)
            best_d = sd[:, :k]
            best_i = torch.gather(cat_i, 1, sel[:, :k])
        out.append(best_i)
    return out
