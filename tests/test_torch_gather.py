"""vectordb_tpu_torch.ops.gather against the row gathers of vectordb_tpu:
the Pallas kernel benchmarks/gather_micro.py:pallas_gather (interpret mode
on the CPU) and the `jnp.clip` + `jnp.take` that the JAX traversal does.

On the CPU the port's wrapper runs its plain version; the CUDA kernel is
held against that plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py). A gather copies bytes, so every comparison is bit for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from benchmarks import gather_micro
from vectordb_tpu_torch.ops import gather

# (name, torch dtype, row shape): the traversal's row widths (bf16 store
# rows, int32 adjacency rows of 48 and 64, int8 fused rows of 48 x 128, f32
# re-rank rows), a 4-byte scalar table (norms, reps, masks) and a 12-byte
# row.
CASES = [("bf16_store", torch.bfloat16, (128,)),
         ("int32_adj48", torch.int32, (48,)),
         ("int32_adj64", torch.int32, (64,)),
         ("int8_fused", torch.int8, (48 * 128,)),
         ("f32_rerank", torch.float32, (128,)),
         ("f32_scalar", torch.float32, ()),
         ("int32_row3", torch.int32, (3,))]


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Force pallas interpret mode so the TPU kernel runs on the CPU."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(gather_micro.pl, "pallas_call", patched)


def _table(dtype, row, n, seed):
    rng = np.random.default_rng(seed)
    if dtype.is_floating_point:
        vals = rng.normal(size=(n,) + row).astype(np.float32)
        return torch.from_numpy(vals).to(dtype)
    return torch.from_numpy(rng.integers(-100, 100, (n,) + row)).to(dtype)


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


@pytest.mark.parametrize("name,dtype,row", CASES)
def test_gather_equals_clamped_take(name, dtype, row):
    n = 500
    tab = _table(dtype, row, n, seed=len(name))
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(-4, n + 4, (23, 17)).astype(np.int32))
    out = gather.gather_rows(tab, ids)
    assert out.shape == (23, 17) + tuple(row) and out.dtype == dtype
    want = tab[ids.clamp(0, n - 1).long()]
    assert np.array_equal(_bytes(out), _bytes(want))
    # The JAX callers' clip + take, on the same bytes.
    tab_np = _bytes(tab.reshape(n, -1))
    j = jnp.take(jnp.asarray(tab_np), jnp.clip(jnp.asarray(ids.numpy()),
                                              0, n - 1), axis=0)
    assert np.array_equal(_bytes(out).reshape(np.asarray(j).shape),
                          np.asarray(j))


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.bfloat16, torch.bfloat16),
                                           (jnp.float32, torch.float32)])
def test_gather_matches_pallas_gather(interpret_kernels, jdtype, tdtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(256, 128)).astype(np.float32)
    ids = rng.integers(0, 256, 64).astype(np.int32)
    j = gather_micro.pallas_gather(jnp.asarray(x, jdtype), jnp.asarray(ids),
                                   chunk=16, window=4)
    t = gather.gather_rows(torch.from_numpy(x).to(tdtype),
                           torch.from_numpy(ids))
    assert np.array_equal(_bytes(t),
                          np.asarray(j).view(np.uint8).reshape(64, -1))


def test_gather_on_cpu_runs_plain_version_uncounted():
    tab = _table(torch.float32, (8,), 50, seed=0)
    ids = torch.arange(-2, 60, dtype=torch.int32)
    gather.reset_launches()
    assert torch.equal(gather.gather_rows(tab, ids),
                       gather.gather_rows_ref(tab, ids))
    assert gather.launches == 0


def test_gather_empty_ids():
    tab = _table(torch.int32, (48,), 10, seed=0)
    out = gather.gather_rows(tab, torch.zeros((0, 4), dtype=torch.int32))
    assert out.shape == (0, 4, 48)


@pytest.mark.parametrize("bad", ["int64_ids", "bool_rows", "int16_scalar",
                                 "strided_table", "empty_table"])
def test_gather_rejects_what_the_kernel_does_not_take(bad):
    """The plain version takes exactly what the kernel takes."""
    tab = torch.zeros((10, 8))
    ids = torch.zeros(4, dtype=torch.int32)
    err = ValueError
    if bad == "int64_ids":
        ids, err = ids.long(), TypeError
    elif bad == "bool_rows":
        tab = torch.zeros((10, 3), dtype=torch.bool)
    elif bad == "int16_scalar":
        tab = torch.zeros(10, dtype=torch.int16)
    elif bad == "strided_table":
        tab = tab[:, ::2]
    else:
        tab = torch.zeros((0, 8))
    with pytest.raises(err):
        gather.gather_rows(tab, ids)


@pytest.mark.parametrize("n_ids,row_bytes,want_bytes,want_ms", [
    (196_608, 256, 101_449_728, 0.0303),   # bf16 [1M x 128] store rows
    (8_192, 6_144, 100_696_064, 0.0301),   # int8 [1M x 6,144] fused rows
    (8_192, 192, 3_178_496, 0.00095),      # int32 [1M x 48] adjacency
])
def test_gather_cost_and_bound(n_ids, row_bytes, want_bytes, want_ms):
    """Bytes moved once each (ids, rows read, rows written) and the bound
    at the H100's 3.35 TB/s, at the traversal's three gather shapes."""
    from vectordb_tpu_torch.ops import partial_min
    nbytes = gather.gather_cost(n_ids, row_bytes)
    assert nbytes == want_bytes
    ms, by = partial_min.bound_ms(0, nbytes)
    assert by == "bytes"
    assert ms == pytest.approx(want_ms, rel=0.02)
