"""The sparse scorer's one-pass CSR inner product (ops/sparse.csr_ip) on the
CPU, where it runs its plain version csr_ip_ref.

csr_ip_ref against the JAX package's scorer, vectordb_tpu/ops/sparse.py's
_sparse_ip_kernel (gather, multiply, prefix-sum difference; a jitted XLA
program run on the JAX CPU backend), on the same seeded numpy inputs,
within rtol 1e-5 and atol 1e-5. The values are multiples of 1/16 in
[-1, 1], so every product and every partial sum of both packages is exact
in f32 and a difference can only be one of semantics (the clamp to the
scatter's trailing zero, the row boundaries, empty rows), never of
summation order; the port's f32 arithmetic is held to a float64 row sum
on gamma-distributed values apart. The wrapper's argument checks, the
kernel's cost and variant rule, and the CPU route of
SparseColumnIndex.device_scores (the plain version, no launch).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import vectordb_tpu_torch as tvdb
from vectordb_tpu.ops import sparse as jsparse
from vectordb_tpu_torch.ops import partial_min
from vectordb_tpu_torch.ops import sparse as tsparse
from vectordb_tpu_torch.schema import MetricType

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _cpu_port():
    tvdb.set_device("cpu")  # the CPU run of the port: plain versions
    yield
    tvdb._reset_for_tests()


def _dyadic(rng, n):
    return (rng.integers(-16, 17, n) / 16).astype(np.float32)


def _column(rng, lengths, dim):
    """CSR (indices int32, values f32, offsets int64) of rows of the given
    lengths, each a sorted draw of distinct terms below dim."""
    idx = [np.sort(rng.choice(dim, size=m, replace=False)) for m in lengths]
    indices = (np.concatenate(idx) if idx else np.zeros(0)).astype(np.int32)
    offsets = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return indices, _dyadic(rng, len(indices)), offsets


def _case(name):
    """(indices, values, offsets, query terms, query values)."""
    rng = np.random.default_rng(11)
    if name == "random":
        lengths = rng.integers(1, 40, 300)
        qi = np.sort(rng.choice(400, 60, replace=False))
        dim = 400
    elif name == "empty_rows":  # leading, inner and trailing
        lengths = [0, 0, 5, 0, 0, 0, 17, 3, 0, 1, 0, 0]
        qi, dim = np.arange(0, 64, 3), 64
    elif name == "query_past_every_index":
        lengths = rng.integers(1, 20, 50)
        qi, dim = np.array([5, 70, 300, 999]), 100
    elif name == "stored_past_the_query":  # they read the trailing zero
        lengths = rng.integers(5, 30, 80)
        qi, dim = np.array([0, 3, 9, 20]), 500
    elif name == "long_row":  # one row of 5,000 nnz among short ones
        lengths = [3, 5000, 0, 7]
        qi = np.sort(rng.choice(8000, 2000, replace=False))
        dim = 8000
    elif name == "single_row":
        lengths = [33]
        qi, dim = np.arange(0, 50, 2), 50
    elif name == "one_term_scatter":
        lengths = rng.integers(0, 10, 100)
        qi, dim = np.array([7]), 20
    indices, values, offsets = _column(rng, np.asarray(lengths), dim)
    return indices, values, offsets, qi, _dyadic(rng, len(qi))


CASES = ["random", "empty_rows", "query_past_every_index",
         "stored_past_the_query", "long_row", "single_row",
         "one_term_scatter"]


def _scatter(qi, qv):
    """The port's scatter (ops/sparse.SparseColumnIndex.device_scores):
    qmax + 1 floats plus the trailing zero."""
    q = np.zeros(int(qi.max()) + 2, np.float32)
    q[qi] = qv
    return q


@pytest.mark.parametrize("case", CASES)
def test_csr_ip_ref_matches_jax(case):
    indices, values, offsets, qi, qv = _case(case)
    q = _scatter(qi, qv)
    want = np.asarray(jsparse._sparse_ip_kernel(
        jnp.asarray(indices), jnp.asarray(values),
        jnp.asarray(offsets.astype(np.int32)), jnp.asarray(q[:-1])))
    got = tsparse.csr_ip(torch.from_numpy(indices), torch.from_numpy(values),
                         torch.from_numpy(offsets), torch.from_numpy(q))
    assert got.dtype == torch.float32 and got.shape == (len(offsets) - 1,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if case == "empty_rows":
        empty = np.diff(offsets) == 0
        assert not got.numpy()[empty].any()


@pytest.mark.parametrize("case", ["random", "long_row"])
def test_csr_ip_ref_is_close_to_float64(case):
    """gamma(1, 1) values and query weights: each row within rtol 1e-5 of
    the float64 row sum, plus 1e-5 x sum |q_i x_i| (the port's sparse
    tolerance, PERF.md section 2)."""
    indices, _, offsets, qi, _ = _case(case)
    rng = np.random.default_rng(12)
    values = rng.gamma(1.0, 1.0, len(indices)).astype(np.float32)
    q = _scatter(qi, rng.gamma(1.0, 1.0, len(qi)).astype(np.float32))
    prod = (q[np.minimum(indices, len(q) - 1)].astype(np.float64)
            * values.astype(np.float64))
    exact = np.array([prod[a:b].sum() for a, b in
                      zip(offsets[:-1], offsets[1:])])
    mag = np.array([np.abs(prod[a:b]).sum() for a, b in
                    zip(offsets[:-1], offsets[1:])])
    got = tsparse.csr_ip_ref(torch.from_numpy(indices),
                             torch.from_numpy(values),
                             torch.from_numpy(offsets),
                             torch.from_numpy(q)).double().numpy()
    assert (np.abs(got - exact) <= RTOL * np.abs(exact) + 1e-5 * mag).all()


def test_csr_ip_of_a_column_without_nnz_is_zero():
    got = tsparse.csr_ip(torch.zeros(0, dtype=torch.int32),
                         torch.zeros(0), torch.zeros(4, dtype=torch.int64),
                         torch.ones(3))
    assert got.tolist() == [0.0, 0.0, 0.0]


def _args():
    return (torch.tensor([0, 2, 1, 3], dtype=torch.int32),
            torch.tensor([1.0, 2.0, 3.0, 4.0]),
            torch.tensor([0, 1, 4], dtype=torch.int64),
            torch.tensor([1.0, 0.5, 0.25, 0.0]))


@pytest.mark.parametrize("bad,err", [
    ("idx_int64", TypeError), ("val_float64", TypeError),
    ("offs_int32", TypeError), ("q_bf16", TypeError),
    ("idx_strided", ValueError), ("q_strided", ValueError),
    ("val_shorter", ValueError), ("idx_2d", ValueError),
    ("offs_empty", ValueError), ("q_empty", ValueError),
    ("q_other_device", ValueError), ("idx_other_device", ValueError),
])
def test_csr_ip_rejects_what_the_kernel_does_not_take(bad, err):
    idx, val, offs, q = _args()
    if bad == "idx_int64":
        idx = idx.long()
    elif bad == "val_float64":
        val = val.double()
    elif bad == "offs_int32":
        offs = offs.int()
    elif bad == "q_bf16":
        q = q.bfloat16()
    elif bad == "idx_strided":
        idx = torch.arange(8, dtype=torch.int32)[::2]
    elif bad == "q_strided":
        q = torch.ones(8)[::2]
    elif bad == "val_shorter":
        val = val[:3]
    elif bad == "idx_2d":
        idx, val = idx.reshape(2, 2), val.reshape(2, 2)
    elif bad == "offs_empty":
        offs = offs[:0]
    elif bad == "q_empty":
        q = q[:0]
    elif bad == "q_other_device":
        q = q.to("meta")
    else:
        idx = idx.to("meta")
    with pytest.raises(err):
        tsparse.csr_ip(idx, val, offs, q)


def test_csr_ip_cost_at_the_chip_shape():
    """The 1M-row SPLADE-like column of chip_smoke.py: 120,277,676 nnz over
    BERT's 30,522 terms (a scatter of 30,523 floats): about 970 MB, 0.29 ms
    at the H100's 3.35 TB/s."""
    nbytes = tsparse.csr_ip_cost(120_277_676, 1_000_000, 30_523)
    assert nbytes == 8 * 120_277_676 + 8 * 1_000_001 + 4 * 30_523 + 4_000_000
    assert nbytes == pytest.approx(970e6, rel=0.01)
    ms, by = partial_min.bound_ms(0, nbytes)
    assert by == "bytes" and ms == pytest.approx(0.29, rel=0.01)


def test_the_scatter_variant_follows_the_shared_memory_limit():
    """The scatter stays in shared memory up to Hopper's 232,448 bytes a
    block: BERT's vocabulary does, a scatter of 200,001 floats does not."""
    assert tsparse.MAX_SHARED_SCATTER == 58_112
    assert tsparse.scatter_variant(30_523) == "shared"
    assert tsparse.scatter_variant(58_112) == "shared"
    assert tsparse.scatter_variant(58_113) == "l2"
    assert tsparse.scatter_variant(200_001) == "l2"


def test_device_scores_on_the_cpu_take_the_plain_version():
    indices, values, offsets, qi, qv = _case("random")
    col = [tsparse.SparseVector(indices[a:b].astype(np.int64), values[a:b])
           for a, b in zip(offsets[:-1], offsets[1:])]
    index = tsparse.SparseColumnIndex(col, len(col))
    tsparse.reset_launches()
    got = index.device_scores(tsparse.SparseVector(qi.astype(np.int64), qv),
                              MetricType.DOT_PRODUCT)
    want = -tsparse.csr_ip_ref(torch.from_numpy(indices),
                               torch.from_numpy(values),
                               torch.from_numpy(offsets),
                               torch.from_numpy(_scatter(qi, qv)))
    assert not got.is_cuda
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tsparse.launches == 0 and tsparse.launches_by_variant == {}


def test_device_offsets_keep_counts_past_int32():
    """The device offsets are the host's int64 offsets: boundaries at and
    past 2^31 nnz reach the scorer unchanged (they wrapped when the upload
    cast them to int32). The case is built on the offsets alone, without
    2^31 nnz behind them."""
    col = [tsparse.SparseVector(np.array([1], np.int64),
                                np.array([1.0], np.float32))] * 2
    index = tsparse.SparseColumnIndex(col, 2)
    index.offsets = np.array([0, 2**31 + 7, 2**32 + 1], np.int64)
    offs = index._device_arrays()[2]
    assert offs.dtype == torch.int64
    assert offs.tolist() == [0, 2**31 + 7, 2**32 + 1]
