"""vectordb_tpu_torch.ops.partial_min against the Pallas kernel of
vectordb_tpu.ops.pallas_topk (interpret mode on the CPU).

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel is held against that same plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py. Tolerance: both sides add
exact bf16 x bf16 products in f32, in different orders, so values must
agree within rtol 1e-5 and atol 1e-5 * max(|q|^2 + |x|^2); survivor ids
must be equal position by position (the inputs below make every sum
exact, so ties are real and the tie rule is exercised).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vectordb_tpu_torch
from vectordb_tpu.ops import pallas_topk
from vectordb_tpu.schema import MetricType
from vectordb_tpu_torch.config import global_config as torch_config
from vectordb_tpu_torch.ops import partial_min

METRICS = [MetricType.EUCLIDEAN, MetricType.COSINE, MetricType.DOT_PRODUCT]


@pytest.fixture(autouse=True)
def _reset_port():
    saved = dict(vars(torch_config))
    yield
    vectordb_tpu_torch._reset_for_tests()
    vars(torch_config).update(saved)


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Force pallas interpret mode so the TPU kernel runs on the CPU."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    # the module refers to pl.pallas_call at call time
    monkeypatch.setattr(pallas_topk.pl, "pallas_call", patched)


def _exact_data(seed, n, d, b):
    """Quarter-integer values in [-4, 4]: exact in bf16, and every dot
    product and norm is exact in f32 whatever the summation order."""
    rng = np.random.default_rng(seed)
    x = np.clip(np.round(rng.normal(size=(n, d)) * 4) / 4, -4, 4)
    q = np.clip(np.round(rng.normal(size=(b, d)) * 4) / 4, -4, 4)
    return x.astype(np.float32), q.astype(np.float32)


def _both_scans(x, q, metric, q_base=0, n_valid=None, mask=None,
                exclude_self=False):
    n = x.shape[0]
    n_valid = n if n_valid is None else n_valid
    xn = (x ** 2).sum(1).astype(np.float32)
    qn = (q ** 2).sum(1).astype(np.float32)
    jv, ji = pallas_topk.partial_min_scan(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(qn), jnp.int32(q_base),
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(xn), int(metric),
        n_valid=n_valid, exclude_self=exclude_self,
        mask=None if mask is None else jnp.asarray(mask))
    tv, ti = partial_min.partial_min_scan(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(qn), q_base,
        torch.from_numpy(x).bfloat16(), torch.from_numpy(xn), int(metric),
        n_valid=n_valid, exclude_self=exclude_self,
        mask=None if mask is None else torch.from_numpy(mask))
    atol = 1e-5 * float(qn.max() + xn.max())
    return (np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy(), atol)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("variant", ["plain", "mask", "n_valid",
                                     "exclude_self"])
def test_scan_matches_pallas(interpret_kernels, metric, variant):
    n, d, b = 16384, 128, 128  # two table tiles of 8192 rows
    x, q = _exact_data(int(metric) * 10 + len(variant), n, d, b)
    kw = {}
    if variant == "mask":
        mask = np.ones(n, np.float32)
        mask[np.random.default_rng(5).random(n) < 0.1] = 0.0
        kw["mask"] = mask
    elif variant == "n_valid":
        kw["n_valid"] = n - 3000
    elif variant == "exclude_self":
        q_base = 8192 + 40  # queries are rows q_base.., inside tile 1
        q = x[q_base:q_base + b].copy()
        kw.update(q_base=q_base, exclude_self=True)
    jv, ji, tv, ti, atol = _both_scans(x, q, metric, **kw)
    assert tv.shape == jv.shape == (b, 2 * n // 64)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=atol)
    if variant == "exclude_self":
        own = (kw["q_base"] + np.arange(b))[:, None]
        assert not (ti[np.isfinite(tv)] == np.broadcast_to(
            own, ti.shape)[np.isfinite(tv)]).any()


def test_scan_cpu_runs_plain_version_uncounted():
    x, q = _exact_data(1, 8192, 128, 128)
    partial_min.reset_launches()
    qn = torch.from_numpy((q ** 2).sum(1))
    v, i = partial_min.partial_min_scan(
        torch.from_numpy(q), qn, 0, torch.from_numpy(x),
        torch.from_numpy((x ** 2).sum(1)), int(MetricType.EUCLIDEAN),
        n_valid=8192)
    v2, i2 = partial_min.partial_min_scan_ref(
        torch.from_numpy(q), qn, 0, torch.from_numpy(x),
        torch.from_numpy((x ** 2).sum(1)), int(MetricType.EUCLIDEAN),
        n_valid=8192)
    assert partial_min.launches == 0
    assert torch.equal(v, v2) and torch.equal(i, i2)


def test_exclude_self_masks_whole_batch_diagonal(interpret_kernels):
    """Divergence from the TPU kernel, on purpose: Pallas masks row
    q_base + (i mod 128) in every 128-query tile, the port masks
    q_base + i for query i of the batch. The first tile agrees."""
    n, d, b, q_base = 8192, 128, 256, 1000
    x, _ = _exact_data(7, n, d, b)
    q = x[q_base:q_base + b].copy()
    jv, ji, tv, ti, atol = _both_scans(x, q, MetricType.EUCLIDEAN,
                                       q_base=q_base, exclude_self=True)
    own = q_base + np.arange(b)
    assert not (ti == own[:, None]).any()
    np.testing.assert_array_equal(ti[:128], ji[:128])
    np.testing.assert_allclose(tv[:128], jv[:128], rtol=1e-5, atol=atol)


def _topk_both(x, q, metric, k, **kw):
    xn = (x ** 2).sum(1).astype(np.float32)
    qn = (q ** 2).sum(1).astype(np.float32)
    mask = kw.pop("mask", None)
    jd, ji = pallas_topk.fused_topk(
        jnp.asarray(q), jnp.asarray(qn), jnp.int32(0), jnp.asarray(x),
        jnp.asarray(xn), int(metric), k, n_valid=x.shape[0],
        mask=None if mask is None else jnp.asarray(mask), **kw)
    td, ti = partial_min.fused_topk(
        torch.from_numpy(q), torch.from_numpy(qn), 0, torch.from_numpy(x),
        torch.from_numpy(xn), int(metric), k, n_valid=x.shape[0],
        mask=None if mask is None else torch.from_numpy(mask), **kw)
    atol = 1e-5 * float(qn.max() + xn.max())
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=atol)
    return ti.numpy()


def test_fused_topk_matches_pallas_self_top1(interpret_kernels):
    rng = np.random.default_rng(0)
    n, d, b = 8192, 128, 128
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = x[:b] + 0.01
    ids = _topk_both(x, q, MetricType.EUCLIDEAN, 16)
    assert (ids[:, 0] == np.arange(b)).all()


def test_fused_topk_mask_matches_pallas(interpret_kernels):
    rng = np.random.default_rng(1)
    n, d, b = 8192, 128, 128
    x = rng.normal(size=(n, d)).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[:b] = 0.0  # exclude the exact matches
    ids = _topk_both(x, x[:b], MetricType.EUCLIDEAN, 8, mask=mask)
    assert (ids >= b).all()


def test_fused_topk_pair_collision_matches_pallas(interpret_kernels):
    """Rows 5 and 133 share strided fold group 5 of tile 0: both must
    survive (best + second-best planes), in both packages."""
    rng = np.random.default_rng(3)
    n, d = 8192, 128
    x = rng.normal(size=(n, d)).astype(np.float32) * 10.0
    q = rng.normal(size=(1, d)).astype(np.float32)
    x[5] = q[0] + 0.001
    x[133] = q[0] + 0.002
    qp = np.broadcast_to(q, (128, d)).copy()
    ids = _topk_both(x, qp, MetricType.EUCLIDEAN, 4)
    assert ids[0, 0] == 5 and ids[0, 1] == 133, ids[0]


def test_fused_topk_exclude_self_matches_pallas(interpret_kernels):
    rng = np.random.default_rng(2)
    n, d, b = 8192, 128, 128
    x = rng.normal(size=(n, d)).astype(np.float32)
    ids = _topk_both(x, x[:b], MetricType.EUCLIDEAN, 4, exclude_self=True)
    assert not (ids[:, 0] == np.arange(b)).any()


@pytest.mark.parametrize("b,n,flops,mbytes,bound,by", [
    # flat-serve: 5.50e11 FLOP on the tensor cores, 608 MB -> 0.18 ms
    (8192, 262_144, 5.50e11, 608, 0.556, "operations"),
    # one exact-KNN block: 2.75e11 FLOP, 545 MB -> 0.16 ms
    (1024, 1_048_576, 2.75e11, 545, 0.278, "operations"),
])
def test_scan_cost_and_bound(b, n, flops, mbytes, bound, by):
    f, nbytes = partial_min.scan_cost(b, n, 128)
    assert f == 2 * b * n * 128
    assert f == pytest.approx(flops, rel=0.01)
    assert nbytes / 1e6 == pytest.approx(mbytes, rel=0.01)
    ms, kind = partial_min.bound_ms(f, nbytes)
    assert kind == by
    assert ms == pytest.approx(bound, rel=0.01)
    assert nbytes / partial_min.H100_HBM_BYTES_PER_S * 1e3 < ms


@pytest.mark.parametrize("metric", METRICS)
def test_column_term(metric):
    """|x|^2 for L2, 0 otherwise, +inf past n_valid and where masked."""
    n = 300
    norms = torch.arange(n, dtype=torch.float32) + 0.5
    mask = torch.ones(n)
    mask[7] = 0
    t = partial_min.column_term(norms, mask, 290, int(metric))
    bad = torch.zeros(n, dtype=torch.bool)
    bad[7] = True
    bad[290:] = True
    assert torch.isinf(t[bad]).all() and torch.isfinite(t[~bad]).all()
    want = norms if metric == MetricType.EUCLIDEAN else torch.zeros(n)
    assert torch.equal(t[~bad], want[~bad])
    assert torch.equal(partial_min.column_term(norms, None, n, int(metric)),
                       want)


@pytest.mark.parametrize("metric", METRICS)
def test_plain_scan_on_column_term_matches_pallas(interpret_kernels, metric):
    """The plain version scores base + column_term; with a mask, n_valid
    not a multiple of 128 and exclude_self at once it equals the Pallas
    kernel position by position (one 128-query tile, where the TPU's
    i mod 128 diagonal is the whole batch's)."""
    n, d, b, q_base = 16384, 128, 128, 8192 + 300
    x, _ = _exact_data(int(metric) + 40, n, d, b)
    q = x[q_base:q_base + b].copy()
    mask = np.ones(n, np.float32)
    mask[np.random.default_rng(6).random(n) < 0.2] = 0.0
    jv, ji, tv, ti, atol = _both_scans(x, q, metric, q_base=q_base,
                                       n_valid=n - 77, mask=mask,
                                       exclude_self=True)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=atol)


def _args(dtype=torch.bfloat16, b=128, d=128, n=8192, qdtype=None):
    return (torch.zeros((b, d), dtype=qdtype or dtype),
            torch.zeros((n, d), dtype=dtype), torch.zeros(b),
            torch.zeros(n))


@pytest.mark.parametrize("args,exc", [
    (_args(torch.float16), TypeError),               # neither bf16 nor f32
    (_args(qdtype=torch.float32), TypeError),        # queries' dtype
    (_args(d=96), ValueError),                       # bf16: D % 64
    (_args(b=64), ValueError),                       # bf16: B % 128
    (_args(torch.float32, d=48), ValueError),        # f32: D % 32
    (_args(torch.float32, b=32), ValueError),        # f32: B % 64
])
def test_kernel_argument_checks(args, exc):
    """The wrapper's checks, callable on the CPU: what the kernel does not
    take raises before any launch."""
    with pytest.raises(exc):
        partial_min.check_kernel_args(*args)


@pytest.mark.parametrize("args", [
    _args(), _args(d=192, b=256), _args(torch.float32, b=64, d=32)])
def test_kernel_argument_checks_pass(args):
    partial_min.check_kernel_args(*args)
    q, t, qn, _ = args
    with pytest.raises(ValueError):  # norms must be [N]
        partial_min.check_kernel_args(q, t, qn, torch.zeros(5))
