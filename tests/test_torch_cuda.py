"""The port on a CUDA device: the partial-min, row-gather, CSR
inner-product, beam-iteration and id-scan kernels against their plain versions, the flat-serve and
graph slices through the kernels, a graph query's device chain replayed
from a captured CUDA graph against its eager run, the query wires' device
round trip against the host's and the flat-serve kernel path under the int8 wire,
device filter masks against the host evaluator, a REST query over a CUDA
store, and sparse scoring, the IVF KNN and hybrid search on the card
against their CPU runs.

These tests need the card and skip without one. They import neither jax
nor vectordb_tpu, so they also run where JAX is not installed:
    python -m pytest tests/test_torch_cuda.py --noconftest -q
Tolerance (kernel vs plain version): both add exact bf16 x bf16 products
in f32 in different orders — rtol 1e-5, atol 1e-5 * max(|q|^2 + |x|^2),
and ids equal except at such near-ties. The row gather copies bytes, so it
must equal its plain version bit for bit, and so must the beam iteration
on integer-valued rows and queries (every f32 sum of its scores is exact
in any order there, and its merge keeps the plain version's ties), and so
must the id scan on such rows (the same exact sums). The
CSR inner product adds the
same f32 products in another order than its plain version: rtol 1e-5 plus
1e-5 x sum |q_i x_i| of the row. Device filter masks must equal
the host evaluator's bit for bit (the adversarial table below is also used
by tests/test_torch_device_filter.py on the CPU).
"""
import functools
import json

import numpy as np
import pytest
import torch

import vectordb_tpu_torch as vdb
from vectordb_tpu_torch.config import global_config
from vectordb_tpu_torch.db_server import DBServer
from vectordb_tpu_torch.expr.evaluator import FilterCompiler
from vectordb_tpu_torch.expr.parser import parse_expr
from vectordb_tpu_torch.ops import (beam, flat, gather, id_scan, partial_min,
                                    qwire)
from vectordb_tpu_torch.rest.server import RestServer
from vectordb_tpu_torch.schema import MetricType

METRICS = [MetricType.EUCLIDEAN, MetricType.COSINE, MetricType.DOT_PRODUCT]

_ULP = float(np.spacing(np.float32(10.5)))
_ADV_PRICES = [10.5, 10.5 + 1e-9, 10.5 - 1e-9, 10.5 + _ULP, 10.5 - _ULP,
               10.5 + _ULP / 2, 10.5 - _ULP / 2, 0.0, -3.25, 1e300]
_ADV_BIG = [(1 << 24) - 1, 1 << 24, (1 << 24) + 1, 1 << 40, (1 << 40) + 1,
            -(1 << 40), (1 << 53) + 1, 0, 7, -7]
_ADV_STOCK = [0, 1, 2, 3, -3, 5, 6, 7, 0, 9]

ADV_FILTERS = [
    "price > 10.5", "price >= 10.5", "price = 10.5", "price < 10.5",
    "price <> 10.5", "big = 16777217", "big > 16777216",
    "big = 1099511627777", "big < 1099511627777", "big = 9007199254740993",
    "price * 2.0 + stock > 30.0", "stock % 3 = 0", "NOT (stock % 3 = 0)",
    "stock % 0 = 0", "price / stock > 1.0", "price / 0 = 0.0",
    "big % stock = 0", "big / stock > 1.0", "stock - 3 * 2 < -1",
    "f32 > 0.1", "f32 * 10 = 1.0", "active AND price > 10.5",
    "active OR stock > 5", "stock > 2.5", "big * 3 > 3298534883328",
    "NEARBY(loc, 10.0, 20.0, 2000.0)",
]


def adversarial_table(tmp_path):
    """The 40-row table of adversarial filter values (on the engine's
    device); returns (table, columns)."""
    n = 40
    i = np.arange(n)
    cols = {"ID": i,
            "price": np.asarray(_ADV_PRICES * 4, np.float64),
            "big": np.asarray(_ADV_BIG * 4, np.int64),
            "stock": np.asarray(_ADV_STOCK * 4, np.int32),
            "f32": np.asarray([0.1, 0.2, 0.30000001, 1e-8] * 10, np.float32),
            "active": i % 3 == 0,
            "loc": (np.linspace(-40, 50, n), np.linspace(-10, 50, n)),
            "V": np.random.default_rng(0).normal(size=(n, 4)).astype(
                np.float32)}
    assert vdb.load_db("adv", str(tmp_path / "adv")) == 0
    vdb.use_db("adv")
    vdb.create_table("t", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "price", "dataType": "DOUBLE"},
        {"name": "big", "dataType": "BIGINT"},
        {"name": "stock", "dataType": "INT"},
        {"name": "f32", "dataType": "FLOAT"},
        {"name": "active", "dataType": "BOOL"},
        {"name": "loc", "dataType": "GEO_POINT"},
        {"name": "V", "dataType": "VECTOR_FLOAT", "dimensions": 4,
         "metricType": "EUCLIDEAN"}])
    vdb.insert_columns("t", cols)
    return vdb._db.databases["adv"].tables["t"], cols


def device_and_host_masks(table, flt):
    """(device mask, host mask) of one filter over the table's rows."""
    seg = table.segment
    n = seg.record_number
    nodes = parse_expr(flt, table.field_type_map)
    compiler = FilterCompiler(nodes, seg.column)
    ctx = table._device_filter(nodes, compiler)
    assert ctx is not None, flt
    store = seg.device_view("V")
    valid_dev = table._device_mask(store.capacity, store.buf.device,
                                   seg.valid_mask(), 0, True)
    dev = ctx.device.mask(valid_dev, store.capacity)
    assert dev.dtype == torch.bool and dev.shape == (store.capacity,)
    assert not dev[n:].any()
    return dev[:n].cpu().numpy(), compiler.mask(n_rows=n)




@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU machine")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _reset_port():
    saved = dict(vars(global_config))
    yield
    vdb._reset_for_tests()
    vars(global_config).update(saved)


def _assert_scan_close(kw):
    before = partial_min.launches
    vk, ik = partial_min.partial_min_scan(**kw)
    vp, ip = partial_min.partial_min_scan_ref(**kw)
    torch.cuda.synchronize()
    assert partial_min.launches == before + 1
    atol = 1e-5 * float(kw["q_norms"].max() + kw["norms"].max())
    torch.testing.assert_close(vk, vp, rtol=1e-5, atol=atol)
    near = (vk - vp).abs() <= atol + 1e-5 * vp.abs()
    assert not bool(((ik != ip) & ~near).any())
    return vk, ik


@pytest.mark.gpu
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain_version(cuda_device, metric, dtype):
    """Mask, n_valid and exclude_self over two query tiles and two table
    tiles."""
    g = torch.Generator(device=cuda_device).manual_seed(int(metric))
    n, d, b, q_base = 16384, 128, 256, 300
    x = torch.randn((n, d), generator=g, device=cuda_device)
    mask = (torch.rand(n, generator=g, device=cuda_device) > 0.1).float()
    tab = x.to(dtype)
    q = x[q_base:q_base + b].clone()
    vk, ik = _assert_scan_close(dict(
        queries=q.to(dtype), q_norms=(q * q).sum(1), q_base=q_base,
        table=tab, norms=(tab.float() ** 2).sum(1), metric=int(metric),
        n_valid=n - 100, exclude_self=True, mask=mask))
    fin = torch.isfinite(vk)
    own = q_base + torch.arange(b, device=cuda_device)[:, None]
    assert not bool(((ik == own) & fin).any())
    assert not bool((mask[ik.long()][fin] == 0).any())
    assert not bool((ik[fin] >= n - 100).any())


@pytest.mark.gpu
@pytest.mark.parametrize("b", [128, 8192])
@pytest.mark.parametrize("d", [128, 256, 768])
def test_tensor_core_scan_shapes(cuda_device, d, b):
    """The bf16 scan at D = 128 and 256 (8,192-row tiles, query tile kept in
    shared memory) and 768 (2,048-row tiles, query chunks streamed), two
    table tiles, n_valid not a multiple of 128, a mask, and exclude_self
    with q_base not a multiple of 128."""
    g = torch.Generator(device=cuda_device).manual_seed(d + b)
    n = 2 * partial_min.pick_tile_c(d)
    q_base = 300
    x = torch.randn((n, d), generator=g, device=cuda_device)
    mask = (torch.rand(n, generator=g, device=cuda_device) > 0.1).float()
    rows = (q_base + torch.arange(b, device=cuda_device)) % n
    q = x[rows] + 0.01 * torch.randn((b, d), generator=g, device=cuda_device)
    tab = x.bfloat16()
    vk, ik = _assert_scan_close(dict(
        queries=q.bfloat16(), q_norms=(q * q).sum(1), q_base=q_base,
        table=tab, norms=(tab.float() ** 2).sum(1),
        metric=int(MetricType.EUCLIDEAN), n_valid=n - 77, exclude_self=True,
        mask=mask))
    assert vk.shape == (b, 2 * n // (partial_min.pick_tile_c(d) // 128))
    fin = torch.isfinite(vk)
    own = q_base + torch.arange(b, device=cuda_device)[:, None]
    assert not bool(((ik == own) & fin).any())
    assert not bool((mask[ik.long()][fin] == 0).any())
    assert not bool((ik[fin] >= n - 77).any())


@pytest.mark.gpu
def test_kernel_masked_stripes_keep_stripe_zero_ids(cuda_device):
    """Tile 0 keeps only stripe 0 (every second slot stays +inf with the
    stripe-0 row), tile 1 is masked whole (both slots +inf, stripe-0 row),
    and one stripe of tile 2 is masked whole; equal to the plain version
    bit for bit on quarter-integer data."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    n, d, b = 4 * 8192, 128, 256
    x = ((torch.randn((n, d), generator=g, device=cuda_device) * 4).round()
         .clamp(-16, 16) / 4)
    mask = torch.ones(n, device=cuda_device)
    mask[128:8192] = 0
    mask[8192:16384] = 0
    mask[16384 + 5 * 128:16384 + 6 * 128] = 0
    q = x[:b].clone()
    kw = dict(queries=q.bfloat16(), q_norms=(q * q).sum(1), q_base=0,
              table=x.bfloat16(), norms=(x * x).sum(1),
              metric=int(MetricType.EUCLIDEAN), n_valid=n, mask=mask)
    vk, ik = partial_min.partial_min_scan(**kw)
    vp, ip = partial_min.partial_min_scan_ref(**kw)
    assert torch.equal(vk, vp) and torch.equal(ik, ip)
    g_cols = n // 64
    lanes = torch.arange(128, device=cuda_device, dtype=torch.int32)
    assert bool(torch.isfinite(vk[:, :128]).all())
    assert bool(torch.isinf(vk[:, g_cols:g_cols + 256]).all())
    assert bool((ik[:, g_cols:g_cols + 128] == lanes).all())
    assert bool(torch.isinf(vk[:, 128:256]).all())
    assert bool((ik[:, 128:256] == 8192 + lanes).all())
    assert bool((ik[:, g_cols + 128:g_cols + 256] == 8192 + lanes).all())


@pytest.mark.gpu
@pytest.mark.parametrize("metric", METRICS)
def test_kernel_tie_rule_is_exact(cuda_device, metric):
    """Quarter-integer data make every score exact in f32 in any order, so
    scores tie often and kernel and plain version must agree bit for bit:
    the earlier stripe keeps a tie, an empty second slot keeps stripe 0."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    n, d, b = 16384, 128, 128
    x = (torch.randn((n, d), generator=g, device=cuda_device) * 4).round()
    x = x.clamp(-16, 16) / 4
    q = x[:b].clone()
    mask = (torch.rand(n, generator=g, device=cuda_device) > 0.5).float()
    kw = dict(queries=q.bfloat16(), q_norms=(q * q).sum(1), q_base=0,
              table=x.bfloat16(), norms=(x * x).sum(1), metric=int(metric),
              n_valid=n, mask=mask)
    vk, ik = partial_min.partial_min_scan(**kw)
    vp, ip = partial_min.partial_min_scan_ref(**kw)
    assert torch.equal(vk, vp) and torch.equal(ik, ip)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((8192, 128), device=cuda_device, dtype=torch.float16)
    kw = dict(queries=x[:128], q_norms=torch.zeros(128, device=cuda_device),
              q_base=0, table=x, norms=torch.zeros(8192, device=cuda_device),
              metric=1, n_valid=8192)
    with pytest.raises(TypeError):
        partial_min.partial_min_scan(**kw)
    kw.update(table=x.float(), queries=x[:128].bfloat16())
    with pytest.raises(TypeError):
        partial_min.partial_min_scan(**kw)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", METRICS)
def test_flat_serve_kernel_path_matches_plain_scan(cuda_device, metric):
    """flat_serve_grouped through the kernel against the plain masked scan
    on the card. Partial-min keeps two survivors per group, picked on bf16
    scores, so it may drop a neighbor the full scan keeps: the contract is
    recall@10 >= 0.99 against the full scan, with every reported distance
    exact."""
    rng = np.random.default_rng(int(metric))
    cap, d, gb = 16384, 128, 256
    x = rng.normal(size=(cap, d)).astype(np.float32)
    if metric == MetricType.COSINE:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.integers(0, cap, gb)] + 0.05 * rng.normal(
        size=(gb, d)).astype(np.float32)
    valid = torch.from_numpy(rng.random(cap) > 0.05).to(cuda_device)
    xt = torch.from_numpy(x).to(cuda_device)
    qt = torch.from_numpy(q).to(cuda_device)
    args = (qt, xt.bfloat16(), (xt * xt).sum(1), valid, xt, int(metric),
            42, 10, cap)
    before = partial_min.launches
    dk, ik = flat.flat_serve_grouped(*args, use_pallas=True, pack_out=False)
    dp, ip = flat.flat_serve_grouped(*args, use_pallas=False,
                                     pack_out=False)
    assert partial_min.launches == before + 1
    ik, ip = ik.cpu().numpy(), ip.cpu().numpy()
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(ik, ip))
    assert hits / ip.size >= 0.99
    assert valid.cpu().numpy()[ik].all()
    exact = flat.exact_rerank(q, x, ik, metric)
    np.testing.assert_allclose(dk.cpu().numpy(), exact, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_query_wire_on_the_card_equals_the_host(cuda_device, wire):
    """ops/qwire.apply_wire on the card equals the host round trip bit for
    bit: mixed scales, all-zero rows, hot blocks, block maxima whose int8
    scale sits on a bf16 tie, and a dim of 100."""
    rng = np.random.default_rng(3)
    q = (rng.normal(size=(4096, 128))
         * rng.uniform(0.01, 100.0, size=(4096, 1))).astype(np.float32)
    q[::97] = 0.0
    q[1::89, :qwire.QBLOCK] = 1e4
    hi = (0x3C00 + rng.integers(0, 0x300, size=(64, 16))).astype(np.uint32)
    amax = ((hi << 16) | 0x8000).view(np.float32) * np.float32(127.0)
    ties = rng.uniform(-1.0, 1.0, size=(64, 16, qwire.QBLOCK)).astype(
        np.float32) * amax[:, :, None]
    ties[:, :, 0] = amax
    for c in (q, q[:512, :100], ties.reshape(64, 128)):
        c = np.ascontiguousarray(c)
        got = qwire.apply_wire(torch.from_numpy(c).to(cuda_device), wire)
        assert got.is_cuda and got.dtype == torch.float32
        np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                      qwire.roundtrip(c, wire).view(np.uint32))


@pytest.mark.gpu
@pytest.mark.parametrize("metric", METRICS)
def test_flat_serve_kernel_path_under_int8_matches_plain_version(
        cuda_device, monkeypatch, metric):
    """flat_serve_grouped under the int8 wire, kernel against the plain
    partial-min on the card: equal candidate sets (table_f32 None), except
    where the sets part at near-ties of the last candidate's score (both
    add exact bf16 products in f32 in different orders). The plain run on
    the host-rounded f32 queries is the plain int8 run, bit for bit."""
    rng = np.random.default_rng(10 + int(metric))
    cap, d, gb = 16384, 128, 256
    x = rng.normal(size=(cap, d)).astype(np.float32)
    if metric == MetricType.COSINE:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.integers(0, cap, gb)] + 0.05 * rng.normal(
        size=(gb, d)).astype(np.float32)
    valid = torch.from_numpy(rng.random(cap) > 0.05).to(cuda_device)
    xt = torch.from_numpy(x).to(cuda_device)
    norms = (xt * xt).sum(1)

    def serve(queries, wire):
        return flat.flat_serve_grouped(
            torch.from_numpy(queries).to(cuda_device), xt.bfloat16(), norms,
            valid, None, int(metric), 42, 10, cap, use_pallas=True,
            pack_out=False, wire=wire)

    before = partial_min.launches
    dk, ik = serve(q, "int8")
    assert partial_min.launches == before + 1
    monkeypatch.setattr(partial_min, "partial_min_scan",
                        partial_min.partial_min_scan_ref)
    dp, ip = serve(q, "int8")
    dh, ih = serve(qwire.roundtrip_int8(q), "f32")
    assert torch.equal(dp, dh) and torch.equal(ip, ih)
    dk, ik, dp, ip = (t.cpu().numpy() for t in (dk, ik, dp, ip))
    qr = qwire.roundtrip_int8(q)
    atol = 1e-5 * float((qr.astype(np.float64) ** 2).sum(1).max()
                        + (x.astype(np.float64) ** 2).sum(1).max())
    for r in range(gb):
        a, b = set(ik[r].tolist()), set(ip[r].tolist())
        if a == b:
            continue
        edge = dp[r, -1]
        tol = atol + 1e-5 * abs(edge)
        assert abs(dk[r, -1] - edge) <= tol, r
        for ids, dd in ((ik[r], dk[r]), (ip[r], dp[r])):
            odd = np.isin(ids, list(a ^ b))
            assert (np.abs(dd[odd] - edge) <= tol).all(), r
    assert valid.cpu().numpy()[ik[ik >= 0]].all()


@pytest.mark.gpu
def test_grouped_search_goes_through_kernel(cuda_device, tmp_path):
    n, dim = 20000, 128
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    assert vdb.load_db("g", str(tmp_path / "g")) == 0
    vdb.use_db("g")
    vdb.create_table("t", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "Emb", "dataType": "VECTOR_FLOAT", "dimensions": dim,
         "metricType": "EUCLIDEAN"}])
    vdb.insert_columns("t", {"ID": np.arange(n), "Emb": x})
    vdb.delete_by_pk("t", list(range(0, n, 5)))
    table = vdb._db.databases["g"].tables["t"]
    queries = x[rng.integers(0, n, 600)] + 0.05 * rng.normal(
        size=(600, dim)).astype(np.float32)
    valid = table.segment.valid_mask()
    partial_min.reset_launches()
    ids, d = table.grouped_dense_search("Emb", queries, valid,
                                        MetricType.EUCLIDEAN, 10, batch=128)
    assert partial_min.launches > 0
    assert table.segment.device_view("Emb").buf.is_cuda
    alive = np.arange(n) % 5 != 0
    for i in range(0, 600, 20):
        dd = ((x - queries[i]) ** 2).sum(1)
        want = np.argsort(np.where(alive, dd, np.inf))[:10]
        assert set(ids[i].tolist()) == set(want.tolist())
        np.testing.assert_allclose(d[i], dd[ids[i]], rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,row", [
    (torch.bfloat16, (128,)), (torch.int32, (48,)), (torch.int32, (64,)),
    (torch.int8, (48 * 128,)), (torch.float32, (128,)), (torch.float32, ()),
    (torch.int32, (3,)), (torch.int32, (2,)), (torch.bfloat16, (4,)),
    (torch.float32, (6,))])
def test_gather_kernel_is_bit_exact(cuda_device, dtype, row):
    """Every row width the traversal uses, the 4-byte scalars, rows of 12
    bytes (the 4-byte vector path) and of 8 and 24 bytes (the 8-byte
    path); ids include -1 and ids past the end, which clamp."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    n = 5000
    if dtype.is_floating_point:
        tab = torch.randn((n,) + row, generator=g,
                          device=cuda_device).to(dtype)
    else:
        tab = torch.randint(-100, 100, (n,) + row, generator=g,
                            device=cuda_device).to(dtype)
    ids = torch.randint(-3, n + 3, (37, 29), generator=g,
                        device=cuda_device, dtype=torch.int32)
    before = gather.launches
    out = gather.gather_rows(tab, ids)
    ref = gather.gather_rows_ref(tab, ids)
    torch.cuda.synchronize()
    assert gather.launches == before + 1
    assert out.shape == ids.shape + tab.shape[1:]
    assert torch.equal(out.view(torch.uint8), ref.view(torch.uint8))
    assert torch.equal(ref, tab[ids.clamp(0, n - 1).long()])


def _random_table(dev, dtype, shape, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    return torch.randint(-100, 100, shape, generator=g, device=dev,
                         dtype=dtype)


def _assert_gather_exact(tab, ids):
    out = gather.gather_rows(tab, ids)
    ref = gather.gather_rows_ref(tab, ids)
    torch.cuda.synchronize()
    assert out.shape == ids.shape + tab.shape[1:]
    assert torch.equal(out.view(torch.uint8), ref.view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,row", [(torch.bfloat16, (128,)),
                                       (torch.float32, ())])
def test_gather_kernel_many_passes_of_the_grid(cuda_device, dtype, row):
    """A gather of millions of vectors: 4 x what the card holds in flight
    at once (SMs x 2,048 threads x 8 vectors, the most any path keeps a
    thread), so blocks run in many waves."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    tab = _random_table(cuda_device, dtype, (100_000,) + row, seed=5)
    vecs_per_row = max(1, gather._row_bytes(tab) // 16)
    n_ids = 4 * sms * 2048 * 8 // vecs_per_row + 77
    g = torch.Generator(device=cuda_device).manual_seed(6)
    ids = torch.randint(-3, 100_003, (n_ids,), generator=g,
                        device=cuda_device, dtype=torch.int32)
    _assert_gather_exact(tab, ids)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,row,offset", [
    (torch.float32, (), 1),     # 4-byte rows, pointer 4 bytes past 16
    (torch.float32, (2,), 2),   # 8-byte rows, pointer 8 bytes past 16
    (torch.float32, (4,), 1),   # 16-byte rows, pointer 4 bytes past 16
    (torch.int32, (64,), 3)])   # 256-byte rows, pointer 12 bytes past 16
def test_gather_kernel_on_unaligned_tables(cuda_device, dtype, row, offset):
    """A table that starts inside a buffer (as a slice from row 1 does)
    takes the narrower vector path that its pointer allows."""
    n = 3000
    width = int(np.prod(row)) if row else 1
    flat = _random_table(cuda_device, dtype, ((n + 1) * width,), seed=7)
    tab = flat[offset:offset + n * width].view((n,) + row)
    assert tab.is_contiguous() and tab.data_ptr() % 16 != 0
    g = torch.Generator(device=cuda_device).manual_seed(8)
    ids = torch.randint(-2, n + 2, (4097,), generator=g,
                        device=cuda_device, dtype=torch.int32)
    _assert_gather_exact(tab, ids)


@pytest.mark.gpu
def test_gather_counts_launches_by_row_width(cuda_device):
    """One launch a call, under the bytes of a table row; zero ids launch
    nothing and count nothing, and keep the shape (scalars included)."""
    tab = _random_table(cuda_device, torch.int32, (500, 48), seed=9)
    scal = _random_table(cuda_device, torch.float32, (500,), seed=10)
    ids = torch.arange(-1, 40, device=cuda_device, dtype=torch.int32)
    gather.reset_launches()
    gather.gather_rows(tab, ids)
    gather.gather_rows(tab, ids.view(1, -1))
    gather.gather_rows(scal, ids)
    assert gather.launches == 3
    assert gather.launches_by_row_bytes == {192: 2, 4: 1}
    none = torch.zeros((0, 4), device=cuda_device, dtype=torch.int32)
    assert gather.gather_rows(tab, none).shape == (0, 4, 48)
    assert gather.gather_rows(scal, none[:, 0]).shape == (0,)
    assert gather.launches == 3
    assert gather.launches_by_row_bytes == {192: 2, 4: 1}


@pytest.mark.gpu
def test_gather_kernel_on_a_device_other_than_the_current(cuda_device):
    """The operator launches on the table's card, on that card's current
    stream, and leaves the current device as it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev1 = torch.device("cuda", 1)
    tab = _random_table(dev1, torch.bfloat16, (2000, 128), seed=11)
    ids = torch.randint(-2, 2002, (999,), device=dev1, dtype=torch.int32)
    ref = gather.gather_rows_ref(tab, ids)
    side = torch.cuda.Stream(device=dev1)
    side.wait_stream(torch.cuda.current_stream(dev1))
    with torch.cuda.device(0):
        out = gather.gather_rows(tab, ids)
        assert torch.cuda.current_device() == 0
        with torch.cuda.stream(side):  # makes cuda:1 current
            torch.cuda.set_device(0)
            assert torch.cuda.current_stream(dev1) == side
            out_side = gather.gather_rows(tab, ids)
            assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(dev1)
    for o in (out, out_side):
        assert o.device == dev1
        assert torch.equal(o.view(torch.uint8), ref.view(torch.uint8))


@pytest.mark.gpu
def test_gather_raises_when_the_operator_does_not_load(cuda_device,
                                                       monkeypatch,
                                                       tmp_path):
    """No fallback: on a CUDA table a library that does not load raises;
    the plain version does not run instead."""
    from vectordb_tpu_torch import _cuda_build

    bad = tmp_path / "gather_rows_op-000000000000.so"
    bad.write_bytes(b"not a shared library")
    monkeypatch.setattr(gather, "_op", None)
    monkeypatch.setattr(_cuda_build, "_registered", {})
    monkeypatch.setattr(_cuda_build, "library_path", lambda name: str(bad))
    tab = torch.zeros((10, 8), device=cuda_device)
    with pytest.raises(RuntimeError, match="did not load"):
        gather.gather_rows(tab, torch.zeros(4, dtype=torch.int32,
                                            device=cuda_device))


@pytest.mark.gpu
def test_gather_kernel_rejects_what_it_does_not_take(cuda_device):
    tab = torch.zeros((10, 8), device=cuda_device)
    ids = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        gather.gather_rows(tab, ids.long())
    with pytest.raises(ValueError):
        gather.gather_rows(tab[:, ::2], ids)
    with pytest.raises(ValueError):  # 3-byte rows
        gather.gather_rows(tab[:, :3].bool().contiguous(), ids)
    with pytest.raises(ValueError):
        gather.gather_rows(tab, ids.cpu())
    # The operator itself checks what the wrapper passes on unchecked.
    with pytest.raises(ValueError, match="ids on cpu"):
        torch.ops.vdb.gather_rows(tab, ids.cpu())
    with pytest.raises(TypeError):
        torch.ops.vdb.gather_rows(tab, ids.long())


@pytest.mark.gpu
@pytest.mark.parametrize("fused", ["auto", "off"])
def test_graph_slice_goes_through_both_kernels(cuda_device, tmp_path, fused):
    """rebuild() on the card launches the partial-min kernel (exact KNN),
    traversal launches the gather kernel; recall and exact distances."""
    n, dim = 30000, 128
    rng = np.random.default_rng(1)
    centers = rng.normal(size=(300, dim)).astype(np.float32) * 2
    x = (centers[rng.integers(0, 300, n)]
         + rng.normal(size=(n, dim)).astype(np.float32))
    assert vdb.load_db("g", str(tmp_path / "g"), vector_scale=n) == 0
    vdb.use_db("g")
    vdb.create_table("t", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "Emb", "dataType": "VECTOR_FLOAT", "dimensions": dim,
         "metricType": "EUCLIDEAN"}])
    vdb.insert_columns("t", {"ID": np.arange(n), "Emb": x})
    assert vdb.update_config({"FlatServe": "off",
                              "FusedTraversal": fused}) == 0
    partial_min.reset_launches()
    assert vdb.rebuild() == 0
    assert partial_min.launches > 0
    table = vdb._db.databases["g"].tables["t"]
    queries = x[rng.integers(0, n, 1000)] + 0.1 * rng.normal(
        size=(1000, dim)).astype(np.float32)
    gather.reset_launches()
    ids, d = table.grouped_dense_search(
        "Emb", queries, table.segment.valid_mask(), MetricType.EUCLIDEAN,
        10, batch=256)
    assert gather.launches > 0
    hits = 0
    for i in range(0, 1000, 10):
        dd = ((x - queries[i]) ** 2).sum(1)
        hits += len(set(ids[i].tolist()) & set(np.argsort(dd)[:10].tolist()))
        np.testing.assert_allclose(d[i], dd[ids[i]], rtol=1e-5)
    assert hits / 1000 >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("flt", ADV_FILTERS)
def test_device_mask_on_cuda_equals_host_mask(cuda_device, tmp_path, flt):
    table, _ = adversarial_table(tmp_path)
    assert table.segment.device_column("price", 4096).is_cuda
    dev, host = device_and_host_masks(table, flt)
    np.testing.assert_array_equal(dev, host, err_msg=flt)


@pytest.mark.gpu
def test_rest_query_from_cuda_store(cuda_device, tmp_path):
    """In-process REST over a CUDA store: filtered and unfiltered queries
    against a masked numpy oracle, through the columnar encoder."""
    n, dim = 20000, 128
    rng = np.random.default_rng(4)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    price = rng.uniform(0, 100, n)
    rest = RestServer(DBServer())
    try:
        assert rest.dispatch("POST", "/api/load", {
            "name": "r", "path": str(tmp_path / "r")}, {})[0] == 200
        assert rest.dispatch("POST", "/api/r/schema/tables", {
            "name": "t", "fields": [
                {"name": "ID", "dataType": "INT", "primaryKey": True},
                {"name": "price", "dataType": "DOUBLE"},
                {"name": "Emb", "dataType": "VECTOR_FLOAT",
                 "dimensions": dim, "metricType": "EUCLIDEAN"}]}, {})[0] \
            == 200
        assert rest.db.insert_columns("r", "t", {
            "ID": np.arange(n), "price": price, "Emb": x}).ok()
        table = rest.db.get_db("r").get_table("t")
        for flt, keep in (("", np.ones(n, bool)),
                          ("price > 50.0", price > 50.0)):
            q = x[123] + 0.05 * rng.normal(size=dim).astype(np.float32)
            code, payload = rest.dispatch("POST", "/api/r/data/query", {
                "table": "t", "queryVector": q.tolist(), "limit": 10,
                "response": ["ID"], "withDistance": True, "filter": flt},
                {})
            assert code == 200
            rows = (json.loads(payload) if isinstance(payload, bytes)
                    else payload)["result"]
            ids = np.asarray([r["ID"] for r in rows])
            d = ((x - q) ** 2).sum(1)
            want = np.argsort(np.where(keep, d, np.inf))[:10]
            assert set(ids.tolist()) == set(want.tolist()), flt
            np.testing.assert_allclose([r["@distance"] for r in rows],
                                       d[ids], rtol=1e-5)
        assert table.segment.device_view("Emb").buf.is_cuda
        assert table._device_filter_cache
    finally:
        rest.db.stop()


def _sparse_rows(rng, n_rows, dim, nnz):
    """(indices, values) rows of `nnz` distinct sorted terms, every 13th
    row empty."""
    rows = []
    for r in range(n_rows):
        m = 0 if r % 13 == 5 else nnz
        idx = np.sort(rng.choice(dim, size=m, replace=False)).astype(np.int64)
        rows.append((idx, rng.gamma(1.0, 1.0, m).astype(np.float32)))
    return rows


@pytest.mark.gpu
@pytest.mark.parametrize("metric", METRICS)
def test_sparse_scores_on_the_card_match_the_cpu_route(cuda_device, metric):
    """SparseColumnIndex on the card (the csr_ip kernel, one launch a
    non-empty query, no gather) against the same index on the CPU (plain
    versions), rtol 1e-5; query terms past every stored index and an empty
    query included."""
    from vectordb_tpu_torch.ops import sparse

    rng = np.random.default_rng(6)
    rows = _sparse_rows(rng, 5000, 3000, 40)
    col = [sparse.SparseVector(i, v) for i, v in rows]
    gpu = sparse.SparseColumnIndex(col, len(col))
    vdb.set_device("cpu")
    cpu = sparse.SparseColumnIndex(col, len(col))
    for qi, qv in ((rows[17][0][:12], rng.gamma(1, 1, 12)),
                   (np.array([5, 2999, 4000, 9000]), np.ones(4)),
                   (np.zeros(0, np.int64), np.zeros(0))):
        q = sparse.SparseVector(np.asarray(qi, np.int64),
                                np.asarray(qv, np.float32))
        gather.reset_launches()
        sparse.reset_launches()
        got = gpu.device_scores(q, metric)
        assert got.is_cuda and got.shape == (len(col),)
        assert sparse.launches == (1 if len(qi) else 0)
        assert gather.launches == 0
        torch.testing.assert_close(got.cpu(), cpu.device_scores(q, metric),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", METRICS)
def test_sparse_search_on_the_card_matches_float64(cuda_device, tmp_path,
                                                   metric):
    """Table.search over 100,000 Zipf(1.1) rows (215 draws over 30,109
    terms, ~126 distinct a row), 8 queries of 49 terms of a stored row: the
    kernel's candidates re-ranked in one pass over the CSR snapshot give the
    float64 oracle's top 10 (a swap only between rows whose oracle
    distances lie within 1e-6) at its distances, rtol 1e-6; every candidate
    counted in sparse_rerank_rows_total."""
    from vectordb_tpu_torch.metrics import metrics
    from vectordb_tpu_torch.ops import sparse

    rng = np.random.default_rng(17)
    n, vocab = 100_000, 30_109
    cdf = np.cumsum(np.arange(1, vocab + 1, dtype=np.float64) ** -1.1)
    perm = rng.permutation(vocab)
    col = []
    for s in range(0, n, 10_000):
        t = np.sort(perm[np.minimum(np.searchsorted(
            cdf, rng.random((10_000, 215)) * cdf[-1]), vocab - 1)], axis=1)
        for row in t:
            idx = row[np.r_[True, row[1:] != row[:-1]]].astype(np.int64)
            col.append(sparse.SparseVector(
                idx, rng.gamma(1.0, 1.0, len(idx)).astype(np.float32)))
    vdb.set_device("cuda")
    assert vdb.load_db("z", str(tmp_path / "z")) == 0
    vdb.use_db("z")
    vdb.create_table("t", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "S", "dataType": "SPARSE_VECTOR_FLOAT",
         "dimensions": vocab, "metricType": metric.name}])
    code, res = vdb.insert_columns("t", {"ID": np.arange(n), "S": col})
    assert code == 0 and res["inserted"] == n
    stored = vdb._db.databases["z"].tables["t"].segment.sparse_cols["S"][:n]
    lens = np.array([len(v.indices) for v in stored])
    row_of = np.repeat(np.arange(n), lens)
    x_idx = np.concatenate([v.indices for v in stored])
    x_val = np.concatenate([v.values for v in stored]).astype(np.float64)
    xn = np.bincount(row_of, weights=x_val * x_val, minlength=n)
    name = "sparse_rerank_rows_total"
    before = metrics.snapshot()["counters"].get(name, 0)
    sparse.reset_launches()
    for r in rng.choice(np.nonzero(lens >= 49)[0], 8, replace=False):
        qi = np.sort(rng.choice(stored[r].indices, 49, replace=False))
        qv = rng.gamma(1.0, 1.0, 49).astype(np.float32)
        q = sparse.SparseVector(qi, qv)
        if metric == MetricType.COSINE:
            q = q.normalized()
        qd = np.zeros(vocab)
        qd[q.indices] = q.values
        ip = np.bincount(row_of, weights=qd[x_idx] * x_val, minlength=n)
        qn = float(np.dot(q.values.astype(np.float64),
                          q.values.astype(np.float64)))
        od = (qn + xn - 2.0 * ip if metric == MetricType.EUCLIDEAN
              else 1.0 - ip if metric == MetricType.COSINE else -ip)
        want = np.argsort(od, kind="stable")[:10]
        code, rows = vdb.query("t", "S", {"indices": qi.tolist(),
                                          "values": qv.tolist()},
                               ["ID"], 10, "", True)
        assert code == 0 and len(rows) == 10
        got = np.array([row["ID"] for row in rows])
        assert len(set(got.tolist())) == 10
        assert all(g == w or abs(od[g] - od[w]) <= 1e-6
                   for g, w in zip(got, want)), (got, want)
        np.testing.assert_allclose([row["@distance"] for row in rows],
                                   od[got], rtol=1e-6)
    assert sparse.launches == 8
    assert metrics.snapshot()["counters"].get(name, 0) - before == 8 * 42


def _zipf_csr(dev, n_rows, n_terms, seed):
    """A CSR column on the card: Zipf(1.5) row lengths up to 3,000, then
    rows of 0, 1, 2, 3, 1,025 and 5,000 nnz and trailing empty rows, so row
    offsets fall on every residue mod 4 and nnz is not a multiple of 4;
    sorted distinct term ids below n_terms, values gamma(1, 1)."""
    rng = np.random.default_rng(seed)
    lengths = np.minimum(rng.zipf(1.5, n_rows), 3000)
    lengths = np.concatenate([lengths, [0, 1, 2, 3, 1025, 0, 5000, 0, 0]])
    if lengths.sum() % 4 == 0:
        lengths[0] += 1
    idx = np.concatenate([np.sort(rng.choice(n_terms, m, replace=False))
                          for m in lengths]).astype(np.int32)
    offs = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offs[1:])
    val = rng.gamma(1.0, 1.0, len(idx)).astype(np.float32)
    return (torch.from_numpy(idx).to(dev), torch.from_numpy(val).to(dev),
            torch.from_numpy(offs).to(dev))


def _assert_csr_ip_close(idx, val, offs, q):
    """csr_ip (the kernel) against csr_ip_ref on the same inputs, within
    rtol 1e-5 plus 1e-5 x sum |q_i x_i| of the row: the two add the same
    f32 products in different orders."""
    from vectordb_tpu_torch.ops import sparse

    got = sparse.csr_ip(idx, val, offs, q)
    want = sparse.csr_ip_ref(idx, val, offs, q)
    mag = sparse.csr_ip_ref(idx, val.abs(), offs, q.abs())
    torch.cuda.synchronize()
    assert got.shape == want.shape == (offs.numel() - 1,)
    assert bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-5 * mag).all())
    empty = offs[1:] == offs[:-1]
    assert bool((got[empty] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("variant,len_q,n_terms", [
    ("shared", 20_001, 30_522),   # stored ids past the scatter read its 0
    ("shared", 58_112, 50_000),   # the largest scatter shared memory holds
    ("l2", 58_113, 50_000),
    ("l2", 200_001, 250_000)])
def test_csr_ip_kernel_matches_plain_version(cuda_device, variant, len_q,
                                              n_terms):
    """Both scatter variants on a 50,000-row Zipf column (many passes of
    the persistent grid), rows of 0 and of more than 1,024 nnz, offsets not
    multiples of 4, a query scatter of len_q floats with a trailing 0."""
    from vectordb_tpu_torch.ops import sparse

    idx, val, offs = _zipf_csr(cuda_device, 50_000, n_terms, seed=21)
    g = torch.Generator(device=cuda_device).manual_seed(22)
    q = torch.rand(len_q, generator=g, device=cuda_device)
    q[-1] = 0
    q[torch.rand(len_q, generator=g, device=cuda_device) < 0.5] = 0
    sparse.reset_launches()
    _assert_csr_ip_close(idx, val, offs, q)
    assert sparse.launches == 1
    assert sparse.launches_by_variant == {variant: 1}


@pytest.mark.gpu
def test_csr_ip_kernel_on_small_and_empty_columns(cuda_device):
    """A column of one row, of rows without nnz (written as 0, the output
    comes from torch.empty), of a last vector of 1, 2 or 3 nnz, and of no
    rows at all (no launch)."""
    from vectordb_tpu_torch.ops import sparse

    dev = cuda_device
    q = torch.tensor([0.5, -1.0, 2.0, 0.0], device=dev)
    for n in (1, 2, 3, 5, 6, 7):
        idx = torch.arange(n, dtype=torch.int32, device=dev) % 5
        val = torch.ones(n, device=dev)
        offs = torch.tensor([0, 0, n // 2, n, n], dtype=torch.int64,
                            device=dev)
        _assert_csr_ip_close(idx, val, offs, q)
        _assert_csr_ip_close(idx, val, offs[[0, -1]].contiguous(), q)
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    sparse.reset_launches()
    out = sparse.csr_ip(none, none.float(), torch.zeros(
        4, dtype=torch.int64, device=dev), q)
    assert out.tolist() == [0.0, 0.0, 0.0] and sparse.launches == 1
    out = sparse.csr_ip(none, none.float(), torch.zeros(
        1, dtype=torch.int64, device=dev), q)
    assert out.shape == (0,) and sparse.launches == 1


@pytest.mark.gpu
def test_csr_ip_kernel_rejects_what_it_does_not_take(cuda_device):
    from vectordb_tpu_torch.ops import sparse

    dev = cuda_device
    idx = torch.zeros(9, dtype=torch.int32, device=dev)
    val = torch.ones(9, device=dev)
    offs = torch.tensor([0, 4, 8], dtype=torch.int64, device=dev)
    q = torch.ones(5, device=dev)
    with pytest.raises(TypeError):
        sparse.csr_ip(idx.long(), val, offs, q)
    with pytest.raises(TypeError):
        sparse.csr_ip(idx, val, offs.int(), q)
    with pytest.raises(ValueError):
        sparse.csr_ip(idx, val[:8], offs, q)
    with pytest.raises(ValueError):
        sparse.csr_ip(idx, val, offs, q.cpu())
    with pytest.raises(ValueError):
        sparse.csr_ip(idx, val, offs, torch.ones(10, device=dev)[::2])
    with pytest.raises(ValueError, match="16-byte aligned"):
        sparse.csr_ip(idx[1:], val[1:], offs, q)


@pytest.mark.gpu
def test_csr_ip_raises_when_the_operator_does_not_load(cuda_device,
                                                       monkeypatch,
                                                       tmp_path):
    """No fallback: on a CUDA index a library that does not load raises;
    the plain version does not run instead."""
    from vectordb_tpu_torch import _cuda_build
    from vectordb_tpu_torch.ops import sparse

    bad = tmp_path / "csr_ip_op-000000000000.so"
    bad.write_bytes(b"not a shared library")
    monkeypatch.setattr(sparse, "_op", None)
    monkeypatch.setattr(_cuda_build, "_registered", {})
    monkeypatch.setattr(_cuda_build, "library_path", lambda name: str(bad))
    z = torch.zeros(4, device=cuda_device)
    with pytest.raises(RuntimeError, match="did not load"):
        sparse.csr_ip(z.int(), z, torch.zeros(2, dtype=torch.int64,
                                               device=cuda_device), z)


@pytest.mark.gpu
def test_ivf_knn_on_the_card_matches_the_cpu_route(cuda_device):
    """ivf_knn over a bf16 table of 20,000 x 64 on the card and on the CPU:
    the same k-means, partition and probes up to f32 summation order, so
    the neighbour lists overlap by at least 0.98; every gather of the card
    run went through the kernel."""
    from vectordb_tpu_torch.ops import ivf

    n, dim, k = 20000, 64, 16
    rng = np.random.default_rng(8)
    centers = rng.normal(size=(200, dim)).astype(np.float32) * 3
    x = np.zeros((20480, dim), np.float32)
    x[:n] = centers[rng.integers(0, 200, n)] + rng.normal(size=(n, dim))
    tab = torch.from_numpy(x).to(torch.bfloat16)
    kw = dict(cluster_rows=1024, n_probe=8)
    gather.reset_launches()
    ids_g, d_g = ivf.ivf_knn(tab.to(cuda_device), n, k,
                             MetricType.EUCLIDEAN, **kw)
    assert gather.launches > 0
    ids_c, d_c = ivf.ivf_knn(tab, n, k, MetricType.EUCLIDEAN, **kw)
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(ids_g, ids_c))
    assert hits / (n * k) >= 0.98
    assert not (ids_g == np.arange(n)[:, None]).any()
    both = (ids_g == ids_c)
    np.testing.assert_allclose(d_g[both], d_c[both], rtol=1e-5, atol=1e-3)


@pytest.mark.gpu
def test_hybrid_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """The same table and hybrid queries (rrf and weighted, a filter) on the
    card and on the CPU: the same ids, fused scores within rtol 1e-5."""
    from vectordb_tpu_torch.ops import sparse

    rng = np.random.default_rng(9)
    n = 3000
    x = rng.normal(size=(n, 32)).astype(np.float32)
    rows = _sparse_rows(rng, n, 2000, 30)
    queries = []
    for r in rng.integers(0, n, 6):
        r += (r % 13 == 5)  # a row with terms
        queries.append([
            {"field": "D", "vector": (x[r] + 0.3 * rng.normal(size=32))
             .tolist(), "weight": 1.0},
            {"field": "S", "vector": {"indices": rows[r][0][:10].tolist(),
                                      "values": [1.0] * len(rows[r][0][:10])},
             "weight": 0.5}])
    out = {}
    for device in ("cuda", "cpu"):
        vdb._reset_for_tests()
        vdb.set_device(device)
        assert vdb.load_db("h", str(tmp_path / device)) == 0
        vdb.use_db("h")
        vdb.create_table("t", [
            {"name": "ID", "dataType": "INT", "primaryKey": True},
            {"name": "D", "dataType": "VECTOR_FLOAT", "dimensions": 32,
             "metricType": "EUCLIDEAN"},
            {"name": "S", "dataType": "SPARSE_VECTOR_FLOAT",
             "dimensions": 2000, "metricType": "DOT_PRODUCT"}])
        assert vdb.insert("t", [
            {"ID": i, "D": x[i].tolist(),
             "S": {"indices": rows[i][0].tolist(),
                   "values": rows[i][1].tolist()}} for i in range(n)]) == 0
        sparse.reset_launches()
        res = [vdb.hybrid_query("t", q, ["ID"], 10, flt, True,
                                rerank=rerank)[1]
               for q in queries for rerank in ("rrf", "weighted")
               for flt in ("", "ID < 1500")]
        if device == "cuda":  # the sparse scorer's kernel, once a query
            assert sparse.launches == len(res)
        out[device] = res
    for g, c in zip(out["cuda"], out["cpu"]):
        assert [r["ID"] for r in g] == [r["ID"] for r in c]
        np.testing.assert_allclose([r["@distance"] for r in g],
                                   [r["@distance"] for r in c],
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.gpu
def test_filtered_single_query_takes_the_flat_scan_as_on_the_cpu(
        cuda_device, tmp_path):
    """A single vdb.query under a device filter that keeps 1% of a graph
    table's rows (doc_id >= 5940 of a permutation of 0-5999) takes the
    exact masked flat scan on the card, counted in filter_route_flat_total,
    over the filter's kept rows (the id-scan kernel; flat_id_scans_total),
    and answers as the CPU route does, bit for bit: integer-valued rows and
    queries (every f32 score is exact in any order), and queries whose 11
    nearest kept rows lie at distinct distances, so no tie can order them
    differently."""
    from vectordb_tpu_torch.metrics import metrics

    rng = np.random.default_rng(41)
    n, dim = 6000, 64
    x = rng.integers(-8, 9, size=(n, dim)).astype(np.float32)
    doc_id = rng.permutation(n)
    keep = doc_id >= n - n // 100
    cand = rng.integers(-8, 9, size=(64, dim)).astype(np.float32)
    exact = ((cand[:, None, :] - x[None, keep, :]) ** 2).sum(-1)
    first = np.sort(exact, axis=1)[:, :11]
    queries = cand[(np.diff(first, axis=1) > 0).all(1)][:8]
    assert len(queries) == 8
    route = ("filter_route_flat_total", "filter_route_walk_total",
             "flat_id_scans_total")
    out = {}
    for device in ("cuda", "cpu"):
        vdb._reset_for_tests()
        vdb.set_device(device)
        assert vdb.update_config({"AutoTuneSearch": False,
                                  "FlatServe": "off"}) == 0
        assert vdb.load_db("f", str(tmp_path / device), vector_scale=n) == 0
        vdb.use_db("f")
        vdb.create_table("t", [
            {"name": "ID", "dataType": "INT", "primaryKey": True},
            {"name": "doc_id", "dataType": "INT"},
            {"name": "Emb", "dataType": "VECTOR_FLOAT", "dimensions": dim,
             "metricType": "EUCLIDEAN"}])
        code, _ = vdb.insert_columns("t", {"ID": np.arange(n),
                                           "doc_id": doc_id, "Emb": x})
        assert code == 0 and vdb.rebuild() == 0
        store = vdb._db.databases["f"].tables["t"].segment.device_view(
            "Emb")
        assert store.buf.device.type == device
        before = [metrics.snapshot()["counters"].get(c, 0.0) for c in route]
        res = []
        for q in queries:
            code, rows = vdb.query("t", "Emb", q.tolist(), ["ID"], 10,
                                   f"doc_id >= {n - n // 100}", True)
            assert code == 0 and len(rows) == 10
            res.append(([r["ID"] for r in rows],
                        np.array([r["@distance"] for r in rows])))
        after = [metrics.snapshot()["counters"].get(c, 0.0) for c in route]
        assert [a - b for a, b in zip(after, before)] == [len(queries), 0,
                                                          len(queries)]
        out[device] = res
    for (gi, gd), (ci, cd) in zip(out["cuda"], out["cpu"]):
        assert gi == ci and keep[gi].all()
        assert gd.tobytes() == cd.tobytes()
    for (_, gd), q in zip(out["cuda"], queries):
        row = np.sort(((q[None, :] - x[keep]) ** 2).sum(-1))[:10]
        np.testing.assert_array_equal(gd, row)


@pytest.mark.gpu
def test_labelled_single_query_walks_under_the_folded_mask_as_on_the_cpu(
        cuda_device, tmp_path):
    """A single vdb.query under a STRING label that half of a COSINE graph
    table's rows carry: the filter folds on the host, the gate sends it to
    the walk (host_fold_route_walk_total), and the card answers with the
    CPU route's ids, each row carrying the label, distances within
    1e-5."""
    from vectordb_tpu_torch.metrics import metrics

    n, dim = 6000, 64
    x, queries = _clustered_rows(n, dim, seed=43)
    queries = queries[:8]
    labels = np.where(np.random.default_rng(43).permutation(n) < n // 2,
                      "label_50p", "label_other").astype(object)
    route = ("host_fold_route_walk_total", "host_fold_route_flat_total")
    out = {}
    for device in ("cuda", "cpu"):
        vdb._reset_for_tests()
        vdb.set_device(device)
        assert vdb.update_config({"AutoTuneSearch": False,
                                  "FlatServe": "off"}) == 0
        assert vdb.load_db("l", str(tmp_path / device), vector_scale=n) == 0
        vdb.use_db("l")
        vdb.create_table("t", [
            {"name": "ID", "dataType": "INT", "primaryKey": True},
            {"name": "labels", "dataType": "STRING"},
            {"name": "Emb", "dataType": "VECTOR_FLOAT", "dimensions": dim,
             "metricType": "COSINE"}])
        code, _ = vdb.insert_columns("t", {"ID": np.arange(n),
                                           "labels": labels.tolist(),
                                           "Emb": x})
        assert code == 0 and vdb.rebuild() == 0
        store = vdb._db.databases["l"].tables["t"].segment.device_view("Emb")
        assert store.buf.device.type == device
        before = [metrics.snapshot()["counters"].get(c, 0.0) for c in route]
        res = []
        for q in queries:
            code, rows = vdb.query("t", "Emb", q.tolist(), ["ID"], 10,
                                   "labels = 'label_50p'", True)
            assert code == 0 and len(rows) == 10
            res.append(([r["ID"] for r in rows],
                        np.array([r["@distance"] for r in rows])))
        after = [metrics.snapshot()["counters"].get(c, 0.0) for c in route]
        assert [a - b for a, b in zip(after, before)] == [len(queries), 0]
        out[device] = res
    for (gi, gd), (ci, cd) in zip(out["cuda"], out["cpu"]):
        assert gi == ci and (labels[gi] == "label_50p").all()
        np.testing.assert_allclose(gd, cd, rtol=0, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _id_scan_rows(d: int, dtype_name: str):
    """12,000 integer-valued rows of d columns (bf16-exact) in the named
    dtype, on the CPU, and their f32 squared norms."""
    x = np.random.default_rng(d).integers(-8, 9, size=(12000, d))
    tab = torch.from_numpy(x.astype(np.float32)).to(getattr(torch,
                                                            dtype_name))
    return tab, (tab.float() ** 2).sum(1)


def _id_scan_case(dev, d, m, b, dtype_name="bfloat16"):
    tab, norms = _id_scan_rows(d, dtype_name)
    rng = np.random.default_rng(d * 7 + m + b)
    ids = torch.from_numpy(np.sort(rng.choice(tab.shape[0], m, replace=False)
                                   ).astype(np.int32))
    q = torch.from_numpy(rng.integers(-8, 9, size=(b, d)).astype(np.float32))
    return [t.to(dev) for t in (q, tab, norms, ids)], (q, tab, norms, ids)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d,m,b,dtype_name", [
    *[(d, m, b, "bfloat16") for d in (64, 128, 768, 1536)
      for m in (1, 33, 10023) for b in (1, 3)],
    (512, 33, 3, "bfloat16"), (1024, 1000, 3, "bfloat16"),
    (1280, 33, 1, "bfloat16"), (2048, 100, 3, "bfloat16"),
    (768, 10023, 20, "bfloat16"),    # two query tiles along grid.y
    (4096, 1000, 3, "bfloat16"),     # two row segments, two query tiles
    (64, 33, 3, "float32"), (768, 10023, 1, "float32"),
    (2048, 500, 3, "float32")])      # f32: two row segments
def test_id_scan_kernel_matches_plain_version_bit_for_bit(
        cuda_device, metric, d, m, b, dtype_name):
    """The id-scan kernel against its plain version run on the CPU, on
    integer-valued bf16-exact rows and queries: every f32 sum is exact in
    any order, so the two agree bit for bit. One launch a call."""
    (q, tab, norms, ids), cpu = _id_scan_case(cuda_device, d, m, b,
                                              dtype_name)
    before = id_scan.launches
    got = id_scan.id_scan(q, tab, norms, ids, int(metric))
    torch.cuda.synchronize()
    assert id_scan.launches == before + 1
    want = id_scan.id_scan_ref(*cpu, int(metric))
    assert got.shape == (b, m)
    assert got.cpu().numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.gpu
def test_id_scan_rounds_queries_to_the_table_dtype(cuda_device):
    """Queries that bf16 rounds (and ties to even) score as their bf16
    values, as in flat_topk; the f32 table keeps them."""
    (q, tab, norms, ids), cpu = _id_scan_case(cuda_device, 128, 33, 3)
    frac = torch.tensor([1 + 2 ** -9, 1 + 3 * 2 ** -9, 1 - 2 ** -10,
                         0.1], device=cuda_device)
    q = q * frac.repeat(32)[None, :]
    for table in (tab, tab.float()):
        got = id_scan.id_scan(q, table, norms, ids, int(MetricType.COSINE))
        want = id_scan.id_scan_ref(q.cpu(), table.cpu(), norms.cpu(),
                                   ids.cpu(), int(MetricType.COSINE))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-3)
        full = flat.flat_distances(q, table, None, MetricType.COSINE)
        torch.testing.assert_close(got, full[:, ids.long()], rtol=1e-6,
                                   atol=1e-3)


@pytest.mark.gpu
def test_id_scan_kernel_rejects_what_it_does_not_take(cuda_device):
    (q, tab, norms, ids), _ = _id_scan_case(cuda_device, 64, 33, 3)
    l2 = int(MetricType.EUCLIDEAN)
    before = id_scan.launches
    for args, err in [
            ((q, tab.half(), norms, ids, l2), TypeError),
            ((q.double(), tab, norms, ids, l2), TypeError),
            ((q, tab, norms, ids.long(), l2), TypeError),
            ((q, tab, norms, ids.cpu(), l2), ValueError),
            ((q.cpu(), tab, norms, ids, l2), ValueError),
            ((q[:, :56].contiguous(), tab, norms, ids, l2), ValueError),
            ((q, tab[:, :60], norms, ids, l2), ValueError),
            ((q, tab, None, ids, l2), ValueError),
            ((q, tab.view(-1)[4:4 + 11999 * 64].view(11999, 64),
              norms[:11999], ids, l2), ValueError)]:  # 8 bytes off
        with pytest.raises(err):
            id_scan.id_scan(*args)
    assert id_scan.launches == before


def _sharded_run(device_list, tmp_path, x, queries, probe):
    """A ShardCount table over `device_list` (one shard each): launch counts
    of its build and of its grouped queries, flat single-query ids before
    the build, grouped ids and distances after it."""
    from vectordb_tpu_torch.parallel import make_mesh, set_engine_mesh

    vdb._reset_for_tests()
    vdb.set_device(device_list[0].split(":")[0])
    set_engine_mesh(make_mesh(device_list))
    assert vdb.update_config({"ShardCount": len(device_list),
                              "AutoTuneSearch": False,
                              "QueryGroupSize": 2}) == 0
    name = device_list[0].replace(":", "")
    assert vdb.load_db(name, str(tmp_path / name),
                       vector_scale=len(x)) == 0
    vdb.use_db(name)
    vdb.create_table("t", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "Emb", "dataType": "VECTOR_FLOAT", "dimensions": x.shape[1],
         "metricType": "EUCLIDEAN"}])
    vdb.insert_columns("t", {"ID": np.arange(len(x)), "Emb": x})
    table = vdb._db.databases[name].tables["t"]
    flat = [[r["ID"] for r in vdb.query("t", "Emb", x[i].tolist(), ["ID"],
                                        10)[1]] for i in probe]
    partial_min.reset_launches()
    gather.reset_launches()
    assert vdb.rebuild() == 0
    build = (partial_min.launches, gather.launches)
    gather.reset_launches()
    ids, d = table.grouped_dense_search(
        "Emb", queries, table.segment.valid_mask(), MetricType.EUCLIDEAN, 10,
        batch=256)
    out = {"flat": flat, "build": build, "query_gathers": gather.launches,
           "ids": ids, "d": d, "shards": table.mesh.size,
           "devices": {str(b.device) for b in
                       table.sharded_fields["Emb"].store.buf}}
    vdb.unload_db(name)
    return out


def _clustered_rows(n, dim, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(300, dim)).astype(np.float32) * 2
    x = (centers[rng.integers(0, 300, n)]
         + rng.normal(size=(n, dim)).astype(np.float32))
    queries = x[rng.integers(0, n, 600)] + 0.1 * rng.normal(
        size=(600, dim)).astype(np.float32)
    return x, queries


@pytest.mark.gpu
def test_sharded_table_on_one_card_matches_cpu_shards(cuda_device, tmp_path):
    """4 shards on cuda:0 against the same table on 4 CPU shards of the
    port: the card's build launches partial-min (each shard's 8,192-slot
    exact KNN) and the gather (pruning), its queries the gather; the same
    flat ids, and the same grouped ids on 99% of queries (the two builds
    may break KNN near-ties apart), recall and exact distances."""
    n, dim = 30000, 128
    x, queries = _clustered_rows(n, dim, seed=21)
    probe = [0, 7, 12345, n - 1]
    card = _sharded_run(["cuda:0"] * 4, tmp_path, x, queries, probe)
    cpu = _sharded_run(["cpu"] * 4, tmp_path, x, queries, probe)
    assert card["shards"] == 4 and card["devices"] == {"cuda:0"}
    assert card["build"][0] > 0 and card["build"][1] > 0
    assert card["query_gathers"] > 0
    assert cpu["build"] == (0, 0)
    assert card["flat"] == cpu["flat"]
    same = np.mean([set(a) == set(b)
                    for a, b in zip(card["ids"], cpu["ids"])])
    assert same >= 0.99, same
    hits = 0
    for i in range(0, len(queries), 6):
        dd = ((x - queries[i]) ** 2).sum(1)
        hits += len(set(card["ids"][i].tolist())
                    & set(np.argsort(dd)[:10].tolist()))
        np.testing.assert_allclose(card["d"][i], dd[card["ids"][i]],
                                   rtol=1e-5)
    assert hits / (10 * len(range(0, len(queries), 6))) >= 0.99


@pytest.mark.gpu
def test_sharded_table_over_two_cards(cuda_device, tmp_path):
    """One shard a card: the merge copies the second card's candidates to
    the first (needs two cards; skips on one)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    n, dim = 20000, 128
    x, queries = _clustered_rows(n, dim, seed=22)
    two = _sharded_run(["cuda:0", "cuda:1"], tmp_path, x, queries, [3, 99])
    one = _sharded_run(["cuda:0"] * 2, tmp_path, x, queries, [3, 99])
    assert two["devices"] == {"cuda:0", "cuda:1"}
    assert two["flat"] == one["flat"]
    np.testing.assert_array_equal(two["ids"], one["ids"])


def _walk_case(seed, n, d, r, b, L, metric, fused, max_iters, tw=0,
               n_seed=8):
    """A random graph of n integer-valued rows (values in [-3, 3], exact in
    bf16 and int8) with 10% padding edges and a fifth of the rows repeating
    an edge, b integer-valued queries, each query's beam seeded with n_seed
    random rows at their exact distances, ascending (stable), then -1 /
    inf. Returns the keyword arguments of beam.traverse on the CPU."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    q = rng.integers(-3, 4, size=(b, d)).astype(np.float32)
    adj = rng.integers(0, n, size=(n, r)).astype(np.int32)
    adj[rng.random((n, r)) < 0.1] = -1
    rep = rng.random(n) < 0.2
    adj[rep, 1] = adj[rep, 0]
    ip = q @ x.T
    dist = ((q * q).sum(1)[:, None] - 2 * ip + (x * x).sum(1)[None]
            if metric == MetricType.EUCLIDEAN
            else 1.0 - ip if metric == MetricType.COSINE else -ip)
    ids = np.full((b, L), -1, np.int32)
    dd = np.full((b, L), np.inf, np.float32)
    for i in range(b):
        s = rng.choice(n, min(n_seed, L), replace=False)
        order = np.argsort(dist[i, s], kind="stable")
        ids[i, :len(s)] = s[order]
        dd[i, :len(s)] = dist[i, s[order]]
    m = 4
    kw = dict(q=torch.from_numpy(q).bfloat16(),
              q_norms=torch.from_numpy((q * q).sum(1)),
              table=torch.from_numpy(x).bfloat16(),
              adjacency=torch.from_numpy(adj), fused=None, scale=None,
              beam_ids=torch.from_numpy(ids), beam_exp=torch.zeros(
                  (b, L), dtype=torch.bool), beam_d=torch.from_numpy(dd),
              visited=torch.full((b, m * max_iters), -1, dtype=torch.int32),
              metric=int(metric), expand=m, max_iters=max_iters,
              term_width=tw, compact=0 if fused else 96)
    if fused:
        f = x[np.clip(adj, 0, n - 1)].astype(np.int8).reshape(n, r * d)
        kw.update(fused=torch.from_numpy(f), scale=float(np.float32(0.375)))
    return kw


def _plans(kw, dev):
    """Every (variant, mode) the kernel can walk kw's batch in on dev."""
    b, L = kw["beam_ids"].shape
    return beam.walk_plans(b, L, kw["expand"], kw["adjacency"].shape[1],
                           kw["q"].shape[1], kw["table"].dtype,
                           kw["fused"] is not None, kw["visited"].shape[1],
                           dev)


def _walk_both(kw, dev, plans=None):
    """beam.traverse from the same state: the plain version on the CPU (in
    place on kw), the kernel on `dev` in every plan of `plans` (default:
    all the kernel can run, _plans). Asserts each state equal bit for bit;
    returns the CPU state and {plan: the kernel's launches}."""
    start = {k: v.to(dev, copy=True) if isinstance(v, torch.Tensor) else v
             for k, v in kw.items()}
    beam.traverse(**kw)
    launched = {}
    for plan in plans or _plans(kw, dev):
        on_dev = {k: v.clone() if isinstance(v, torch.Tensor) else v
                  for k, v in start.items()}
        before = beam.launches
        beam.traverse(**on_dev, plan=plan)
        torch.cuda.synchronize()
        launched[plan] = beam.launches - before
        for name in ("beam_ids", "beam_exp", "visited"):
            assert torch.equal(on_dev[name].cpu(), kw[name]), (plan, name)
        assert torch.equal(on_dev["beam_d"].cpu().view(torch.int32),
                           kw["beam_d"].view(torch.int32)), plan
    return kw, launched


def _launches_ok(launched, iters, walked_iters=None):
    """A walk launches once; a walk an iteration at a time at most once an
    iteration and, to `walked_iters` iterations, at least that often."""
    for plan, n in launched.items():
        if plan.mode == "walk":
            assert n == 1, (plan, n)
        else:
            assert n <= iters and n >= (walked_iters or 1), (plan, n)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("path", ["split96", "split0", "fused"])
def test_beam_kernel_equals_plain_version(cuda_device, metric, path):
    """A batch of 64 walks, L 64, R 48, up to 16 iterations (split96 peels
    iteration 0), in every variant and mode."""
    kw = _walk_case(1, 4096, 128, 48, 64, 64, metric, path == "fused", 16)
    if path == "split0":
        kw["compact"] = 0
    state, launched = _walk_both(kw, cuda_device)
    assert {p.variant for p in launched} == {"warp", "block"}
    assert {p.mode for p in launched} == {"walk", "iteration"}
    _launches_ok(launched, 16, 16)
    assert int((state["visited"] >= 0).sum()) > 64 * 16


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_beam_kernel_full_batch(cuda_device, fused):
    """2,048 walks, the grouped shape: many blocks a multiprocessor, so a
    missing barrier between a block's phases shows."""
    kw = _walk_case(6, 4096, 128, 48, 2048, 64, MetricType.EUCLIDEAN, fused,
                    16)
    _, launched = _walk_both(kw, cuda_device)
    _launches_ok(launched, 16, 16)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 7, 2048])
@pytest.mark.parametrize("fused", [False, True])
def test_beam_kernel_main_path_walk(cuda_device, b, fused):
    """The 1M graph's tuned walk: L 18, 4 iterations, tw 12, 18 seeds; one
    query, 7 (not a multiple of the warp variant's 4 queries a block) and
    2,048; each walks it in one launch, 2,048 in the warp variant."""
    kw = _walk_case(9, 4096, 128, 48, b, 18, MetricType.EUCLIDEAN, fused, 4,
                    tw=12, n_seed=18)
    plan = beam._plan(b, 18, 4, 48, 128, torch.bfloat16, fused, 16,
                      cuda_device)
    sms = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    assert plan == beam.WalkPlan("warp" if b > sms else "block", "walk")
    _, launched = _walk_both(kw, cuda_device)
    assert launched[plan] == 1
    _launches_ok(launched, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [64, 65])
@pytest.mark.parametrize("metric", METRICS)
def test_beam_kernel_at_the_warp_variants_limit(cuda_device, L, metric):
    """L 64, the widest beam the warp variant takes, and 65, which only
    the block variant takes; 7 queries, 20 iterations, fused."""
    kw = _walk_case(10, 3000, 64, 48, 7, L, metric, True, 20)
    _, launched = _walk_both(kw, cuda_device)
    want = {"warp", "block"} if L == 64 else {"block"}
    assert {p.variant for p in launched} == want
    _launches_ok(launched, 20)


@pytest.mark.gpu
def test_beam_kernel_batch_too_large_to_walk_in_one_launch(cuda_device):
    """One query more than the card holds at once in the warp variant: the
    plan launches an iteration at a time, and a forced walk in one
    (cooperative) launch is refused with its CUDA error, never run on the
    plain version."""
    resident = beam.resident_per_sm(cuda_device, "warp", torch.bfloat16,
                                    False, 18, 32, 4, 16, 20)
    sms = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    b = resident * sms + 1
    kw = _walk_case(11, 2000, 32, 16, b, 18, MetricType.EUCLIDEAN, False, 5,
                    tw=12, n_seed=18)
    plan = beam._plan(b, 18, 4, 16, 32, torch.bfloat16, False, 20,
                      cuda_device)
    assert plan == beam.WalkPlan("warp", "iteration")
    _walk_both(kw, cuda_device, [plan])
    on_dev = {k: v.to(cuda_device, copy=True) if isinstance(v, torch.Tensor)
              else v for k, v in kw.items()}
    with pytest.raises(RuntimeError, match="CUDA error"):
        beam.traverse(**on_dev, plan=beam.WalkPlan("warp", "walk"))


@pytest.mark.gpu
@pytest.mark.parametrize("L,r,b,fused", [(16, 16, 32, False),
                                         (16, 48, 32, True),
                                         (100, 16, 16, True),
                                         (100, 48, 16, False),
                                         (1024, 48, 2, False),
                                         (1024, 16, 2, True)])
def test_beam_kernel_widths_and_deep_walks(cuda_device, L, r, b, fused):
    """Beams of 16 to 1,024 entries walked to full depth (max_iters = L,
    past UNROLL_MAX_ITERS: one launch, or the host asking the device flag
    every few launches), R 16 and 48; rows that fell off a short beam come
    back as candidates."""
    kw = _walk_case(2, 3000, 32, r, b, L, MetricType.EUCLIDEAN, fused, L)
    state, launched = _walk_both(kw, cuda_device)
    walked = int((state["visited"][0] >= 0).sum())
    assert walked > L // 4
    _launches_ok(launched, L, walked // 4)


@pytest.mark.gpu
@pytest.mark.parametrize("fused,cp", [(False, 1), (True, 0)])
def test_beam_kernel_beam_past_48kb_of_shared_memory(cuda_device, fused,
                                                      cp):
    """L 3,000 (a widened beam under a selective filter): the block's
    shared memory passes 48 KB, so the launch raises the kernel's limit;
    split with cp 1, and fused."""
    kw = _walk_case(7, 4000, 32, 48, 3, 3000, MetricType.COSINE, fused, 40,
                    n_seed=3000)
    kw["compact"] = cp
    state, launched = _walk_both(kw, cuda_device)
    _launches_ok(launched, 40, 10)
    assert int((state["visited"] >= 0).sum()) > 3 * 40


@pytest.mark.gpu
@pytest.mark.parametrize("fused,b,iters", [(False, 3, 24), (True, 3, 24),
                                           (False, 1, 23), (True, 1, 24)])
def test_beam_kernel_beam_past_the_shared_memory_limit(cuda_device, fused,
                                                       b, iters):
    """L 16,000 (SearchEf 1,000 under the filter boost of 16): the double-
    buffered beam passes the card's 227 KB of shared memory a block, so it
    stays in global memory with a scratch copy; a batch in one cooperative
    launch and a launch an iteration, one query in one launch (an odd and
    an even count of merges, so the last lands in either buffer)."""
    kw = _walk_case(8, 20000, 32, 48, b, 16000, MetricType.EUCLIDEAN, fused,
                    iters, n_seed=12000)
    state, launched = _walk_both(kw, cuda_device)
    assert {p.variant for p in launched} == {"block"}
    assert len(launched) == (1 if b == 1 else 2)
    _launches_ok(launched, iters, iters)
    assert int((state["visited"] >= 0).sum()) == b * 4 * iters
@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3])
def test_graph_query_with_a_beam_past_the_shared_memory_limit(
        cuda_device, tmp_path, b):
    """A graph table on the card searched at ef 1,000 with the filter boost
    of 16 (a 16,000-entry beam, held in global memory): the kernel serves
    it, the answer is the exact top 10."""
    n, dim = 6000, 128
    x, queries = _clustered_rows(n, dim, seed=23)
    assert vdb.load_db("w", str(tmp_path / "w"), vector_scale=n) == 0
    vdb.use_db("w")
    vdb.create_table("t", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "Emb", "dataType": "VECTOR_FLOAT", "dimensions": dim,
         "metricType": "EUCLIDEAN"}])
    vdb.insert_columns("t", {"ID": np.arange(n), "Emb": x})
    assert vdb.update_config({"FlatServe": "off"}) == 0
    assert vdb.rebuild() == 0
    table = vdb._db.databases["w"].tables["t"]
    beam.reset_launches()
    ids, d = table.batch_dense_search(
        "Emb", queries[:b], table.segment.valid_mask(), MetricType.EUCLIDEAN,
        10, ef=1000, boost=16)
    assert beam.launches > 0
    for i in range(b):
        dd = ((x - queries[i]) ** 2).sum(1)
        assert set(ids[i].tolist()) == set(np.argsort(dd)[:10].tolist())
        np.testing.assert_allclose(d[i], dd[ids[i]], rtol=1e-5)


@pytest.mark.gpu
def test_beam_kernel_batch_where_queries_converge_apart(cuda_device):
    """A batch whose queries stop at different depths alone (tw 6): the
    batch walks until its last query stops, as JAX's `cond`."""
    kw = _walk_case(3, 2000, 64, 48, 24, 32, MetricType.DOT_PRODUCT, False,
                    16, tw=6)
    alone = []
    for i in range(24):
        one = {k: (v[i:i + 1].clone() if isinstance(v, torch.Tensor)
                   and v.dim() >= 1 and v.shape[0] == 24 else v)
               for k, v in kw.items()}
        beam.traverse(**one)
        alone.append(int((one["visited"] >= 0).sum()))
    assert len(set(alone)) > 1, alone
    state, _ = _walk_both(kw, cuda_device)
    walked = (state["visited"] >= 0).sum(1).tolist()
    assert all(w >= a for w, a in zip(walked, alone))
    assert walked[int(np.argmax(alone))] == max(alone)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("fused,L", [(False, 64), (True, 64),
                                     (False, 1024)])
def test_beam_kernel_single_query_walks_in_one_launch(cuda_device, metric,
                                                      fused, L):
    kw = _walk_case(4, 3000, 32, 48, 1, L, metric, fused, L)
    state, launched = _walk_both(kw, cuda_device)
    assert set(launched.values()) == {1}
    assert {p.variant for p in launched} == (
        {"warp", "block"} if L <= beam.WARP_MAX_L else {"block"})
    assert int((state["visited"] >= 0).sum()) > 4


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("fused", [False, True])
def test_beam_kernel_wide_cosine_rows(cuda_device, b, fused):
    """Rows of 1,536 columns, COSINE: 192 16-byte chunks a bf16 row (96 a
    fused int8 slice), past the 32 of a lane group, so each lane scores the
    rest of its chunks in turn; only the block variant takes them."""
    kw = _walk_case(12, 2048, 1536, 48, b, 64, MetricType.COSINE, fused, 16)
    state, launched = _walk_both(kw, cuda_device)
    assert {p.variant for p in launched} == {"block"}
    assert {p.mode for p in launched} == (
        {"walk"} if b == 1 else {"walk", "iteration"})
    _launches_ok(launched, 16)
    assert int((state["visited"] >= 0).sum()) > 4 * b


@pytest.mark.gpu
def test_beam_kernel_rejects_what_it_does_not_take(cuda_device):
    kw = _walk_case(5, 500, 32, 16, 4, 16, MetricType.EUCLIDEAN, False, 4)
    kw = {k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v
          for k, v in kw.items()}
    flags = torch.zeros(5, dtype=torch.int32, device=cuda_device)
    args = [kw[k] for k in ("q", "q_norms", "table", "adjacency", "fused",
                            "scale", "beam_ids", "beam_exp", "beam_d",
                            "visited")]
    call = lambda *a, **over: beam.beam_iter(
        *a, flags, over.get("expand", 4), 0, over.get("it_begin", 0),
        over.get("it_end", 1), 96, 16, False, over.get("variant", "block"))
    with pytest.raises(TypeError):
        call(args[0].float(), *args[1:])
    with pytest.raises(ValueError):
        call(*args, variant="thread")  # no such kernel
    wide = [*args[:6], *(torch.cat([t] * 5, dim=1) for t in args[6:9]),
            args[9]]
    with pytest.raises(ValueError):
        call(*wide, variant="warp")  # L 80 past the warp variant's 64
    with pytest.raises(ValueError):
        call(*args, it_begin=4, it_end=5)  # past visited
    with pytest.raises(ValueError):
        call(args[0][:, :24].contiguous(), args[1],
             args[2][:, :24].contiguous(), *args[3:])  # rows of 24
    with pytest.raises(ValueError):
        call(*args, expand=17)  # more picks than the beam holds


# A graph query's device chain replayed from a captured CUDA graph
# (ops/beam.ReplayCache): the replay must equal the eager chain bit for
# bit, since the same kernels run in the same order on the same data.

REPLAY_COUNTERS = ("cuda_graph_replays_total", "cuda_graph_captures_total",
                   "cuda_graph_eager_total")


def _replay_counts():
    from vectordb_tpu_torch.metrics import metrics
    c = metrics.snapshot()["counters"]
    return np.array([int(c.get(k, 0)) for k in REPLAY_COUNTERS])


def _replay_table(tmp_path, metric=MetricType.EUCLIDEAN, fused="auto",
                  n=6000, dim=128):
    """A graph table on the card with an INT column `cat` (row % 4);
    (table, rows, queries)."""
    x, queries = _clustered_rows(n, dim, seed=31)
    assert vdb.load_db("rp", str(tmp_path / "rp"), vector_scale=2 * n) == 0
    vdb.use_db("rp")
    vdb.create_table("t", [
        {"name": "ID", "dataType": "INT", "primaryKey": True},
        {"name": "Emb", "dataType": "VECTOR_FLOAT", "dimensions": dim,
         "metricType": metric.name},
        {"name": "cat", "dataType": "INT"}])
    vdb.insert_columns("t", {"ID": np.arange(n), "Emb": x,
                             "cat": (np.arange(n) % 4).astype(np.int32)})
    assert vdb.update_config({"FlatServe": "off", "FusedTraversal": fused,
                              "AutoTuneSearch": False}) == 0
    assert vdb.rebuild() == 0
    return vdb._db.databases["rp"].tables["t"], x, queries


def _dev_out(table, q, **kw):
    """The graph branch's device answer (d, ids) to host queries q, as
    fetch_dense_search hands it to the re-rank."""
    h = table.dispatch_dense_search("Emb", q, table.segment.valid_mask(),
                                    table.metric_map["Emb"], 10,
                                    mask_cacheable=True, **kw)
    assert h["mode"] == "graph"
    return table.fetch_dense_search(h)["dev_host"]


def _eager(monkeypatch, fn):
    """fn() with every chain run eager."""
    with monkeypatch.context() as m:
        m.setattr(beam, "_capturable", lambda table, plan, it: False)
        return fn()


def _assert_bits(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.gpu
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("fused", ["auto", "off"])
def test_replayed_query_equals_eager(cuda_device, tmp_path, monkeypatch,
                                     metric, fused):
    """Single queries: the first runs eager, the second is captured and
    replayed, the rest replay the same chain with their own query; every
    answer equals the eager chain's, and a replay launches the beam and
    gather kernels."""
    table, _, qs = _replay_table(tmp_path, metric, fused)
    assert (table._fused_view(table.graphs["Emb"])[0] is not None) == (
        fused == "auto")
    want = _eager(monkeypatch, lambda: [_dev_out(table, qs[i:i + 1])
                                        for i in range(6)])
    before = _replay_counts()
    got = [_dev_out(table, qs[i:i + 1]) for i in range(5)]
    beam.reset_launches()
    gather.reset_launches()
    got.append(_dev_out(table, qs[5:6]))
    assert beam.launches == 1 and gather.launches > 0
    assert (_replay_counts() - before).tolist() == [5, 1, 1]
    for a, b in zip(got, want):
        _assert_bits(a, b)
    assert len(table._replays) == 1


def _walk_counts():
    from vectordb_tpu_torch.metrics import metrics
    c = metrics.snapshot()["counters"]
    return np.array([int(c.get(k, 0)) for k in ("beam_walks_split_total",
                                                 "beam_walks_fused_total")])


@pytest.mark.gpu
@pytest.mark.parametrize("fused", ["auto", "off"])
def test_replayed_wide_cosine_query_equals_eager(cuda_device, tmp_path,
                                                 monkeypatch, fused):
    """Rows of 1,536 columns, COSINE: the replayed chain equals the eager
    one bit for bit on the split path and on the fused one, and every walk
    counts on the path it took."""
    table, _, qs = _replay_table(tmp_path, MetricType.COSINE, fused,
                                 dim=1536)
    split = table._fused_view(table.graphs["Emb"])[0] is None
    assert split == (fused == "off")
    want = _eager(monkeypatch, lambda: [_dev_out(table, qs[i:i + 1])
                                        for i in range(4)])
    before, walks = _replay_counts(), _walk_counts()
    got = [_dev_out(table, qs[i:i + 1]) for i in range(4)]
    assert (_replay_counts() - before).tolist() == [3, 1, 1]
    assert (_walk_counts() - walks).tolist() == ([4, 0] if split
                                                 else [0, 4])
    for a, b in zip(got, want):
        _assert_bits(a, b)


@pytest.mark.gpu
def test_replay_after_a_delete(cuda_device, tmp_path, monkeypatch):
    """A delete makes a new mask version: the chain is dropped, the key
    runs eager once, is captured again, and no deleted row comes back."""
    table, _, qs = _replay_table(tmp_path)
    q = qs[:1]
    for _ in range(3):
        _, ids = _dev_out(table, q)
    victims = [int(i) for i in ids[0, :3]]
    assert vdb.delete_by_pk("t", victims) == 0
    want = _eager(monkeypatch, lambda: _dev_out(table, q))
    before = _replay_counts()
    got = [_dev_out(table, q) for _ in range(3)]
    assert (_replay_counts() - before).tolist() == [2, 1, 1]
    for g in got:
        _assert_bits(g, want)
        assert not set(victims) & set(g[1][0].tolist())


@pytest.mark.gpu
def test_replays_read_one_mask_per_version(cuda_device, tmp_path):
    """Single queries through vdb.query at one version: every one replays,
    reads the same device mask tensor and reuses the host mask, which is
    never rebuilt. After a delete the chain is dropped, and the eager,
    captured and replayed answers all leave the deleted rows out."""
    from vectordb_tpu_torch.metrics import metrics
    table, _, qs = _replay_table(tmp_path)

    def run(i):
        code, rows = vdb.query("t", "Emb", qs[i].tolist(), ["ID"], 10)
        assert code == 0 and len(rows) == 10
        return [r["ID"] for r in rows]

    def mask_counts():
        c = metrics.snapshot()["counters"]
        return np.array([int(c.get(k, 0)) for k in (
            "valid_mask_builds_total", "valid_mask_reuses_total")])

    for _ in range(3):
        run(0)
    device_masks = {k: v[1] for k, v in table._mask_cache.items()}
    before, masks = _replay_counts(), mask_counts()
    for i in range(8):
        run(i)
    assert (_replay_counts() - before).tolist() == [8, 0, 0]
    assert (mask_counts() - masks).tolist() == [0, 8]
    assert table._mask_cache.keys() == device_masks.keys()
    assert all(table._mask_cache[k][1] is t for k, t in device_masks.items())
    victims = run(0)[:3]
    assert vdb.delete_by_pk("t", victims) == 0
    before = _replay_counts()
    for _ in range(3):
        assert not set(victims) & set(run(0))
    assert (_replay_counts() - before).tolist() == [2, 1, 1]


@pytest.mark.gpu
def test_replay_with_rows_inserted_past_the_graph(cuda_device, tmp_path,
                                                  monkeypatch):
    """Rows inserted after the build: the replayed walk merges with the
    flat tail, and the inserted copy of the query ranks first."""
    table, x, qs = _replay_table(tmp_path)
    n = x.shape[0]
    new = qs[100:150].copy()
    vdb.insert_columns("t", {"ID": np.arange(n, n + 50), "Emb": new,
                             "cat": np.zeros(50, np.int32)})
    q = new[7:8]
    search = lambda: table.batch_dense_search(
        "Emb", q, table.segment.valid_mask(), MetricType.EUCLIDEAN, 10,
        mask_cacheable=True)
    want = _eager(monkeypatch, search)
    assert want[0][0, 0] == n + 7
    before = _replay_counts()
    for _ in range(3):
        ids, d = search()
        np.testing.assert_array_equal(ids, want[0])
        assert d.tobytes() == want[1].tobytes()
    assert (_replay_counts() - before).tolist() == [2, 1, 1]


@pytest.mark.gpu
def test_rebuild_drops_the_chains(cuda_device, tmp_path, monkeypatch):
    table, x, qs = _replay_table(tmp_path)
    q = qs[:1]
    for _ in range(3):
        _dev_out(table, q)
    assert len(table._replays) == 1
    n = x.shape[0]
    vdb.insert_columns("t", {"ID": np.arange(n, n + 100), "Emb": qs[:100],
                             "cat": np.zeros(100, np.int32)})
    assert vdb.rebuild() == 0
    assert len(table._replays) == 0
    want = _eager(monkeypatch, lambda: _dev_out(table, q))
    before = _replay_counts()
    for _ in range(3):
        _assert_bits(_dev_out(table, q), want)
    assert (_replay_counts() - before).tolist() == [2, 1, 1]


@pytest.mark.gpu
def test_replay_under_a_repeated_device_filter(cuda_device, tmp_path,
                                               monkeypatch):
    """A device-compilable filter keeps its composed mask per version, so
    its widened walk is captured and replayed like an unfiltered one."""
    table, _, qs = _replay_table(tmp_path)
    flt = "cat = 1"
    nodes = parse_expr(flt, table.field_type_map)
    ctx = table._device_filter(nodes,
                               FilterCompiler(nodes, table.segment.column))
    assert ctx is not None
    run = lambda i: _dev_out(table, qs[i:i + 1], filter_ctx=ctx)
    want = _eager(monkeypatch, lambda: [run(i) for i in range(4)])
    before = _replay_counts()
    got = [run(i) for i in range(4)]
    assert (_replay_counts() - before).tolist() == [3, 1, 1]
    for a, b in zip(got, want):
        _assert_bits(a, b)
        ids = a[1][0]
        assert (ids[ids >= 0] % 4 == 1).all()


@pytest.mark.gpu
def test_replay_of_a_batch_with_two_in_flight(cuda_device, tmp_path,
                                              monkeypatch):
    """A batch of 3 (a cooperative walk) and, while its replay is
    unfetched, a second batch of its key, which runs eager; then the
    pipelined batches of grouped_dense_search; then a replay dropped
    unfetched, which the next replay of the chain waits for."""
    table, _, qs = _replay_table(tmp_path)
    metric = MetricType.EUCLIDEAN
    valid = table.segment.valid_mask()
    dispatch = lambda q: table.dispatch_dense_search(
        "Emb", q, valid, metric, 10, mask_cacheable=True)
    want = _eager(monkeypatch, lambda: [_dev_out(table, qs[s:s + 3])
                                        for s in (0, 3)])
    before = _replay_counts()
    for _ in range(2):
        _assert_bits(_dev_out(table, qs[:3]), want[0])
    h1, h2 = dispatch(qs[:3]), dispatch(qs[3:6])
    assert isinstance(h1["dev"], beam.Replayed)
    assert not isinstance(h2["dev"], beam.Replayed)
    _assert_bits(table.fetch_dense_search(h2)["dev_host"], want[1])
    _assert_bits(table.fetch_dense_search(h1)["dev_host"], want[0])
    assert (_replay_counts() - before).tolist() == [2, 1, 2]
    assert vdb.update_config({"QueryGroupSize": 1}) == 0
    grouped = lambda: table.grouped_dense_search("Emb", qs[:12], valid,
                                                 metric, 10, batch=3,
                                                 mask_cacheable=True)
    ids_e, d_e = _eager(monkeypatch, grouped)
    before = _replay_counts()
    ids, d = grouped()
    np.testing.assert_array_equal(ids, ids_e)
    assert d.tobytes() == d_e.tobytes()
    assert (_replay_counts() - before).tolist() == [4, 0, 0]
    h = dispatch(qs[:3])  # dropped unfetched: the next replay waits for it
    assert isinstance(h["dev"], beam.Replayed)
    del h
    _assert_bits(_dev_out(table, qs[3:6]), want[1])
    assert (_replay_counts() - before).tolist() == [6, 0, 0]


@pytest.mark.gpu
def test_deep_walk_of_a_launch_an_iteration_stays_eager(cuda_device,
                                                        tmp_path,
                                                        monkeypatch):
    """A walk of a launch an iteration deeper than UNROLL_MAX_ITERS reads
    the device flag on the host: never captured. At UNROLL_MAX_ITERS it
    reads nothing back, and is."""
    table, _, qs = _replay_table(tmp_path)
    monkeypatch.setattr(beam, "_plan",
                        lambda *a: beam.WalkPlan("block", "iteration"))
    for iters, counts in ((beam.UNROLL_MAX_ITERS + 8, [0, 0, 3]),
                          (beam.UNROLL_MAX_ITERS, [2, 1, 1])):
        run = lambda: _dev_out(table, qs[:1], iters=iters)
        want = _eager(monkeypatch, run)
        before = _replay_counts()
        for _ in range(3):
            _assert_bits(run(), want)
        assert (_replay_counts() - before).tolist() == counts
