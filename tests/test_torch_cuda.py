"""The port on a CUDA device: the partial-min and row-gather kernels
against their plain versions, the flat-serve and graph slices through
the kernels, the query wires' device round trip against the host's and
the flat-serve kernel path under the int8 wire, device filter masks
against the host evaluator, a REST query over a CUDA store, and sparse
scoring, the IVF KNN and hybrid search on the card against their CPU runs.

These tests need the card and skip without one. They import neither jax
nor vectordb_tpu, so they also run where JAX is not installed:
    python -m pytest tests/test_torch_cuda.py --noconftest -q
Tolerance (kernel vs plain version): both add exact bf16 x bf16 products
in f32 in different orders — rtol 1e-5, atol 1e-5 * max(|q|^2 + |x|^2),
and ids equal except at such near-ties. The row gather copies bytes, so it
must equal its plain version bit for bit. Device filter masks must equal
the host evaluator's bit for bit (the adversarial table below is also used
by tests/test_torch_device_filter.py on the CPU).
"""
import json

import numpy as np
import pytest
import torch

import vectordb_tpu_torch as vdb
from vectordb_tpu_torch.config import global_config
from vectordb_tpu_torch.db_server import DBServer
from vectordb_tpu_torch.expr.evaluator import FilterCompiler
from vectordb_tpu_torch.expr.parser import parse_expr
from vectordb_tpu_torch.ops import flat, gather, partial_min, qwire
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
    """SparseColumnIndex on the card (the gather kernel on the query
    scatter, a segmented sum) against the same index on the CPU (plain
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
        got = gpu.device_scores(q, metric)
        assert got.is_cuda and got.shape == (len(col),)
        assert gather.launches == (1 if len(qi) else 0)
        torch.testing.assert_close(got.cpu(), cpu.device_scores(q, metric),
                                   rtol=1e-5, atol=1e-5)


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
        gather.reset_launches()
        res = [vdb.hybrid_query("t", q, ["ID"], 10, flt, True,
                                rerank=rerank)[1]
               for q in queries for rerank in ("rrf", "weighted")
               for flt in ("", "ID < 1500")]
        if device == "cuda":
            assert gather.launches > 0
        out[device] = res
    for g, c in zip(out["cuda"], out["cpu"]):
        assert [r["ID"] for r in g] == [r["ID"] for r in c]
        np.testing.assert_allclose([r["@distance"] for r in g],
                                   [r["@distance"] for r in c],
                                   rtol=1e-5, atol=1e-7)


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
