"""vectordb_tpu_torch.ops.gather against the row gathers of vectordb_tpu:
the Pallas kernel benchmarks/gather_micro.py:pallas_gather (interpret mode
on the CPU) and the `jnp.clip` + `jnp.take` that the JAX traversal does.

On the CPU the port's wrapper runs its plain version; the CUDA kernel is
held against that plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py). A gather copies bytes, so every comparison is bit for bit.
"""
import os

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
    assert gather.launches_by_row_bytes == {}


def test_reset_launches_clears_the_counts_by_row_width():
    gather.launches = 3
    gather.launches_by_row_bytes[256] = 3
    gather.reset_launches()
    assert gather.launches == 0 and gather.launches_by_row_bytes == {}


def test_gather_runs_the_plain_version_only_on_the_cpu():
    """A table neither on the CPU nor on a CUDA card raises: the plain
    version never stands in for the kernel."""
    tab = torch.zeros((10, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        gather.gather_rows(tab, torch.zeros(4, dtype=torch.int32,
                                            device="meta"))


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
    (344_064, 512, 353_697_792, 0.10558),  # f32 [262,144 x 128] re-rank
    (131_072, 4, 1_572_864, 0.000470),     # f32 [1M] scalars
    # f32 [30,523] query scatter: the sparse scorer's route before
    # ops/sparse.csr_ip, kept as its yardstick.
    (120_000_000, 4, 1_440_000_000, 0.42985),
    (262_144, 256, 135_266_304, 0.04038),  # bf16 [4M x 128] IVF candidates
])
def test_gather_cost_and_bound(n_ids, row_bytes, want_bytes, want_ms):
    """Bytes moved once each (ids, rows read, rows written) and the bound
    at the H100's 3.35 TB/s, at every row width the main path gathers."""
    from vectordb_tpu_torch.ops import partial_min
    nbytes = gather.gather_cost(n_ids, row_bytes)
    assert nbytes == want_bytes
    ms, by = partial_min.bound_ms(0, nbytes)
    assert by == "bytes"
    assert ms == pytest.approx(want_ms, rel=0.02)


def test_main_path_shapes_are_the_bound_cases():
    """chip_smoke.py times the gather at gather.MAIN_PATH_SHAPES; each has
    a row width the kernel takes."""
    widths = set()
    for name, dtype, shape, n_ids in gather.MAIN_PATH_SHAPES:
        rb = gather._row_bytes(torch.empty((1,) + shape[1:], dtype=dtype))
        assert rb % 4 == 0 and n_ids > 0, name
        widths.add(rb)
    assert widths == {256, 6144, 192, 512, 4, 128}


def test_operator_build_command(tmp_path):
    """The operator library is built by nvcc against the installed
    PyTorch: its C++ ABI, include paths as system headers, and after the
    sources its library paths (also as the run path) and libraries. Only
    the command is composed here; nothing is compiled."""
    from torch.utils import cpp_extension

    from vectordb_tpu_torch import _cuda_build

    out = str(tmp_path / "op.so")
    cmd = _cuda_build.build_command("gather_rows_op", out)
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    assert cmd[0].endswith("nvcc")
    assert f"-D_GLIBCXX_USE_CXX11_ABI={abi}" in cmd
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    for inc in cpp_extension.include_paths():
        assert inc in cmd and cmd[cmd.index(inc) - 1] == "-isystem"
    srcs = [cmd.index(os.path.join(_cuda_build.CSRC_DIR, s))
            for s in ("gather_rows.cu", "gather_rows_op.cpp")]
    assert cmd[cmd.index("-o") + 1] == out
    for lib in cpp_extension.library_paths():
        i = cmd.index(lib)
        assert cmd[i - 1] == "-L" and i > max(srcs)
        assert f"-rpath={lib}" in cmd
    for name in ("c10", "c10_cuda", "torch_cpu", "torch_cuda"):
        assert cmd.index(f"-l{name}") > max(srcs)
    # The ctypes library takes none of PyTorch's flags.
    plain = _cuda_build.build_command("partial_min", out)
    assert not any(f.startswith(("-D_GLIBCXX", "-l", "-L", "-isystem"))
                   for f in plain)


def test_operator_library_key_holds_the_torch_version(monkeypatch):
    from vectordb_tpu_torch import _cuda_build

    stem = _cuda_build.library_stem("gather_rows_op")
    assert os.path.basename(stem).startswith("gather_rows_op-")
    assert stem == _cuda_build.library_stem("gather_rows_op")
    plain = _cuda_build.library_stem("partial_min")
    monkeypatch.setattr(torch, "__version__", "0.0.0+other")
    assert _cuda_build.library_stem("gather_rows_op") != stem
    assert _cuda_build.library_stem("partial_min") == plain


def test_operator_that_does_not_load_raises_naming_the_log(monkeypatch,
                                                           tmp_path):
    """No fallback: a library that does not load raises, naming nvcc's
    log beside it."""
    from vectordb_tpu_torch import _cuda_build

    bad = tmp_path / "gather_rows_op-000000000000.so"
    bad.write_bytes(b"not a shared library")
    monkeypatch.setattr(_cuda_build, "library_path", lambda name: str(bad))
    monkeypatch.setattr(_cuda_build, "_registered", {})
    with pytest.raises(RuntimeError, match=r"gather_rows_op-0+\.log"):
        _cuda_build.load_operator("gather_rows_op")
    assert _cuda_build._registered == {}
